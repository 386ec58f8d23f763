"""Gradio web UI of the port (counterpart of ``tbist_tpu.ui.gradio_app``) —
widget parity with the reference Blocks app.

Reference: app.py:889-1248 — a main-effect checkbox group driving dynamic
visibility of per-effect panels (text prompts, pixel-art sliders, style
uploads, mixing weight + channel attention, palette pickers, depth mode),
plus an image/video input toggle and live palette / depth-split previews.

This module is import-safe without gradio installed (``build_demo`` raises
ImportError; the CLI covers every capability headlessly). All callbacks
route through ``tbist_tpu_torch.api`` on one torch device (the card by
default) — the UI holds no model state of its own, unlike the reference's
module-global models (app.py:50-78).
"""

from __future__ import annotations

from typing import List

import numpy as np

from tbist_tpu_torch import api
from tbist_tpu_torch.utils.config import (
    DepthConfig,
    EffectRequest,
    GatysConfig,
    PixelArtConfig,
    TextEffectConfig,
    VideoConfig,
)

MAIN_EFFECTS = [
    "Convert Output to Grayscale",
    "Text-Based Effects",
    "Pixel Art",
    "Style Transfer",
    "Style Mixing",
    "Color Palette Transfer",
    "Depth Based Style Transfer",
]
TEXT_EFFECTS = ["Text-Based Style Transfer", "Location Masking", "Style Masking"]
PIXEL_EFFECTS = ["Colour Palette", "Edges"]
DEPTH_EFFECTS = ["Modified loss Style Transfer", "Multi Plane Image Style Transfer"]


def _build_request(
    effects: List[str],
    text_effects: List[str],
    text_style: str,
    text_location: str,
    text_texture: str,
    edge_smoothing: float,
    emoji_blur: int,
    emoji_step: float,
    emoji_strength: float,
    pixel_effects: List[str],
    pixel_size: float,
    palette_idx: int,
    palette_interp: bool,
    edge_threshold: int,
    palette_from_image: bool,
    palette_n_colors: int,
    style_weight: float,
    channel_attention: bool,
    depth_mode: str,
    mip_n: int,
    interp_frames: int,
    slowmo: float,
) -> EffectRequest:
    text = None
    if MAIN_EFFECTS[1] in effects:
        text = TextEffectConfig(
            style_prompt=text_style if TEXT_EFFECTS[0] in text_effects else None,
            location_prompt=text_location if TEXT_EFFECTS[1] in text_effects else None,
            texture_prompt=text_texture if TEXT_EFFECTS[2] in text_effects else None,
            edge_smoothing=edge_smoothing,
            emoji_blur_strength=int(emoji_blur),
            emoji_step_size=emoji_step,
            emoji_style_strength=emoji_strength,
        )
    pixel = None
    if MAIN_EFFECTS[2] in effects:
        pixel = PixelArtConfig(
            pixel_size=pixel_size,
            use_palette=PIXEL_EFFECTS[0] in pixel_effects,
            palette_number=int(palette_idx),
            palette_from_image=palette_from_image,
            palette_num_colors=int(palette_n_colors),
            interpolate=palette_interp,
            edge_detect=PIXEL_EFFECTS[1] in pixel_effects,
            edge_threshold=int(edge_threshold),
        )
    depth = None
    if MAIN_EFFECTS[6] in effects:
        depth = DepthConfig(
            mode="depth_loss" if depth_mode == DEPTH_EFFECTS[0] else "mip",
            mip_layers=int(mip_n),
        )
    return EffectRequest(
        grayscale=MAIN_EFFECTS[0] in effects,
        text=text,
        pixel_art=pixel,
        style_transfer=MAIN_EFFECTS[3] in effects,
        style_mixing=MAIN_EFFECTS[4] in effects,
        color_palette=MAIN_EFFECTS[5] in effects,
        depth=depth,
        gatys=GatysConfig(
            style_img_weight=style_weight, channel_attention=channel_attention
        ),
        video=VideoConfig(interpolation_frames=int(interp_frames), slowmo=slowmo),
    )


def palette_list_display(size=(30, 300), interpolate: bool = False) -> List[np.ndarray]:
    """Render every bundled palette as a preview strip.

    Parity with ColourPalette.get_palette_list_display
    (components/pixel_art/colour_palette.py:111-128) as precomputed at app
    startup (reference app.py:70-71) in both plain and interpolated modes.
    """
    from tbist_tpu_torch.effects import pixel_art as pa
    from tbist_tpu_torch.ops import palette as palette_ops

    return [
        palette_ops.render_palette_strip(pa.get_palette(i), size, interpolate)
        for i in range(len(pa.load_palette_list()))
    ]


def palette_preview(
    palette_idx,
    interpolate: bool,
    from_image: bool,
    image,
    n_colors: int,
    size=(30, 300),
    device="cuda",
) -> np.ndarray:
    """Live palette preview, matching update_colour_palette_visibility
    (reference app.py:1113-1128): palette-from-image when enabled and an
    image is uploaded, else the selected bundled palette; blank when
    nothing is selected. The k-means centres start from
    ``palette.draw_init_idx`` (seed 0): the JAX package's distribution,
    not its numbers."""
    from tbist_tpu_torch.ops import palette as palette_ops

    if from_image and image is not None:
        from tbist_tpu_torch.utils.imageio import resolve_device, upload

        arr = np.asarray(image)
        arr = arr.astype(np.float32) / 255.0 if arr.dtype.kind in "ui" else arr
        flat_n, k = arr.shape[0] * arr.shape[1], max(1, int(n_colors))
        pal = palette_ops.palette_from_image(
            upload(arr, resolve_device(device)), k,
            init_idx=palette_ops.draw_init_idx(flat_n, k, seed=0),
        )
        return palette_ops.render_palette_strip(pal, size, interpolate)
    if palette_idx is None:
        return np.zeros((100, 100, 3), np.uint8)  # reference's blank 100x100
    from tbist_tpu_torch.effects import pixel_art as pa

    return palette_ops.render_palette_strip(
        pa.get_palette(int(palette_idx)), size, interpolate
    )


def build_demo(device="cuda"):
    """Construct the gradio Blocks app (requires gradio installed), whose
    callbacks run on ``device``."""
    try:
        import gradio as gr
    except ImportError as e:  # headless environments use the CLI
        raise ImportError(
            "gradio is not installed in this environment; use tbist_tpu_torch.cli"
        ) from e
    from tbist_tpu_torch.utils.imageio import resolve_device

    device = resolve_device(device)

    # all 70 palettes pre-rendered in both modes (reference app.py:70-71)
    palette_previews = palette_list_display()
    palette_previews_interp = palette_list_display(interpolate=True)

    with gr.Blocks(title="tbist_tpu style transfer") as demo:
        gr.Markdown("# Text-based image & video style transfer (GPU)")
        with gr.Row():
            with gr.Column():
                input_type = gr.Radio(["Image", "Video"], value="Image", label="Input type")
                image_in = gr.Image(type="filepath", label="Input image")
                video_in = gr.Video(label="Input video", visible=False)
                effects = gr.CheckboxGroup(MAIN_EFFECTS, label="Effects")

                with gr.Group(visible=False) as text_panel:
                    text_effects = gr.CheckboxGroup(TEXT_EFFECTS, label="Text effects")
                    text_style = gr.Textbox(label="Style prompt", placeholder="starry night")
                    text_location = gr.Textbox(label="Location prompt", placeholder="boat")
                    text_texture = gr.Textbox(label="Texture prompt", placeholder="fire")
                    # ranges/steps/defaults match reference app.py:920-927
                    edge_smoothing = gr.Slider(0, 20, 5, step=1, label="Edge smoothing")
                    emoji_blur = gr.Slider(0, 200, 95, step=5, label="Texture blur strength")
                    emoji_step = gr.Slider(0.1, 2.5, 0.5, step=0.1, label="Texture step size")
                    emoji_strength = gr.Slider(0, 10, 1.5, step=0.25, label="Texture style strength")

                with gr.Group(visible=False) as pixel_panel:
                    pixel_effects = gr.CheckboxGroup(PIXEL_EFFECTS, label="Pixel art options")
                    pixel_size = gr.Slider(0.01, 1.0, 0.4, step=0.02, label="Pixel size")
                    palette_idx = gr.Dropdown(
                        choices=list(range(len(palette_previews))), value=0,
                        label="Palette #",
                    )
                    palette_preview_img = gr.Image(label="Palette", interactive=False)
                    palette_interp = gr.Checkbox(label="Interpolate palette")
                    palette_from_image = gr.Checkbox(label="Palette from image")
                    pixel_palette_img = gr.Image(
                        label="Palette source image", visible=False
                    )
                    palette_n_colors = gr.Slider(
                        0, 20, 10, step=1, label="# palette colors", visible=False
                    )
                    edge_threshold = gr.Slider(0, 100, 50, step=1, label="Edge threshold")

                with gr.Group(visible=False) as style_panel:
                    style_img = gr.Image(type="filepath", label="Style image")

                with gr.Group(visible=False) as mixing_panel:
                    style_img1 = gr.Image(type="filepath", label="Style image 1")
                    style_img2 = gr.Image(type="filepath", label="Style image 2")
                    style_weight = gr.Slider(0.0, 1.0, 0.5, step=0.1, label="Style 2 weight")
                    channel_attention = gr.Checkbox(label="Channel attention")

                with gr.Group(visible=False) as palette_panel:
                    palette_img = gr.Image(type="filepath", label="Color palette image")

                with gr.Group(visible=False) as depth_panel:
                    # default = "Modified loss Style Transfer", matching
                    # reference app.py:110 (depth_style_transfer =
                    # list_of_depth_effects[0]) wired as the radio value
                    # at app.py:968
                    depth_mode = gr.Radio(DEPTH_EFFECTS, value=DEPTH_EFFECTS[0], label="Depth mode")
                    mip_n = gr.Slider(2, 10, 2, step=1, label="MIP layers")
                    depth_preview_btn = gr.Button("Preview depth layers")
                    depth_gallery = gr.Gallery(label="Depth split", columns=4)

                with gr.Group(visible=False) as video_panel:
                    interp_frames = gr.Slider(0, 5, 0, step=1, label="Interpolation frames")
                    # reference app.py:953: speed multiplier 0.1-2 default 1
                    slowmo = gr.Slider(0.1, 2.0, 1.0, step=0.1, label="Speed multiplier")

                run_btn = gr.Button("Apply", variant="primary")
            with gr.Column():
                image_out = gr.Image(label="Output")
                video_out = gr.Video(label="Output video", visible=False)

        # ---- visibility handlers (reference app.py:983-1248) ----
        def on_effects(selected):
            return (
                gr.update(visible=MAIN_EFFECTS[1] in selected),
                gr.update(visible=MAIN_EFFECTS[2] in selected),
                gr.update(visible=MAIN_EFFECTS[3] in selected or MAIN_EFFECTS[6] in selected),
                gr.update(visible=MAIN_EFFECTS[4] in selected),
                gr.update(visible=MAIN_EFFECTS[5] in selected),
                gr.update(visible=MAIN_EFFECTS[6] in selected),
            )

        effects.change(
            on_effects, effects,
            [text_panel, pixel_panel, style_panel, mixing_panel, palette_panel, depth_panel],
        )

        def on_input_type(t):
            is_video = t == "Video"
            return (
                gr.update(visible=not is_video),
                gr.update(visible=is_video),
                gr.update(visible=is_video),
                gr.update(visible=not is_video),
                gr.update(visible=is_video),
            )

        input_type.change(
            on_input_type, input_type,
            [image_in, video_in, video_panel, image_out, video_out],
        )

        # live palette preview (reference update_colour_palette_visibility,
        # app.py:1113-1128): bundled palette, interpolated variant, or a
        # palette extracted live from an uploaded image
        def on_palette_change(idx, interp, from_img, img, n_colors):
            if not from_img and img is None and idx is not None:
                # fast path: precomputed list display
                return (
                    palette_previews_interp[int(idx)]
                    if interp
                    else palette_previews[int(idx)]
                )
            return palette_preview(idx, interp, from_img, img, n_colors, device=device)

        _palette_inputs = [
            palette_idx, palette_interp, palette_from_image,
            pixel_palette_img, palette_n_colors,
        ]
        for widget in _palette_inputs:
            widget.change(on_palette_change, _palette_inputs, palette_preview_img)

        # palette-from-image override: show the source image + color-count
        # slider and lock the dropdown (reference app.py:1099-1110)
        def on_palette_from_image(enabled):
            return (
                gr.update(visible=enabled),
                gr.update(visible=enabled),
                gr.update(interactive=not enabled),
            )

        palette_from_image.change(
            on_palette_from_image, palette_from_image,
            [pixel_palette_img, palette_n_colors, palette_idx],
        )

        def on_depth_preview(image_path, n):
            # live depth-split preview (reference update_d_out,
            # app.py:1178-1188 -> DepthStyle.depth_split)
            if not image_path:
                return []
            from tbist_tpu_torch.effects import depth as depth_fx
            from tbist_tpu_torch.ops import mip as mip_ops
            from tbist_tpu_torch.utils.imageio import load_image, to_device, to_uint8

            x = to_device(load_image(image_path), device=device)
            estimator = depth_fx.default_depth_estimator(device)
            layers = mip_ops.generate_layers(x, estimator(x), int(n))
            return [to_uint8(l) for l in layers]

        depth_preview_btn.click(on_depth_preview, [image_in, mip_n], depth_gallery)

        # ---- run ----
        def run(input_type_v, image_path, video_path, *vals):
            (effects_v, text_effects_v, ts, tl, tt, es, eb, est, estr,
             pe, ps, pi, pint, et, pfi, pnc, sw, ca, dm, mn, itf, slo,
             style_p, s1, s2, pal_p, pixel_pal) = vals
            req = _build_request(
                effects_v, text_effects_v, ts, tl, tt, es, eb, est, estr,
                pe, ps, pi, pint, et, pfi, pnc, sw, ca, dm, mn, itf, slo,
            )
            if input_type_v == "Video":
                path = api.apply_video(
                    video_path, req, style_image=style_p,
                    style_image1=s1, style_image2=s2,
                    color_palette_image=pal_p, pixel_palette_image=pixel_pal,
                    device=device,
                )
                return None, path
            out = api.apply_image(
                image_path, req, style_image=style_p,
                style_image1=s1, style_image2=s2, color_palette_image=pal_p,
                pixel_palette_image=pixel_pal, device=device,
            )
            return (np.asarray(out) if out else None), None

        run_btn.click(
            run,
            [input_type, image_in, video_in,
             effects, text_effects, text_style, text_location, text_texture,
             edge_smoothing, emoji_blur, emoji_step, emoji_strength,
             pixel_effects, pixel_size, palette_idx, palette_interp,
             edge_threshold, palette_from_image, palette_n_colors,
             style_weight, channel_attention, depth_mode, mip_n,
             interp_frames, slowmo, style_img, style_img1, style_img2,
             palette_img, pixel_palette_img],
            [image_out, video_out],
        )
    return demo


def main():
    demo = build_demo()
    demo.launch(show_error=True)


if __name__ == "__main__":
    main()
