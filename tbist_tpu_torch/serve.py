"""HTTP serving layer of the port (counterpart of ``tbist_tpu.serve``):
a stdlib-only JSON API over the effect pipeline on one torch device (on a
host with two or more cards, a request shards over all of them where the
JAX package shards: ``parallel.mesh``).

  GET  /healthz            -> {"status": "ok", "backend": "cuda" | "cpu",
                              "devices": N, "batching": {counters}} (when
                              batching is on), "warmup_s": {key: s} (with
                              --warmup-size), "mesh": the cards a request
                              shards over (on two or more cards)
  POST /v1/image           -> body {"image": b64, "request": {...},
                              "style_image": b64?, "style_image1": b64?,
                              "style_image2": b64?, "color_palette_image": b64?,
                              "pixel_palette_image": b64?}
                              reply {"image": b64 PNG, "timings_s": {...},
                              "degraded": [...]}
  POST /v1/video           -> body {"video": b64 mp4, "request": {...},
                              the same optional images, "max_frames": int?}
                              reply {"video": b64 mp4, "timings_s": {...},
                              "degraded": [...]}

Replies carry a ``degraded`` list naming any component that resolved to a
fallback (seeded VGG, the border-prior mask, ...), so callers know when an
output did not come from pretrained weights.

Every device call, in a request thread or in the micro-batcher's worker,
runs under one lock: one request's work on the card at a time, on the
default stream that all threads share (grad mode is per thread, so a Gatys
request beside the batcher's no-grad calls keeps its own). Concurrent
fast-text-only requests coalesce into one batched call (split over the
cards' dp mesh where there are several) when
``--batch-max`` > 0 (default 8; ``tbist_tpu_torch.api.batching``). A video
request holds the lock for its whole duration and buffers its mp4 in
memory, so bodies over ``--max-body-mb`` (default 64) are refused with 413
before they are read.

Run: ``python -m tbist_tpu_torch.serve --port 8000`` (on the card;
``--device cpu`` runs the kernels' plain PyTorch versions on the CPU).
"""

from __future__ import annotations

import base64
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from tbist_tpu_torch.parallel import mesh as mesh_lib
from tbist_tpu_torch.utils.logging import RunMetrics, logger


def _decode_image(b64: Optional[str]):
    if not b64:
        return None
    from PIL import Image

    return Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB")


def _encode_image(pil) -> str:
    buf = io.BytesIO()
    pil.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode("ascii")


class _Handler(BaseHTTPRequestHandler):
    server_version = "tbist_tpu_torch"
    _lock = threading.Lock()

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # route through our logger
        logger.info("serve: " + fmt, *args)

    def do_GET(self):
        if self.path == "/healthz":
            import torch

            device = self.server.device
            reply = {
                "status": "ok",
                "backend": device.type,
                "devices": torch.cuda.device_count() if device.type == "cuda" else 1,
            }
            mesh = mesh_lib.production_mesh(device)
            if mesh is not None:
                reply["mesh"] = mesh.size
            batcher = getattr(self.server, "batcher", None)
            if batcher is not None:
                reply["batching"] = {
                    "max_batch": batcher.max_batch,
                    "batches_run": batcher.batches_run,
                    "requests_served": batcher.requests_served,
                }
            warm = getattr(self.server, "warmup", None)
            if warm is not None:
                reply["warmup_s"] = warm
            self._reply(200, reply)
        else:
            self._reply(404, {"error": "unknown path"})

    def do_POST(self):
        if self.path == "/v1/image":
            handler = self._handle_image
        elif self.path == "/v1/video":
            handler = self._handle_video
        else:
            self._reply(404, {"error": "unknown path"})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            limit = getattr(self.server, "max_body_bytes", 0)
            if limit and length > limit:
                # refuse before buffering: a long video would otherwise sit
                # decoded in memory while holding the one device lock
                self.close_connection = True
                self._reply(
                    413,
                    {
                        "error": f"request body {length} bytes exceeds "
                        f"limit {limit} (server --max-body-mb)"
                    },
                )
                return
            data = json.loads(self.rfile.read(length) or b"{}")
            handler(data)
        except ValueError as e:
            self._reply(400, {"error": str(e)})
        except Exception as e:  # surface as 500 with the message
            logger.exception("serve: request failed")
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    @staticmethod
    def _side_inputs(data: dict) -> dict:
        return {
            k: _decode_image(data.get(k))
            for k in (
                "style_image", "style_image1", "style_image2",
                "color_palette_image", "pixel_palette_image",
            )
        }

    def _handle_image(self, data: dict) -> None:
        from tbist_tpu_torch import api
        from tbist_tpu_torch.api import batching
        from tbist_tpu_torch.utils.request_schema import request_from_dict

        req = request_from_dict(data.get("request", {}))
        batcher = getattr(self.server, "batcher", None)
        if batcher is not None and data.get("image") and batching.eligible(req):
            self._handle_image_batched(batcher, data, req)
            return
        metrics = RunMetrics()
        with self._lock:  # one request's device work at a time
            out = api.apply_image(
                _decode_image(data.get("image")), req,
                metrics=metrics, device=self.server.device, **self._side_inputs(data),
            )
        if out is None:
            self._reply(422, {"error": "missing required inputs for request"})
            return
        self._reply(
            200,
            {
                "image": _encode_image(out),
                "timings_s": metrics.timings_s,
                "degraded": metrics.degraded,
            },
        )

    def _handle_image_batched(self, batcher, data: dict, req) -> None:
        """Fast-text-only requests coalesce across concurrent clients into
        one batched call (api/batching.py), which takes the handler lock."""
        import time

        import numpy as np

        from tbist_tpu_torch.utils import degraded
        from tbist_tpu_torch.utils.imageio import to_pil

        pil = _decode_image(data.get("image"))
        t0 = time.perf_counter()
        # uint8 both ways: 4x fewer bytes than f32 over the host link (the
        # batcher casts on the device and quantizes the result there)
        item = batcher.submit_item(np.asarray(pil, np.uint8), req.text.style_prompt)
        dt = time.perf_counter() - t0
        self._reply(
            200,
            {
                "image": _encode_image(to_pil(item.result)),
                "timings_s": {"text_transfer": dt},
                "degraded": degraded.flags_for(["text_transfer"]),
                "batch": item.batch_n,
            },
        )

    def _handle_video(self, data: dict) -> None:
        """Video over HTTP: the mp4 goes through ``api.apply_video``, which
        starts its decode-ahead and read-back threads inside the lock."""
        import os
        import tempfile

        from tbist_tpu_torch import api
        from tbist_tpu_torch.utils.request_schema import request_from_dict

        b64 = data.get("video")
        if not b64:
            self._reply(422, {"error": "missing 'video' (base64 mp4)"})
            return
        req = request_from_dict(data.get("request", {}))
        metrics = RunMetrics()
        max_frames = data.get("max_frames")
        with tempfile.TemporaryDirectory() as tmp:
            in_path = os.path.join(tmp, "in.mp4")
            out_path = os.path.join(tmp, "out.mp4")
            with open(in_path, "wb") as f:
                f.write(base64.b64decode(b64))
            with self._lock:
                result = api.apply_video(
                    in_path, req, out_path=out_path,
                    max_frames=int(max_frames) if max_frames else None,
                    metrics=metrics, device=self.server.device, **self._side_inputs(data),
                )
            if result is None:
                self._reply(422, {"error": "missing required inputs for request"})
                return
            with open(result, "rb") as f:
                video_b64 = base64.b64encode(f.read()).decode("ascii")
        self._reply(
            200,
            {
                "video": video_b64,
                "timings_s": metrics.timings_s,
                "degraded": metrics.degraded,
            },
        )


def warmup_fast_text(sizes=(512,), batch_sizes=(), device="cuda") -> dict:
    """Run the fast-text requests once before accepting traffic.

    Nothing is compiled per shape in the port, but a process's first call
    still pays once: CUDA's lazy loading of the modules it touches, cuBLAS
    and cuDNN handle creation and cuDNN's algorithm choice for each
    convolution shape, and the seeded draws of the Ghiasi and CLIP-MLP
    weights and the CLIP text encoder's resolution (``ModelRegistry`` and
    the lru-cached loaders keep them for later requests).

    Per size this runs (a) for each n in ``batch_sizes`` the micro-batcher's
    dispatch (``api.batching.dispatch_fast_text_batch`` on n uint8 host
    rows, quantized on the device), keyed ``"{size}px_b{n}"``, and (b) the
    non-batched pipeline call, f32 upload → ``perform_transfer`` → uint8
    quantize, keyed ``"{size}px"``. Returns the seconds per key for the
    healthz report.
    """
    import time

    import numpy as np
    import torch

    from tbist_tpu_torch.api.batching import dispatch_fast_text_batch
    from tbist_tpu_torch.effects import text_transfer as tt
    from tbist_tpu_torch.utils.imageio import resolve_device, to_uint8_device

    device = resolve_device(device)
    timings = {}
    for size in sizes:
        for bsz in batch_sizes:
            t0 = time.perf_counter()
            rows = [np.zeros((size, size, 3), np.uint8)] * bsz
            dispatch_fast_text_batch(rows, ["warmup"] * bsz, quantize_uint8=True,
                                     device=device).cpu()
            timings[f"{size}px_b{bsz}"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        x = torch.zeros((1, size, size, 3), dtype=torch.float32, device=device)
        to_uint8_device(tt.perform_transfer(x, "warmup")).cpu()
        timings[f"{size}px"] = round(time.perf_counter() - t0, 3)
    logger.info("serve: fast-text warmup %s", timings)
    return timings


def warmup_heavy(
    size: int = 512,
    programs=("gatys",),
    gatys_steps: Optional[int] = None,
    device="cuda",
) -> dict:
    """Run the heavy requests once through the public ``api.apply_image``,
    exactly as a first request would, before accepting traffic.

    What a first request pays in the port: the ``nvcc`` builds of the
    kernels it launches, or their load from ``build/tbist_kernels/``
    (``kernels/_build.py``); the model loads and seeded draws (VGG-19, and
    for ``mask`` GroundingDINO and SAM, for ``depth`` Depth Anything);
    cuBLAS and cuDNN handle creation and cuDNN's algorithm choice; CUDA's
    lazy loading of every module it touches.

    ``programs`` selects from:
      * ``gatys``  — Gatys style transfer (the main path).
      * ``mask``   — the text location mask (DINO+SAM, or the fallback
        where their files are absent) + the text style + the composite.
      * ``depth``  — the depth-loss style transfer (the estimator inside
        the Gatys loss).

    ``gatys_steps`` sets how many steps the ``gatys`` and ``depth`` runs
    take (default the ``GatysConfig`` default). Nothing is compiled per step
    count: the first step pays what there is to pay, so a short run warms
    as well as a long one.

    Returns the seconds per key for the healthz report.
    """
    import time

    import numpy as np
    from PIL import Image

    from tbist_tpu_torch import api
    from tbist_tpu_torch.utils.config import (
        DepthConfig, EffectRequest, GatysConfig, TextEffectConfig,
    )

    gcfg = GatysConfig(num_steps=gatys_steps if gatys_steps else GatysConfig().num_steps)
    dummy = Image.fromarray(np.zeros((size, size, 3), np.uint8))
    reqs = {
        "gatys": lambda: api.apply_image(
            dummy, EffectRequest(style_transfer=True, gatys=gcfg),
            style_image=dummy, device=device,
        ),
        "mask": lambda: api.apply_image(
            dummy,
            EffectRequest(
                text=TextEffectConfig(style_prompt="warmup", location_prompt="warmup")
            ),
            device=device,
        ),
        "depth": lambda: api.apply_image(
            dummy, EffectRequest(depth=DepthConfig(), gatys=gcfg),
            style_image=dummy, device=device,
        ),
    }
    timings = {}
    for name in programs:
        if name not in reqs:
            raise ValueError(
                f"unknown warmup program {name!r} (choose from {sorted(reqs)})"
            )
        t0 = time.perf_counter()
        reqs[name]()
        timings[f"{name}_{size}px"] = round(time.perf_counter() - t0, 3)
    logger.info("serve: heavy warmup %s", timings)
    return timings


def make_server(
    port: int = 8000,
    host: str = "127.0.0.1",
    batch_max: int = 0,
    batch_window_ms: float = 4.0,
    warmup_size: int = 0,
    warmup_programs=(),
    warmup_gatys_steps: int = 0,
    max_body_mb: float = 64.0,
    device="cuda",
) -> ThreadingHTTPServer:
    """A server whose requests run on ``device`` (the card by default; a
    missing card raises, only an explicit ``"cpu"`` runs on the CPU).

    ``batch_max > 0`` enables cross-request micro-batching of fast-text
    requests (api/batching.py); 0 keeps every request on the pipeline path.
    ``warmup_size > 0`` runs the fast-text requests at that resolution (the
    pipeline call and, with batching on, the batcher's dispatch at every
    arrival size 1..max_batch) before the server is returned;
    ``warmup_programs`` adds the heavy requests ('gatys', 'mask', 'depth' —
    see warmup_heavy) at the same size. ``max_body_mb`` caps the request
    body (413 over it, refused before buffering): requests run one at a time
    under one device lock, so an unbounded video body would both exhaust
    host memory and block every other request for its full duration. 0
    disables the cap."""
    from tbist_tpu_torch.utils.imageio import resolve_device

    device = resolve_device(device)

    class _Server(ThreadingHTTPServer):
        def server_close(self):  # stop the batcher worker with the server
            b = getattr(self, "batcher", None)
            if b is not None:
                b.close()
            super().server_close()

    server = _Server((host, port), _Handler)
    server.device = device
    server.max_body_bytes = int(max_body_mb * 1024 * 1024)
    server.batcher = None
    if batch_max > 0:
        from tbist_tpu_torch.api.batching import FastTextBatcher

        server.batcher = FastTextBatcher(
            max_batch=batch_max,
            window_ms=batch_window_ms,
            device_lock=_Handler._lock,
            quantize_uint8=True,  # serve re-encodes to PNG; read back uint8
            device=device,
        )
    server.warmup = None
    if warmup_size > 0:
        # every arrival size, as the batcher dispatches each n as it comes
        batches = () if batch_max <= 0 else tuple(range(1, batch_max + 1))
        server.warmup = warmup_fast_text(
            sizes=(warmup_size,), batch_sizes=batches, device=device
        )
    if warmup_size > 0 and warmup_programs:
        server.warmup.update(
            warmup_heavy(
                warmup_size, tuple(warmup_programs),
                gatys_steps=warmup_gatys_steps or None, device=device,
            )
        )
    return server


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; 'cpu' runs "
                    "the plain PyTorch versions of the kernels)")
    ap.add_argument(
        "--batch-max", type=int, default=8,
        help="coalesce up to N concurrent fast-text requests into one "
        "batched call (0 disables batching)",
    )
    ap.add_argument("--batch-window-ms", type=float, default=4.0)
    ap.add_argument(
        "--warmup-size", type=int, default=0,
        help="run the fast-text requests at NxN before serving, so that "
        "the first client does not pay the process's first-call costs "
        "(0 disables; typical: 512)",
    )
    ap.add_argument(
        "--warmup-programs", default="",
        help="comma list of heavy requests to run as well at "
        "--warmup-size: gatys,mask,depth (e.g. --warmup-programs "
        "gatys,mask; needs --warmup-size > 0)",
    )
    ap.add_argument(
        "--warmup-gatys-steps", type=int, default=0,
        help="steps of the gatys/depth warmup runs (nothing is compiled "
        "per step count, so a short run warms as well as a long one; "
        "0 = the GatysConfig default)",
    )
    ap.add_argument(
        "--max-body-mb", type=float, default=64.0,
        help="reject request bodies over this size with 413 before "
        "buffering (0 disables; requests run under one device lock, so "
        "an unbounded video blocks everything for its full duration)",
    )
    args = ap.parse_args(argv)
    server = make_server(
        args.port, args.host,
        batch_max=args.batch_max, batch_window_ms=args.batch_window_ms,
        warmup_size=args.warmup_size,
        warmup_programs=tuple(
            p.strip() for p in args.warmup_programs.split(",") if p.strip()
        ),
        warmup_gatys_steps=args.warmup_gatys_steps,
        max_body_mb=args.max_body_mb,
        device=args.device,
    )
    logger.info(
        "serving on %s:%d, device %s (fast-text batching %s)",
        args.host, server.server_address[1], server.device,
        f"max={args.batch_max}" if args.batch_max else "off",
    )
    server.serve_forever()


if __name__ == "__main__":
    main()
