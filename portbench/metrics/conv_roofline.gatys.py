"""conv_roofline.gatys: percent, VGG-19's convolutions of the traced steps
(forward and input gradient, ``work/flops.vgg_convs``) at the card's f32
peak or bandwidth, each convolution bounded on its own, over the traced
time of cuDNN's kernels (its FFT products and layout transposes included)."""

from portbench import readers
from portbench.work import flops

NAMES = ("conv", "cudnn", "implicit", "fprop", "dgrad", "winograd", "fft", "float2", "cf32",
         "nchwToNhwc", "nhwcToNchw")
EXCLUDE = ("gram_", "pool_bwd_kernel", "sam_attn", "elementwise", "convert")


def read(ctx):
    side, p = ctx.params["side"], ctx.peaks
    g = ctx.config["gatys"]
    bound = 0.0
    for _, h, w, cin, cout in flops.vgg_convs(side, side, g["content_layers"] + g["style_layers"]):
        nbytes = flops.F32 * (h * w * cin + h * w * cout + cin * cout * 9)
        bound += 2 * flops.bound_s(nbytes, 2.0 * h * w * cin * cout * 9, p["float32"], p["bytes"])
    return readers.roofline(ctx, NAMES, bound, EXCLUDE)
