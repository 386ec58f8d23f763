"""VGG-19's trunk convolutions on a CUDA card: the input gradient that
``models.vgg19.TrunkConv`` makes by the flipped forward against cuDNN's own,
at the shapes of a 512px Gatys step, f32 with TF32 off. Without the JAX
package; skips where there is no card."""

import pytest
import torch
import torch.nn.functional as F

from tbist_tpu_torch.models import vgg19
from tbist_tpu_torch.utils.precision import full_f32


def _shapes(side=512):
    """(name, side, Cin, Cout) of the 13 convs to conv5_1."""
    out = []
    for spec in vgg19.VGG19_LAYERS:
        if len(spec) == 1:
            side //= 2
        elif len(out) < 13:
            out.append((spec[0], side, spec[1], spec[2]))
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, ref):
    return float(torch.linalg.norm((a.double() - ref).flatten()) / torch.linalg.norm(ref.flatten()))


@pytest.mark.gpu
@pytest.mark.parametrize("padding", [(1, 1), (1, 0)], ids=["same", "halo"])
@pytest.mark.parametrize("name,side,cin,cout", _shapes(), ids=[s[0] for s in _shapes()])
def test_flipped_input_gradient_matches_cudnn(cuda, name, side, cin, cout, padding):
    """``TrunkConv``'s input gradient against cuDNN's through autograd, and
    both against f64: elementwise within rtol 1e-5 (atol 1e-5 of the
    largest), and within 1e-5 relative L2 of f64."""
    g = torch.Generator(device=cuda).manual_seed(cin * cout)
    w = torch.randn(cout, cin, 3, 3, generator=g, device=cuda) * (2.0 / (9 * cin)) ** 0.5
    w = w.contiguous(memory_format=torch.channels_last)
    b = torch.randn(cout, generator=g, device=cuda)
    x = torch.randn(1, side, side, cin, generator=g, device=cuda).permute(0, 3, 1, 2)
    with full_f32():
        xb = x.clone(memory_format=torch.channels_last).requires_grad_(True)
        yb = F.conv2d(xb, w, b, padding=padding)
        gy = torch.randn(yb.shape, generator=g, device=cuda).contiguous(
            memory_format=torch.channels_last)
        yb.backward(gy)
        x64 = x.double().requires_grad_(True)
        F.conv2d(x64, w.double(), b.double(), padding=padding).backward(gy.double())
        xa = x.clone(memory_format=torch.channels_last).requires_grad_(True)
        ya = vgg19.TrunkConv.apply(xa, w, b, padding)
        assert torch.equal(ya, yb)
        ya.backward(gy)
    torch.testing.assert_close(xa.grad, xb.grad, rtol=1e-5, atol=1e-5 * xb.grad.abs().max())
    assert _rel(xa.grad, x64.grad) < 1e-5
    assert _rel(xb.grad, x64.grad) < 1e-5
