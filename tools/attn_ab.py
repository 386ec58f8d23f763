"""Where K4's time goes: ``csrc/sam_attn.cu`` against copies of it with one
part removed, timed in turns in one process on one card.

- ``one_pass``: only the big·big MMA of each 3xTF32 product (a third of
  the MMAs; the operand splits stay), so the time it saves is the share of
  the tensor-core MMAs;
- ``no_split``: the operands go to the MMAs unsplit (all three MMAs stay),
  so the time it saves is the share of the splitting instructions.

Both variants give wrong results (their errors are printed beside them);
they exist only to apportion the kernel's time. A development script,
outside the package and untested: the variants are string edits of the
source, so it refuses to run once ``sam_attn.cu`` no longer has the lines
it removes. Run on a machine with a CUDA card, from the root of a
checkout::

    python tools/attn_ab.py

It prints one JSON line: per K4 shape of ``chip_smoke.py``, the ms and max
abs error of each variant in the order tree, one_pass, no_split, tree.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

import chip_smoke  # noqa: E402
from tbist_tpu_torch.kernels import _build, sam_attn  # noqa: E402

_OUT = os.path.join(_ROOT, "build", "attn_ab")
_MMA_SMALL = "  mma_tf32(cs, as, bb0, bb1);\n  mma_tf32(cs, ab, bs0, bs1);\n"
_SPLIT = ("  big = __float_as_uint(x) + 0x1000u;\n"
          "  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u)) + 0x1000u;")


def _variants() -> dict:
    with open(os.path.join(_build.CSRC_DIR, "sam_attn.cu")) as f:
        src = f.read()
    if _MMA_SMALL not in src or _SPLIT not in src:
        raise RuntimeError("attn_ab: sam_attn.cu no longer has the lines the variants remove")
    return {"tree": src, "one_pass": src.replace(_MMA_SMALL, ""),
            "no_split": src.replace(_SPLIT, "  big = small = __float_as_uint(x);")}


def _build_all(variants: dict) -> dict:
    """One nvcc per variant, all at once; returns the loaded libraries."""
    os.makedirs(_OUT, exist_ok=True)
    procs = {}
    for name, text in variants.items():
        cu = os.path.join(_OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", os.path.join(_OUT, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name} failed:\n{out}")
        lib = ctypes.CDLL(os.path.join(_OUT, f"{name}.so"))
        lib.tbist_sam_attn.argtypes = sam_attn._lib().tbist_sam_attn.argtypes
        lib.tbist_sam_attn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("attn_ab: needs a CUDA device")
    libs = _build_all(_variants())
    tree_lib = sam_attn._lib
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(1)
    result = {}
    try:
        for n, h, w, d in chip_smoke.SAM_ATTN_SHAPES:
            t = h * w
            q = torch.randn((n, t, d), generator=gen, device=device) * d ** -0.5
            k, v = (torch.randn((n, t, d), generator=gen, device=device) for _ in range(2))
            args = (q, k, v, torch.randn((n, t, h), generator=gen, device=device),
                    torch.randn((n, t, w), generator=gen, device=device))
            want = sam_attn.attention_with_rel_bias_plain(*args, h, w)
            fn = lambda *a: sam_attn.attention_with_rel_bias(*a, h, w)  # noqa: E731
            rows = []
            for name in ("tree", "one_pass", "no_split", "tree"):
                sam_attn._lib = lambda name=name: libs[name]
                err = float((fn(*args) - want).abs().max())
                rows.append([name, chip_smoke.time_ms(fn, args, chip_smoke.SAM_ITERS), err])
            result[f"N {n}, T {t}, d {d}"] = rows
            del q, k, v, args, want
    finally:
        sam_attn._lib = tree_lib
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"attn_ab": result, "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}))


if __name__ == "__main__":
    main()
