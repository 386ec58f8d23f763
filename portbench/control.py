"""The readings that the limits of ``check.py`` (Gatys cells) are set from, on the card
at the cell's own size; the benchmark's runs do not run this.

    python3 portbench/control.py --workload <cell> --program-seeds 1,2,... --control-seeds 7,8,9

- Program: for each program seed, one run of the cell (``run.execute``)
  with a window of one request; its check numbers are the lower readings.
- Control: for each control seed, the plain reference put in the
  program's place one precision below the configuration's (TF32 on in
  cuBLAS and cuDNN, where the configuration states f32 with TF32 off): a
  free run of the request's steps from the same inputs, its first
  gradient and update, last iterate and last update taken as the
  program's are, and the same numbers. They are the upper readings. The same free run in f32
  with TF32 off, put there the same way, reads the check's own floor.
- Witness: for each control seed, the f32 reference's own free run, and
  how far the control's and the port's loss histories and images lie from
  it, by step: what a free-running comparison would read. With
  ``--f64-witness``, each program seed's last iterate also in f64.

It prints one JSON line a reading and a last line with the largest program
reading and the smallest control reading of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run  # noqa: E402


def _hist_gaps(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rel = np.abs(a / b - 1)
    return {f"hist_rel_max_{n}": float(rel[:n].max()) for n in (2, 3, 10, 50, len(rel))}


def _levels(a, b):
    import numpy as np

    d = np.abs(np.asarray(a, np.int32) - np.asarray(b, np.int32))
    return {"image_levels_max": int(d.max()), "image_levels_mean": float(d.mean())}


def control_reading(cell: str, seed: int, device: str = "cuda", overrides=None):
    """The control's numbers for ``seed`` and the witness readings."""
    import torch

    from portbench import check, weights
    from portbench.reference import gatys as ref
    from portbench.requests import gatys as kind

    work = run.load("workloads", cell)
    config = run.load("configs", work["config"])
    params = dict(work["params"])
    if overrides:
        config = {**config, **overrides.get("config", {})}
        params.update(overrides.get("params", {}))
    dev = torch.device(device)
    seed_vgg, seed_da, seed_traffic = run.sub_seeds(seed)
    vgg = weights.vgg19(seed_vgg, dev)
    da = config.get("depth_anything")
    da_params = weights.depth_anything(da, seed_da, dev) if da else None
    images = kind.load_images(params, run.ROOT)
    pair = kind.draw_pairs(params, seed_traffic)[0]
    c, s = (kind.to_tensor(images[n], dev) for n in pair)
    cfg = dict(config["gatys"], w_depth=(config["request"].get("depth") or {}).get("w_depth", 0))
    steps, m = params["steps"], config["gatys"]["lbfgs_memory"]
    out = {"seed": seed, "pair": pair}
    runs = {}
    for name, tf32 in (("control_tf32", True), ("reference_f32", False)):
        with ref.precision(tf32=tf32):
            t0 = time.perf_counter()
            obj = ref.objective(cfg, vgg, c, s, da_params, da)
            runs[name] = ref.stylize(obj, c, steps, m, config["gatys"]["learning_rate"],
                                     params["check_steps"])
            out[f"{name}_s"] = time.perf_counter() - t0
    f32 = runs["reference_f32"]
    with ref.precision(tf32=False):
        obj = ref.objective(cfg, vgg, c, s, da_params, da)
        for key, cap in (("control", runs["control_tf32"]), ("reference", f32)):
            out[key] = check.request_numbers(obj, c, cap, cap["output_u8"][0].cpu().numpy(),
                                             config["gatys"]["learning_rate"], m)
    cap = runs["control_tf32"]
    out["witness_control_vs_reference"] = {**_hist_gaps(cap["hist"], f32["hist"]),
                                           **_levels(cap["output_u8"].cpu(),
                                                     f32["output_u8"].cpu())}
    return out, f32


def f64_witness(cell: str, seed: int, record, device: str = "cuda", overrides=None) -> dict:
    """At the program's last iterate of ``record``: the loss and gradient
    in f64 against the program's and against the f32 reference's, which
    says how far f32 itself is from its own last step."""
    import torch

    from portbench import check, weights
    from portbench.reference import gatys as ref
    from portbench.requests import gatys as kind

    work = run.load("workloads", cell)
    config = {**run.load("configs", work["config"]), **(overrides or {}).get("config", {})}
    params = dict(work["params"], **(overrides or {}).get("params", {}))
    dev = torch.device(device)
    seed_vgg, seed_da, _ = run.sub_seeds(seed)
    da = config.get("depth_anything")
    cfg = dict(config["gatys"], w_depth=(config["request"].get("depth") or {}).get("w_depth", 0))
    cap = record["captures"]
    loaded = kind.load_images(params, run.ROOT)
    images = [kind.to_tensor(loaded[n], dev) for n in record["item"]]
    out = {}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        vgg = {k: {n: v.to(dt) for n, v in p.items()}
               for k, p in weights.vgg19(seed_vgg, dev).items()}
        dap = _tree_to(weights.depth_anything(da, seed_da, dev), dt) if da else None
        with ref.precision(tf32=False):
            obj = ref.objective(cfg, vgg, *(x.to(dt) for x in images), dap, da)
            out[name] = ref.loss_grad(obj, cap["x_last"].to(dev, dt))
    (l64, g64), (l32, g32) = out["f64"], out["f32"]
    port_g = cap["grad_last"].to(dev, torch.float64).reshape(g64.shape)
    return {"port_grad_vs_f64": check._rel_l2(port_g, g64),
            "f32_grad_vs_f64": check._rel_l2(g32.double(), g64),
            "port_loss_vs_f64": check._rel(record["timings"]["hist"][-1], float(l64)),
            "f32_loss_vs_f64": check._rel(float(l32), float(l64))}


def _tree_to(tree, dt):
    import torch

    if isinstance(tree, dict):
        return {k: _tree_to(v, dt) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dt) for v in tree]
    return tree.to(dt) if isinstance(tree, torch.Tensor) else tree


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--program-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--f64-witness", action="store_true")
    a = p.parse_args()
    lower, upper = {}, {}
    for seed in [int(x) for x in a.program_seeds.split(",") if x]:
        t0 = time.perf_counter()
        kept = {}
        rc, out, lines = run.execute(["--workload", a.workload, "--seed", str(seed),
                                      "--seconds", "0.001"], keep=kept)
        row = {"program_seed": seed, "rc": rc, "s": time.perf_counter() - t0,
               "correct": out and out["correct"], "numbers": kept.get("numbers"),
               "metrics": out and out["metrics"]}
        if a.f64_witness:
            row["f64"] = [f64_witness(a.workload, seed, r) for r in kept["records"]]
        print(json.dumps(row), flush=True)
        for k, v in (row["numbers"] or {}).items():
            lower[k] = max(lower.get(k, 0.0), v)
    for seed in [int(x) for x in a.control_seeds.split(",") if x]:
        out, f32 = control_reading(a.workload, seed)
        # the port on the same inputs, against the f32 reference's free run
        kept = {}
        run.execute(["--workload", a.workload, "--seed", str(seed), "--seconds", "0.001"],
                    keep=kept)
        r = kept["records"][0]
        out["witness_port_vs_reference"] = {**_hist_gaps(r["timings"]["hist"], f32["hist"]),
                                            **_levels(r["out"], f32["output_u8"][0].cpu())}
        print(json.dumps(out), flush=True)
        for k, v in out["control"].items():
            upper[k] = min(upper.get(k, float("inf")), v)
    print(json.dumps({"workload": a.workload, "lower": lower, "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
