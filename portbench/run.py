"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run is a fresh process: set-up (imports, the card, the kernels that
``nvcc`` built under ``build/``, the seeded weights on the device, the
inputs, a warm-up of the cell's shapes), then a window of whole requests
through ``tbist_tpu_torch.api.apply_image`` (``generators/``), then the
check of the window's requests against the plain reference. The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``),
and last ``checks``, each compared number with its limit, which also end
standard error.

Everything is found by name: the cell in ``workloads/<cell>.json``, its
configuration in ``configs/<config>.json``, its kind of request in
``requests/<request>.py`` (the seeded models, the inputs and their order,
the warm-up, the reading points in the port, the traced slice and the
check), its traffic generator in ``generators/<generator>.py``, and each
metric that ``BENCHMARK.json`` gives the cell in ``metrics/<metric>.py``.
``--trace 0`` reports the end-to-end metrics, ``--trace 1`` the per-layer
ones, read from a profiled slice of the window (whole steps of its first
request for a Gatys cell, whole requests for a location cell). What is
here is the same for every kind: the environment, the card, the window,
the metrics, the device, the forbidden modules and the result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "tbist_tpu")  # top-level module names


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load(kind: str, name: str) -> Dict:
    """``portbench/<kind>/<name>.json``."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def module(kind: str, name: str) -> types.ModuleType:
    """``portbench/<kind>/<name>.py``, loaded by path (names may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(cell: str, trace: bool) -> List[Dict]:
    """The metrics ``BENCHMARK.json`` gives ``cell``: the end-to-end ones,
    or with ``trace`` the per-layer ones."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_environment(chips: int) -> None:
    """Caches at fixed paths inside the checkout, the cell's cards only, and
    no JAX pulled in by a library. Before torch is imported."""
    build = os.path.join(ROOT, "build", "portbench")
    for key, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[key] = os.path.join(build, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ["TBIST_SEED_CACHE"] = "0"
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    if visible:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(visible.split(",")[:chips])
    else:
        os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(str(i) for i in range(chips))


def sub_seeds(seed: int) -> List[int]:
    """Three seeds drawn from the run's: the request kind's two weight
    draws (VGG-19 and Depth Anything; GroundingDINO and SAM) and the
    traffic's."""
    import numpy as np

    return [int(s) for s in np.random.SeedSequence(seed % 2 ** 64).generate_state(3, np.uint64)]


def request_kind(work: Dict) -> types.ModuleType:
    """``requests/<kind>.py`` for the workload's ``"request"``; a kind with
    no file stops the run."""
    kind = work["request"]
    if not os.path.exists(os.path.join(HERE, "requests", f"{kind}.py")):
        raise LookupError(f"no request kind {kind!r} (portbench/requests/{kind}.py)")
    return importlib.import_module(f"portbench.requests.{kind}")


def execute(argv: Optional[List[str]] = None, device: Optional[str] = None,
            overrides: Optional[Dict] = None,
            keep: Optional[Dict] = None) -> Tuple[int, Optional[Dict], List[str]]:
    """One run: (exit code, the result line's object or None, the lines
    for standard error). ``device`` and ``overrides`` (``{"config": {...},
    "params": {...}}`` merged into the files') are for the CPU tests and
    the control scripts, which drive a run without a card or several runs
    in one process; ``keep`` receives the window's requests (``records``)
    and every number the check worked out (``numbers``)."""
    args = parse_args(argv)
    work = load("workloads", args.workload)
    config = load("configs", work["config"])
    params = dict(work["params"])
    if overrides:
        config = {**config, **overrides.get("config", {})}
        params.update(overrides.get("params", {}))
    chips = work["chips"]
    on_card = device is None
    if on_card:
        set_environment(chips)
    import torch

    if on_card:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA card(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
                  file=sys.stderr)
            return 2, None, []
        device = "cuda"
    cards = chips if on_card else 1
    try:
        kind = request_kind(work)
    except LookupError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 5, None, []

    from portbench import check, tracing
    from portbench.work import peaks as peaks_lib

    dev = torch.device(device)
    seeds = sub_seeds(args.seed)

    def sync():
        if on_card:
            for d in range(cards):
                torch.cuda.synchronize(d)

    trace = bool(args.trace)
    sliced = tracing.Slice(cards) if trace else None
    if trace and on_card:
        tracing.Slice.warm()
    session = kind.Session(config, params, seeds[:2], dev, sliced.toggle if trace else None,
                           trace)
    generator = module("generators", work["generator"])
    with session.installed():
        if on_card:
            for d in range(cards):
                torch.cuda.reset_peak_memory_stats(d)
        result = generator.run(params, seeds[2], args.seconds, ROOT, session, sync, trace)
    sync()
    setup_s = result["setup_end"] - T_START
    peak = max((torch.cuda.max_memory_allocated(d) for d in range(cards)), default=0) \
        if on_card else 0
    records = result["records"]
    if keep is not None:
        keep["records"] = records
    failed = sum(r["error"] is not None or r["out"] is None for r in records)
    bypassed = session.problems(records)
    if bypassed:
        print("portbench: reading points bypassed, the check cannot run "
              f"(requests/{work['request']}.py): " + "; ".join(bypassed), file=sys.stderr)
        return 4, None, []

    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    peaks = peaks_lib.peaks_for(name)
    ctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=result["window_s"], records=records,
        completed=len(records) - failed, cards=cards, config=config, params=params,
        peaks=peaks, trace=sliced.reduce(session.trace_units()) if trace else None)
    metrics, lines = {}, []
    for m in cell_metrics(args.workload, trace):
        value = module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if on_card:
        lines.append(f"card: {peaks_lib.smi()}; peaks used: {peaks['float32']:.4g} FLOP/s f32, "
                     f"{peaks['bytes']:.4g} B/s (published at {peaks['rated_w']:.0f} W)")
    dev_info = {"platform": "gpu" if on_card else "cpu", "kind": name, "count": cards,
                "memory_peak_bytes": int(peak)}
    out = {"correct": False, "attempted": len(records), "failed": failed, "metrics": metrics,
           "device": dev_info}
    if trace and ctx.trace is not None:
        b = tracing.busy(ctx.trace)
        dev_info["busy_s"] = b["mean_busy_us"] / 1e6
        dev_info["window_s"] = b["window_us"] / 1e6
        for d, us in b["per_card_us"].items():
            lines.append(f"card {d}: busy {us / 1e6:.6f} s of the traced "
                         f"{b['window_us'] / 1e6:.6f} s ({ctx.trace.steps} units)")
        out["breakdown"] = {
            "device_ops": [[n, us / 1e6] for n, us in tracing.top_ops(ctx.trace)],
            "idle_gaps": [[n, us / 1e6] for n, us in tracing.idle_gaps(ctx.trace)[:10]]}

    # the check, once the window has closed, the peak has been read and the
    # program's state is freed
    session.release()
    numbers, checked = session.check(records)
    if keep is not None:
        keep["numbers"] = numbers
    limits = work["limits"]
    out["correct"] = bool(failed == 0 and checked and checked == session.due(records)
                          and check.judge(numbers, limits))
    out["checks"] = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    lines += [f"check {k}: {numbers.get(k)} (limit {limits[k]})" for k in limits]
    lines = [f"not judged {k}: {v}" for k, v in numbers.items() if k not in limits] + lines
    bad = forbidden_modules()  # what the run loaded, the window and the check included
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3, None, []
    return 0, out, lines


def main(argv: Optional[List[str]] = None) -> int:
    rc, out, lines = execute(argv)
    if out is not None:
        print(json.dumps(out), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return rc


if __name__ == "__main__":
    sys.exit(main())
