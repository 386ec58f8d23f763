"""The harness on the CPU: its command line, what it finds by name, the
seeded traffic, a tiny run of each cell through ``apply_image`` and the
last line it prints, and what the harness and the reference import."""

import json
import os
import subprocess
import sys

import pytest

from portbench import run
from portbench.generators import closed_loop
from portbench.requests import gatys as gatys_kind

ROOT = run.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
TINY_DA = {"patch": 14, "width": 32, "layers": 2, "heads": 2, "mlp_ratio": 2,
           "out_layers": [1, 1, 2, 2], "neck_dims": [8, 8, 16, 16], "fusion": 8,
           "head_hidden": 8, "pos_grid": 2, "input_size": 28}


def tiny(cell, **params):
    """Overrides that run ``cell`` at 32px for 14 steps, the first 12 of
    them followed update by update (the L-BFGS buffer of 10 wraps), with a
    tiny Depth Anything where the cell has one."""
    ov = {"params": {"side": 32, "steps": 14, "check_steps": 12, "warmup_steps": 2,
                     "trace_steps": [3, 5], **params}}
    if "depth_anything" in run.load("configs", run.load("workloads", cell)["config"]):
        ov["config"] = {"depth_anything": TINY_DA}
    return ov


# At 32² one pool or ReLU kink that f32 rounding resolves one way in the
# port and the other way in the reference moves a patch of some 5×6 pixels,
# a large share of the gradient, and the updates after it follow (PERF.md
# §2). The cells' limits on these numbers are set at 512², where such a
# patch is a small share; a tiny run holds them to this one instead.
TINY_TRAJECTORY = {"stepk_rel": 1e-2, "stepk_median_rel": 1e-2, "gradk_rel": 1e-2,
                   "last_step_rel": 1e-2}


def sound_at_tiny(out):
    """The run's numbers within the cell's limits, those along the
    trajectory within ``TINY_TRAJECTORY``."""
    from portbench import check

    limits = {k: v["limit"] for k, v in out["checks"].items()}
    limits.update({k: v for k, v in TINY_TRAJECTORY.items() if k in limits})
    return check.judge({k: v["value"] for k, v in out["checks"].items()}, limits)


def execute(cell, seed=3000000001, trace=0, seconds=0.001, **kw):
    import torch

    torch.manual_seed(0)
    return run.execute(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)], device="cpu", overrides=tiny(cell), **kw)


def test_cli_parsing():
    a = run.parse_args(["--workload", "gatys512", "--seed", "4294967301", "--seconds", "40",
                        "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == ("gatys512", 4294967301, 40.0, 1)
    assert run.parse_args(["--workload", "x", "--seed", "-3", "--seconds", "1"]).trace == 0
    with pytest.raises(SystemExit):
        run.parse_args(["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"])
    with pytest.raises(SystemExit):
        run.parse_args(["--seed", "1", "--seconds", "1"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    """Each cell of BENCHMARK.json has its workload file, which agrees with
    it, a configuration file, a traffic generator, and a reader for every metric it
    reports."""
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    work = run.load("workloads", cell)
    for key in ("config", "traffic", "chips", "why"):
        assert work[key] == entry[key]
    cfg_entry = next(c for c in BENCH["configs"] if c["name"] == work["config"])
    assert os.path.exists(os.path.join(ROOT, cfg_entry["file"]))
    assert run.load("configs", work["config"])["name"] == work["config"]
    assert callable(run.module("generators", work["generator"]).run)
    for trace in (False, True):
        metrics = run.cell_metrics(cell, trace)
        assert metrics
        for m in metrics:
            assert callable(run.module("metrics", m["name"]).read)
    assert set(work["limits"]) <= set(__import__("portbench.check").check.NUMBERS)


def test_every_metric_has_a_reader_and_a_cell():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    files = {f[:-3] for f in os.listdir(os.path.join(ROOT, "portbench", "metrics"))
             if f.endswith(".py")}
    assert set(names) == files
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_pair_draw_is_seeded_and_fair():
    params = run.load("workloads", "gatys512")["params"]
    a = gatys_kind.draw_pairs(params, 7)
    assert a == gatys_kind.draw_pairs(params, 7)
    b = gatys_kind.draw_pairs(params, 8)
    assert a != b
    n = len(params["content"]) * len(params["style"])
    assert len(a) == params["requests"] and len(set(a)) == len(a)
    full = dict(params, requests=n)  # every seed: the same requests, another order
    assert sorted(gatys_kind.draw_pairs(full, 7)) == sorted(gatys_kind.draw_pairs(full, 8))
    big = gatys_kind.draw_pairs(dict(params, requests=2 * n + 3), 7)
    assert len(big) == 2 * n + 3 and sorted(big[:n]) == sorted(big[n:2 * n])


def test_images_are_checked_and_squared():
    params = run.load("workloads", "gatys512")["params"]
    images = gatys_kind.load_images(dict(params, side=48), ROOT)
    assert len(images) == len(params["content"]) + len(params["style"])
    assert all(im.size == (48, 48) and im.mode == "RGB" for im in images.values())
    bad = dict(params, content={next(iter(params["content"])): "0" * 64}, style={})
    with pytest.raises(RuntimeError, match="not the image"):
        gatys_kind.load_images(bad, ROOT)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_run_and_last_line(cell, trace):
    """A tiny run of the cell through ``apply_image`` on the CPU: sound,
    and the last line's keys; ``checks`` comes last."""
    rc, out, lines = execute(cell, trace=trace, seconds=0.5 if trace == 0 else 0.001)
    assert rc == 0
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert sound_at_tiny(out), out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    want = {m["name"] for m in run.cell_metrics(cell, bool(trace))}
    if trace == 0:
        assert set(out["metrics"]) == want
        assert out["metrics"]["setup_s"]["value"] > 0
    else:
        # a CPU run has no device trace: only the host-side readers answer
        assert set(out["metrics"]) <= want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in out["checks"].values())
    assert lines[-len(out["checks"]):] == [
        f"check {k}: {v['value']} (limit {v['limit']})" for k, v in out["checks"].items()]
    json.dumps(out)


def test_window_holds_whole_requests(monkeypatch):
    """The window runs from the first request to the return of the last one
    started within ``seconds``; the warm-up request comes before it. A
    Gatys run's warm-up asks for ``warmup_steps`` steps, each window
    request for the workload's ``steps``."""
    import time

    sent = []

    class Session:
        reader = gatys_kind.Reader(14)

        def load(self, root):
            pass

        def draw(self, seed):
            return gatys_kind.draw_pairs(params, seed)

        def warm_up(self, items):
            sent.append("warm")

        def send(self, item):
            sent.append(item)
            time.sleep(0.05)
            return "image", {"program_s": 0.05, "hist": []}

    params = dict(run.load("workloads", "gatys512")["params"], side=8)
    out = closed_loop.run(params, 5, 0.12, ROOT, Session(), lambda: None, False)
    n = len(out["records"])
    assert sent[0] == "warm" and sent[1:] == [r["item"] for r in out["records"]]
    assert 2 <= n <= 3
    assert out["window_s"] >= sum(r["wall_s"] for r in out["records"])
    asked = []
    build = gatys_kind.build_request

    def spy(config, steps):
        asked.append(steps)
        return build(config, steps)

    monkeypatch.setattr(gatys_kind, "build_request", spy)
    keep = {}
    execute("gatys512", seconds=0.001, keep=keep)
    small = tiny("gatys512")["params"]
    assert asked == [small["warmup_steps"]] + [small["steps"]] * len(keep["records"])
    cap = keep["records"][0]["captures"]
    assert len(keep["records"]) == 1 and cap["steps"] == 14 and cap["problems"] == []
    assert len(cap["steps_u"]) == 13
    assert set(keep["numbers"]) == set(__import__("portbench.check").check.NUMBERS)


def test_request_kinds_are_found_by_name(monkeypatch, capsys):
    """A workload's ``request`` names its module under ``requests/``; a
    kind with no module stops the run without a result."""
    for cell in CELLS:
        kind = run.request_kind(run.load("workloads", cell))
        assert callable(kind.Session)
    real = run.load

    def unknown(kind, name):
        out = real(kind, name)
        return dict(out, request="no_such_kind") if kind == "workloads" else out

    monkeypatch.setattr(run, "load", unknown)
    rc, out, _ = execute("gatys512")
    assert rc == 5 and out is None
    assert "no request kind 'no_such_kind'" in capsys.readouterr().err


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    """A whole tiny run loads neither JAX nor the JAX package, compared by
    top-level module name (the port's name begins with the JAX package's)."""
    mods = _modules_after(
        "import sys; sys.argv = ['x']\n"
        "from portbench.tests.test_portbench_harness import execute\n"
        "rc, out, _ = execute('depth_loss512', trace=1)\n"
        "assert rc == 0 and out['attempted'] == 1")
    assert not mods & {"jax", "jaxlib", "flax", "tbist_tpu"}
    assert "tbist_tpu_torch" in mods


def test_reference_loads_nothing_of_the_port():
    mods = _modules_after("import portbench.reference.gatys, portbench.reference.vgg19, "
                          "portbench.reference.depth_anything")
    assert not mods & {"jax", "jaxlib", "flax", "tbist_tpu", "tbist_tpu_torch"}


def test_no_card_no_result(monkeypatch, capsys):
    """Without a card the run exits non-zero and prints no result."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "set_environment", lambda chips: None)
    rc = run.main(["--workload", "gatys512", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_only_the_benchmark_is_not_enough(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/ the run
    fails and prints no result."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "gatys512",
                          "--seed", "5", "--seconds", "1"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_a_run_that_loads_jax_prints_no_result(monkeypatch):
    """A run in whose process JAX or the JAX package is loaded, compared by
    top-level name, exits non-zero without a result."""
    import types

    monkeypatch.setitem(sys.modules, "tbist_tpu.utils", types.ModuleType("tbist_tpu.utils"))
    rc, out, _ = execute("gatys512")
    assert rc != 0 and out is None
    monkeypatch.delitem(sys.modules, "tbist_tpu.utils")
    monkeypatch.setitem(sys.modules, "tbist_tpu_torchx", types.ModuleType("tbist_tpu_torchx"))
    assert execute("gatys512")[0] == 0


def test_worst_request_and_nan():
    from portbench import check

    rows = [{"a": 1e-6}, {"a": float("nan")}, {"a": 2e-6}]
    assert check.worst(rows)["a"] != check.worst(rows)["a"]  # NaN
    assert not check.judge(check.worst(rows), {"a": 1.0})
    assert check.worst([{"a": 1e-6}, {"a": 3e-6}]) == {"a": 3e-6}


@pytest.mark.parametrize("cell", ["gatys", "depth"])
def test_device_busy_reader(cell):
    """The device's busy milliseconds a step: the union of the card's
    operations over the traced steps; nothing without a trace."""
    import types

    from portbench.tracing import Trace

    t = Trace(kernels=[("a", 0, 0.0, 1000.0), ("b", 0, 500.0, 3000.0)],
              copies=[("Memcpy", 0, 5000.0, 6000.0)], host_ops=[], ranges_us={}, steps=2,
              cards=1)
    reader = run.module("metrics", f"device_busy_ms_per_step.{cell}")
    assert reader.read(types.SimpleNamespace(trace=t)) == pytest.approx(2.0)
    assert reader.read(types.SimpleNamespace(trace=None)) is None
