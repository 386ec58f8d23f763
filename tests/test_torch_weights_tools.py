"""The port's weight runbook (``weights.verify_all``) and seeded-draw cache
(``weights.seed_cache``) on the CPU, the runbook against the JAX
package's on the same synthetic checkpoint."""

import json
import os

import numpy as np
import pytest
import torch

from tbist_tpu.weights import verify_all as jverify
from tbist_tpu.weights import vgg as jvgg_weights
from tbist_tpu_torch.weights import seed_cache
from tbist_tpu_torch.weights import verify_all as tverify
from tbist_tpu_torch.weights import vgg as tvgg_weights

_ENV = ("TBIST_VGG19_PTH", "TBIST_GHIASI_PTH", "TBIST_CLIP_MLP_PTH", "TBIST_CLIP_PTH",
        "TBIST_CLIP_BPE", "TBIST_DINO_PTH", "TBIST_SAM_PTH", "TBIST_BERT_VOCAB",
        "TBIST_T5_EMOJI_DIR", "TBIST_EMOJI_FONT", "TBIST_DEPTH_PTH")


@pytest.fixture
def clean_env(monkeypatch):
    """verify_all exports TBIST_* variables through os.environ: register
    every key with monkeypatch so that teardown removes what it set."""
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def test_all_missing_is_ok_but_strict_fails(tmp_path, clean_env, capsys):
    clean_env.setattr(tverify, "CACHE", str(tmp_path))
    assert tverify.main(["--device", "cpu"]) == 0
    assert tverify.main(["--device", "cpu", "--strict"]) == 1
    manifest = json.loads((tmp_path / "MANIFEST_torch.json").read_text())
    assert not (tmp_path / "MANIFEST.json").exists()  # the JAX runbook's file
    assert set(manifest["results"]) == {"vgg", "ghiasi+mlp", "clip", "dino+sam", "t5-emoji",
                                        "depth"}
    assert all(v.startswith("MISSING") for v in manifest["results"].values())
    assert manifest["files"] == {}
    # the same families and reasons as the JAX runbook
    clean_env.setattr(jverify, "CACHE", str(tmp_path))
    assert jverify.main([]) == 0
    jmanifest = json.loads((tmp_path / "MANIFEST.json").read_text())
    assert jmanifest == manifest


def test_defaults_to_cuda(clean_env):
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tverify.main([])


def _synthetic_vgg_pth(path) -> None:
    """A torchvision-layout vgg19 state dict of random weights."""
    gen = torch.Generator().manual_seed(0)
    idx_ch = [(0, 3, 64), (2, 64, 64), (5, 64, 128), (7, 128, 128),
              (10, 128, 256), (12, 256, 256), (14, 256, 256), (16, 256, 256),
              (19, 256, 512), (21, 512, 512), (23, 512, 512), (25, 512, 512),
              (28, 512, 512), (30, 512, 512), (32, 512, 512), (34, 512, 512)]
    sd = {}
    for i, cin, cout in idx_ch:
        sd[f"features.{i}.weight"] = torch.randn(cout, cin, 3, 3, generator=gen) * 0.05
        sd[f"features.{i}.bias"] = torch.zeros(cout)
    torch.save(sd, path)


def test_vgg_family_converts_and_passes_as_jax(tmp_path, clean_env):
    """A synthetic torchvision-layout .pth goes through the port's loader
    and battery, and reports what the JAX runbook reports on it."""
    pth = tmp_path / "vgg19.pth"
    _synthetic_vgg_pth(pth)
    for mod in (tverify, jverify):
        clean_env.setattr(mod, "CACHE", str(tmp_path))
    for mod in (tvgg_weights, jvgg_weights):  # the JAX loader writes a converted .npz there
        clean_env.setattr(mod, "_CACHE_DIR", str(tmp_path))
    clean_env.setenv("TBIST_VGG19_PTH", str(pth))
    tvgg_weights.get_params.cache_clear()
    jvgg_weights.get_params.cache_clear()
    try:
        trep, jrep = tverify.Report(), jverify.Report()
        assert tverify.verify_vgg(trep, str(pth), device="cpu")
        assert jverify.verify_vgg(jrep, str(pth))
        assert trep.results["vgg"].startswith("PASS")
        assert trep.results == jrep.results
        assert trep.manifest == jrep.manifest
        assert len(trep.manifest["vgg"]["vgg19.pth"]["sha256"]) == 64
    finally:
        tvgg_weights.get_params.cache_clear()
        jvgg_weights.get_params.cache_clear()


_SPEC = {"a": ((4, 5), torch.float32),
         "b": {"c": ((2,), torch.float32), "d": ((2, 3, 1, 1), torch.float32)}}


def _draw():
    gen = torch.Generator().manual_seed(3)
    return {"a": torch.randn(4, 5, generator=gen),
            "b": {"c": torch.zeros(2), "d": torch.randn(2, 3, 1, 1, generator=gen)
                  .contiguous(memory_format=torch.channels_last)}}


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_same(got[k], want[k])
        else:
            assert got[k].dtype == want[k].dtype and got[k].stride() == want[k].stride()
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


class TestSeedCache:
    def test_round_trip_is_bitwise_and_loads_from_disk(self, tmp_path, monkeypatch):
        monkeypatch.setattr(seed_cache, "_CACHE_DIR", str(tmp_path))
        first = seed_cache.cached_seeded_init("t1", _draw, _SPEC)
        path = tmp_path / "t1.pt"
        assert path.exists()
        _assert_same(first, _draw())
        _assert_same(seed_cache.cached_seeded_init("t1", _draw, _SPEC), first)
        # overwrite a stored tensor: a second call must return the DISK
        # values (proof that it loads rather than draws)
        data = torch.load(path, weights_only=True)
        data["a"] = data["a"] + 7.0
        torch.save(data, path)
        second = seed_cache.cached_seeded_init("t1", _draw, _SPEC)
        torch.testing.assert_close(second["a"], first["a"] + 7.0, rtol=0, atol=0)

    @pytest.mark.parametrize("change", ["shape", "dtype", "name", "torn"])
    def test_mismatch_rebuilds(self, tmp_path, monkeypatch, change):
        monkeypatch.setattr(seed_cache, "_CACHE_DIR", str(tmp_path))
        path = tmp_path / "t2.pt"
        stale = {"a": torch.zeros(4, 5), "b.c": torch.zeros(2), "b.d": torch.zeros(2, 3, 1, 1)}
        if change == "shape":
            stale["a"] = torch.zeros(5, 4)
        elif change == "dtype":
            stale["a"] = torch.zeros(4, 5, dtype=torch.float64)
        elif change == "name":
            stale["b.e"] = stale.pop("b.c")
        if change == "torn":
            path.write_bytes(b"not a checkpoint")
        else:
            torch.save(stale, path)
        got = seed_cache.cached_seeded_init("t2", _draw, _SPEC)
        _assert_same(got, _draw())
        _assert_same(torch.load(path, weights_only=True),  # rewritten with the draw
                     {"a": got["a"], "b.c": got["b"]["c"], "b.d": got["b"]["d"]})
        assert [p.name for p in tmp_path.iterdir()] == ["t2.pt"]  # no temporary left

    def test_disabled_by_env(self, tmp_path, monkeypatch):
        monkeypatch.setattr(seed_cache, "_CACHE_DIR", str(tmp_path))
        monkeypatch.setenv("TBIST_SEED_CACHE", "0")
        _assert_same(seed_cache.cached_seeded_init("t3", _draw, _SPEC), _draw())
        assert not os.listdir(tmp_path)
        torch.save({"a": torch.ones(4, 5)}, tmp_path / "t3.pt")  # and never read
        _assert_same(seed_cache.cached_seeded_init("t3", _draw, _SPEC), _draw())

    def test_vgg_fallback_goes_through_the_cache(self, tmp_path, monkeypatch):
        """Without any VGG file the port's loader draws torch-seeded weights
        once, keeps them in ``vgg19_seeded_s0.pt`` and loads them after; it
        writes no ``.npz``."""
        weights = tmp_path / "weights_cache"
        weights.mkdir()
        monkeypatch.delenv("TBIST_VGG19_PTH", raising=False)
        monkeypatch.setattr(tvgg_weights, "_CACHE_DIR", str(weights))
        monkeypatch.setattr(seed_cache, "_CACHE_DIR", str(weights / "torch"))
        from tbist_tpu_torch.models import vgg19

        tvgg_weights.get_params.cache_clear()
        try:
            first = tvgg_weights.get_params(device="cpu")
            assert os.listdir(weights) == ["torch"]
            assert os.listdir(weights / "torch") == ["vgg19_seeded_s0.pt"]
            tvgg_weights.get_params.cache_clear()
            _assert_same(tvgg_weights.get_params(device="cpu"), first)
            _assert_same(first, vgg19.init_params(torch.Generator().manual_seed(0)))
        finally:
            tvgg_weights.get_params.cache_clear()
