"""The port's HTTP server (``tbist_tpu_torch.serve``) on the CPU: real HTTP
round trips mirroring tests/test_serve.py, the request schema against the
JAX package's, and the port's server against the JAX server on the same
requests."""

import base64
import dataclasses
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
from PIL import Image

from tbist_tpu import serve as jserve
from tbist_tpu.utils import request_schema as jschema
from tbist_tpu_torch import serve as tserve
from tbist_tpu_torch.utils import request_schema as tschema


def _start(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server_url():
    srv = tserve.make_server(port=0, device="cpu")  # ephemeral port
    yield _start(srv)
    srv.shutdown()
    srv.server_close()


@pytest.fixture(scope="module")
def jax_url():
    srv = jserve.make_server(port=0)
    yield _start(srv)
    srv.shutdown()
    srv.server_close()


def _b64(img: np.ndarray) -> str:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _png(b64: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _post(url, payload):
    req = urllib.request.Request(
        url, json.dumps(payload).encode(), {"Content-Type": "application/json"}
    )
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _healthz(url):
    with urllib.request.urlopen(url + "/healthz") as r:
        return json.loads(r.read())


def _noise(seed, shape):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


class TestServe:
    def test_healthz(self, server_url):
        data = _healthz(server_url)
        assert data == {"status": "ok", "backend": "cpu", "devices": 1}

    def test_grayscale_roundtrip(self, server_url):
        img = _noise(0, (32, 32, 3))
        status, data = _post(
            server_url + "/v1/image", {"image": _b64(img), "request": {"grayscale": True}}
        )
        assert status == 200
        out = _png(data["image"])
        assert out.shape[:2] == (32, 32)
        assert np.abs(out[..., 0].astype(int) - out[..., 1].astype(int)).max() <= 1

    def test_concurrent_requests_serialize_safely(self, server_url):
        """Requests run one at a time behind the handler lock; all
        concurrent requests still succeed, each with its own result."""
        import concurrent.futures

        rng = np.random.default_rng(1)
        imgs = [(rng.random((24, 24, 3)) * 255).astype(np.uint8) for _ in range(4)]

        def call(img):
            return _post(server_url + "/v1/image",
                         {"image": _b64(img), "request": {"grayscale": True}})

        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            results = list(ex.map(call, imgs))
        assert all(status == 200 for status, _ in results)
        for img, (_, d) in zip(imgs, results):
            want = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
            assert np.abs(_png(d["image"])[..., 0].astype(float) - want).mean() < 2.0

    def test_grayscale_reply_not_degraded(self, server_url):
        status, data = _post(server_url + "/v1/image",
                             {"image": _b64(np.zeros((16, 16, 3), np.uint8)),
                              "request": {"grayscale": True}})
        assert status == 200 and data["degraded"] == []

    def test_no_warmup_by_default(self, server_url):
        assert "warmup_s" not in _healthz(server_url)

    def test_default_cap_allows_normal_images(self, server_url):
        code, _ = _post(server_url + "/v1/image",
                        {"image": _b64(np.zeros((64, 64, 3), np.uint8)),
                         "request": {"grayscale": True}})
        assert code == 200

    def test_defaults_to_cuda(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.make_server(port=0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tserve.main(["--port", "0"])


class TestServeVideo:
    @staticmethod
    def _tiny_mp4(tmp_path, n=4, size=32):
        cv2 = pytest.importorskip("cv2")
        path = str(tmp_path / "in.mp4")
        out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 8.0, (size, size))
        assert out.isOpened()
        rng = np.random.default_rng(3)
        for _ in range(n):
            out.write((rng.random((size, size, 3)) * 255).astype(np.uint8))
        out.release()
        with open(path, "rb") as f:
            return base64.b64encode(f.read()).decode()

    def test_video_roundtrip(self, server_url, tmp_path):
        cv2 = pytest.importorskip("cv2")
        status, data = _post(server_url + "/v1/video",
                             {"video": self._tiny_mp4(tmp_path),
                              "request": {"grayscale": True}, "max_frames": 3})
        assert status == 200 and "degraded" in data
        out_path = str(tmp_path / "out.mp4")
        with open(out_path, "wb") as f:
            f.write(base64.b64decode(data["video"]))
        cap = cv2.VideoCapture(out_path)
        frames = 0
        while cap.read()[0]:
            frames += 1
        cap.release()
        assert frames == 3


class TestRequestSchema:
    """The three cases of tests/test_serve.py, the port's request field by
    field against the JAX package's on the same dict."""

    @pytest.mark.parametrize("data", [
        {"style_transfer": True, "gatys": {"num_steps": 10, "optimizer": "adam"},
         "text": {"style_prompt": "fire"}},
        {"gatys": {"style_layers": ["conv1_1", "conv2_1"]}},
        {"grayscale": 1, "pixel_art": {"pixel_size": 0.2}, "video": {"slowmo": 0.5},
         "composite": {"edge_smoothing": 3}, "depth": {"mode": "mip"}},
    ])
    def test_matches_jax(self, data):
        treq, jreq = tschema.request_from_dict(data), jschema.request_from_dict(data)
        assert dataclasses.asdict(treq) == dataclasses.asdict(jreq)
        assert tschema.request_to_dict(treq) == jschema.request_to_dict(jreq)
        assert treq.gatys.style_layers == jreq.gatys.style_layers  # tuples, not lists

    @pytest.mark.parametrize("data", [{"gatys": {"nuum_steps": 5}}, {"graiscale": True}])
    def test_unknown_field_raises_as_jax(self, data):
        with pytest.raises(ValueError) as te:
            tschema.request_from_dict(data)
        with pytest.raises(ValueError) as je:
            jschema.request_from_dict(data)
        assert str(te.value) == str(je.value)


class TestAgainstJaxServer:
    def test_grayscale_pixels(self, server_url, jax_url):
        img = _noise(4, (32, 32, 3))
        body = {"image": _b64(img), "request": {"grayscale": True}}
        (ts, td), (js, jd) = _post(server_url + "/v1/image", body), _post(jax_url + "/v1/image",
                                                                          body)
        assert ts == js == 200
        got, want = _png(td["image"]).astype(int), _png(jd["image"]).astype(int)
        assert got.shape == want.shape and np.abs(got - want).max() <= 1
        assert set(td) == set(jd) and td["degraded"] == jd["degraded"]

    @pytest.mark.parametrize("path,body,code", [
        ("/v1/image", {"request": {"graiscale": True}}, 400),
        ("/v1/image", {"request": {"gatys": {"nuum_steps": 5}}}, 400),
        ("/v1/nope", {}, 404),
        ("/v1/image", {"request": {"style_transfer": True}}, 422),
        ("/v1/video", {"request": {"grayscale": True}}, 422),
    ])
    def test_error_replies(self, server_url, jax_url, path, body, code):
        if "request" in body and path == "/v1/image":
            body = {"image": _b64(np.zeros((16, 16, 3), np.uint8)), **body}
        got, want = _post(server_url + path, body), _post(jax_url + path, body)
        assert got == want and got[0] == code

    def test_oversized_body_413(self):
        servers = [tserve.make_server(port=0, max_body_mb=0.001, device="cpu"),
                   jserve.make_server(port=0, max_body_mb=0.001)]
        try:
            urls = [_start(s) for s in servers]
            # incompressible noise, so that the PNG body clears the ~1 KB cap
            img = np.random.default_rng(0).integers(0, 255, (64, 64, 3), dtype=np.uint8)
            body = {"image": _b64(img), "request": {"grayscale": True}}
            got, want = (_post(u + "/v1/image", body) for u in urls)
            assert got == want and got[0] == 413 and "max-body-mb" in got[1]["error"]
        finally:
            for s in servers:
                s.shutdown()
                s.server_close()

    def test_cap_disabled_with_zero(self):
        srv = tserve.make_server(port=0, max_body_mb=0, device="cpu")
        try:
            code, _ = _post(_start(srv) + "/v1/image",
                            {"image": _b64(_noise(5, (64, 64, 3))),
                             "request": {"grayscale": True}})
            assert code == 200
        finally:
            srv.shutdown()
            srv.server_close()

    def test_style_transfer_degraded_matches_jax(self, server_url, jax_url):
        """No VGG checkpoint is in the repository: both servers reply with
        ``degraded == ['vgg_seeded']``."""
        body = {"image": _b64(_noise(2, (32, 32, 3))), "style_image": _b64(_noise(6, (32, 32, 3))),
                "request": {"style_transfer": True, "gatys": {"num_steps": 2}}}
        (ts, td), (js, jd) = _post(server_url + "/v1/image", body), _post(jax_url + "/v1/image",
                                                                          body)
        assert ts == js == 200
        assert td["degraded"] == jd["degraded"] and "vgg_seeded" in td["degraded"]
        assert _png(td["image"]).shape == _png(jd["image"]).shape == (32, 32, 3)

    def test_warmup_report_keys_match_jax(self):
        """Every arrival batch size 1..max_batch and the pipeline call."""
        servers = [tserve.make_server(port=0, batch_max=5, warmup_size=8, device="cpu"),
                   jserve.make_server(port=0, batch_max=5, warmup_size=8)]
        try:
            assert set(servers[0].warmup) == set(servers[1].warmup) == {
                "8px", "8px_b1", "8px_b2", "8px_b3", "8px_b4", "8px_b5"}
            assert all(v > 0 for v in servers[0].warmup.values())
        finally:
            for s in servers:
                s.server_close()


class TestWarmupAndBatching:
    def test_warmup_reports_and_batched_request(self):
        srv = tserve.make_server(port=0, batch_max=2, warmup_size=16, device="cpu")
        try:
            url = _start(srv)
            data = _healthz(url)
            assert set(data["warmup_s"]) == {"16px", "16px_b1", "16px_b2"}
            assert data["batching"] == {"max_batch": 2, "batches_run": 0, "requests_served": 0}
            img = _noise(0, (16, 16, 3))
            status, reply = _post(url + "/v1/image",
                                  {"image": _b64(img), "request": {"text": {"style_prompt": "fire"}}})
            assert status == 200 and reply["batch"] >= 1
            assert set(reply) == {"image", "timings_s", "degraded", "batch"}
            assert "ghiasi_seeded" in reply["degraded"]
            assert _healthz(url)["batching"]["requests_served"] == 1
        finally:
            srv.shutdown()
            srv.server_close()
        assert not srv.batcher._worker.is_alive()  # server_close stops the worker

    def test_burst_is_batched_and_equal_to_lone_requests(self):
        """Concurrent fast-text requests share batched calls, and each reply
        is within one level of the same request sent alone."""
        import concurrent.futures

        srv = tserve.make_server(port=0, batch_max=4, batch_window_ms=200, device="cpu")
        try:
            url = _start(srv)
            imgs = [_noise(10 + i, (16, 16, 3)) for i in range(4)]

            def call(img):
                return _post(url + "/v1/image",
                             {"image": _b64(img), "request": {"text": {"style_prompt": "mosaic"}}})

            with concurrent.futures.ThreadPoolExecutor(4) as ex:
                burst = list(ex.map(call, imgs))
            assert srv.batcher.batches_run < 4
            lone = [call(img) for img in imgs]
            for (bs, b), (ls, l) in zip(burst, lone):
                assert bs == ls == 200
                assert np.abs(_png(b["image"]).astype(int) - _png(l["image"]).astype(int)).max() <= 1
        finally:
            srv.shutdown()
            srv.server_close()

    def test_heavy_warmup_then_first_request_loads_nothing(self):
        """--warmup-programs gatys: the warm-up resolves VGG-19, so the
        first style-transfer request loads no model."""
        from tbist_tpu_torch.weights import vgg as vgg_weights

        srv = tserve.make_server(port=0, warmup_size=32, warmup_programs=("gatys",),
                                 warmup_gatys_steps=2, device="cpu")
        try:
            assert srv.warmup["gatys_32px"] > 0
            url = _start(srv)
            misses = vgg_weights.get_params.cache_info().misses
            img = _noise(0, (32, 32, 3))
            status, reply = _post(url + "/v1/image",
                                  {"image": _b64(img), "style_image": _b64(img),
                                   "request": {"style_transfer": True, "gatys": {"num_steps": 2}}})
            assert status == 200 and reply.get("image")
            assert vgg_weights.get_params.cache_info().misses == misses
        finally:
            srv.shutdown()
            srv.server_close()

    def test_heavy_warmup_mask_and_depth_report(self):
        srv = tserve.make_server(port=0, warmup_size=16, warmup_programs=("mask", "depth"),
                                 warmup_gatys_steps=1, device="cpu")
        try:
            assert {"mask_16px", "depth_16px"} <= set(srv.warmup)
            assert all(v > 0 for v in srv.warmup.values())
        finally:
            srv.server_close()

    def test_unknown_warmup_program_raises(self):
        with pytest.raises(ValueError, match="unknown warmup program"):
            tserve.warmup_heavy(8, programs=("nope",), device="cpu")


def test_two_requests_draw_no_model_twice(server_url):
    """Each request builds a fresh ``ModelRegistry``; the lru-cached loaders
    behind it must resolve each model once per process, not per request."""
    from tbist_tpu_torch.effects import depth, masking
    from tbist_tpu_torch.models import clip_text
    from tbist_tpu_torch.weights import ghiasi_convert
    from tbist_tpu_torch.weights import vgg as vgg_weights

    loaders = [vgg_weights.get_params, ghiasi_convert.get_params, clip_text.get_default_encoder,
               masking.default_mask_extractor, depth.default_depth_estimator]
    for fn in loaders:
        fn.cache_clear()
    img, style = _b64(_noise(7, (32, 32, 3))), _b64(_noise(8, (32, 32, 3)))
    requests = [
        {"style_transfer": True, "gatys": {"num_steps": 1}},
        {"text": {"style_prompt": "mosaic", "location_prompt": "boat"}},
        {"depth": {"mode": "depth_loss"}, "gatys": {"num_steps": 1}},
    ]
    for _ in range(2):
        for req in requests:
            status, _ = _post(server_url + "/v1/image",
                              {"image": img, "style_image": style, "request": req})
            assert status == 200
    assert {fn.__name__: fn.cache_info().misses for fn in loaders} == {
        fn.__name__: 1 for fn in loaders}
