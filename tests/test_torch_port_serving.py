"""The port's HTTP synthesis service on the CPU (size 32) against the JAX
service with the same weights, and a subprocess proof that the port runs
with JAX, Flax and PyYAML unimportable."""
import concurrent.futures
import json
import os
import subprocess
import sys
import textwrap
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.data.dicom import dicom_bytes, make_ct_slice, read_dicom
from ctagan_tpu.data.fixtures import synthetic_ct_pixels
from ctagan_tpu.models import Generator as JaxGenerator
from ctagan_tpu.serving.server import serve_async as jax_serve_async
from ctagan_tpu_torch.models import Generator
from ctagan_tpu_torch.models.convert import generator_state_dict
from ctagan_tpu_torch.serving.server import SynthesisService, serve_async

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32


def _stop(server, service):
    server.shutdown()
    server.server_close()
    service.stop()


@pytest.fixture(scope="module")
def servers():
    """(port of the JAX service, port of the port's service), same weights."""
    g_jax = JaxGenerator(1, 1)
    params = g_jax.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)))
    g = Generator(1, 1)
    g.load_state_dict(generator_state_dict(jax.device_get(params)),
                      strict=True)
    jsrv, jsvc, jport = jax_serve_async(g_jax, params, size=SIZE, max_batch=4)
    srv, svc, port = serve_async(g, size=SIZE, max_batch=4)
    yield jport, port
    _stop(jsrv, jsvc)
    _stop(srv, svc)


def _slice(seed):
    return make_ct_slice(synthetic_ct_pixels(np.random.default_rng(seed),
                                             SIZE))


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def test_roundtrip_matches_jax_service(servers):
    jport, port = servers
    ds_in = _slice(0)
    body = dicom_bytes(ds_in)
    _, want = _post(jport, body)
    status, got = _post(port, body)
    assert status == 200
    ds = read_dicom(got)
    px = ds.pixel_array().astype(np.int64)
    assert px.shape == (SIZE, SIZE)
    assert 0 <= px.min() and px.max() <= 4095
    assert ds.series_instance_uid != ds_in.series_instance_uid
    # stored values: (fake+1)/2·4095 rounds to integers; float ordering may
    # move a value across a rounding boundary
    ref = read_dicom(want).pixel_array().astype(np.int64)
    assert np.abs(px - ref).max() <= 1


def test_concurrent_requests_microbatch(servers):
    _, port = servers
    bodies = [dicom_bytes(_slice(i)) for i in range(8)]
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        replies = list(ex.map(lambda b: _post(port, b), bodies))
    assert [s for s, _ in replies] == [200] * 8
    assert all(read_dicom(b).pixel_array().shape == (SIZE, SIZE)
               for _, b in replies)
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["max_batch"] == 4
    assert health["device"] == "cpu" and health["batches_served"] >= 1


def test_malformed_body_gives_400(servers):
    _, port = servers
    req = urllib.request.Request(f"http://127.0.0.1:{port}/synthesize",
                                 data=b"not a dicom", method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=60)
    assert ei.value.code == 400
    assert "error" in json.loads(ei.value.read())


@pytest.mark.parametrize("path", ["/nope", "/synthesize"])
def test_unknown_path_gives_404(servers, path):
    _, port = servers
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60)
    assert ei.value.code == 404


class _Scale(torch.nn.Module):
    """Stand-in model: output = input · k, so the request→result mapping of
    pipelined, micro-batched dispatch is checked exactly."""

    def __init__(self, k):
        super().__init__()
        self.k = torch.nn.Parameter(torch.tensor(k))

    def forward(self, x):
        return x * self.k


def test_pipelined_dispatch_preserves_request_mapping():
    svc = SynthesisService(_Scale(2.0), size=8, max_batch=2,
                           batch_timeout_ms=2.0, pipeline_depth=3)
    try:
        rng = np.random.default_rng(0)
        images = [rng.uniform(-1, 1, (8, 8)).astype(np.float32)
                  for _ in range(16)]
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            outs = list(ex.map(svc.synthesize, images))
        for img, out in zip(images, outs):
            np.testing.assert_allclose(out, img * 2.0, rtol=1e-6)
        assert svc.stats()["pipeline_depth"] == 3
    finally:
        svc.stop()


def test_series_streaming_context():
    """2.5-D: the response for slice i uses slices i-1, i, i+1 (clamped)."""
    class _Mid(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.p = torch.nn.Parameter(torch.zeros(()))

        def forward(self, x):  # left + 10·center + 100·right
            return (x[..., :1] + 10 * x[..., 1:2] + 100 * x[..., 2:3]
                    + self.p)

    svc = SynthesisService(_Mid(), size=4, max_batch=4, channels=3)
    try:
        imgs = [np.full((4, 4), float(i + 1), np.float32) for i in range(3)]
        with concurrent.futures.ThreadPoolExecutor(3) as ex:
            futs = []
            for i, im in enumerate(imgs):  # post in order, as a client must
                futs.append(ex.submit(svc.synthesize, im, 60.0, "s", i == 2))
                deadline = time.monotonic() + 30
                while i < 2 and ("s" not in svc._rings
                                 or svc._rings["s"].count <= i):
                    assert time.monotonic() < deadline
                    time.sleep(0.001)
            outs = [f.result() for f in futs]
    finally:
        svc.stop()
    assert [float(o[0, 0]) for o in outs] == [1 + 10 + 200, 1 + 20 + 300,
                                              2 + 30 + 300]


@pytest.mark.parametrize("mode,exc", [("fp4", ValueError)])
def test_quantize_modes_rejected(mode, exc):
    with pytest.raises(exc):
        SynthesisService(_Scale(1.0), size=8, quantize=mode)


def test_int8_service_matches_jax_int8_service():
    """quantize="int8" serves through the int8 forward: 4 requests answered
    close to the JAX service's int8 answers on the same weights. Int8
    rounding flips between the two frameworks (a last-bit difference of a
    conv moves a value across a rounding boundary, which the next
    re-quantization carries on) keep them a few int8 steps apart, well
    inside JAX's own bound of its int8 service against f32 (mean 0.05)."""
    g_jax = JaxGenerator(1, 1, n_residual_blocks=3)
    params = g_jax.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 1)))
    g = Generator(1, 1, n_residual_blocks=3)
    g.load_state_dict(generator_state_dict(jax.device_get(params)),
                      strict=True)
    from ctagan_tpu.serving.server import SynthesisService as JaxService

    jsvc = JaxService(g_jax, params, size=SIZE, max_batch=2, quantize="int8")
    svc = SynthesisService(g, size=SIZE, max_batch=2, quantize="int8")
    try:
        rng = np.random.default_rng(0)
        imgs = [rng.uniform(-1, 1, (SIZE, SIZE)).astype(np.float32)
                for _ in range(4)]
        with concurrent.futures.ThreadPoolExecutor(4) as ex:
            got = list(ex.map(svc.synthesize, imgs))
            want = list(ex.map(jsvc.synthesize, imgs))
        assert svc.stats()["quantize"] == "int8"
    finally:
        svc.stop()
        jsvc.stop()
    for w, o in zip(want, got):
        assert o.shape == (SIZE, SIZE) and np.isfinite(o).all()
        assert np.mean(np.abs(w - o)) < 0.02
        assert np.abs(w - o).max() < 0.25


def test_port_runs_without_jax(tmp_path):
    """A fresh interpreter in which jax, flax, yaml and the JAX package
    cannot be imported runs a generator forward and a server round trip
    through the port."""
    code = textwrap.dedent(f"""
        import sys
        for mod in ("jax", "flax", "yaml", "ctagan_tpu"):
            sys.modules[mod] = None
        import urllib.request
        import numpy as np
        import torch
        torch.set_num_threads(2)
        from ctagan_tpu_torch.data.dicom import (
            dicom_bytes, make_ct_slice, read_dicom)
        from ctagan_tpu_torch.data.fixtures import synthetic_ct_pixels
        from ctagan_tpu_torch.__main__ import serving_generator
        from ctagan_tpu_torch.models import Generator
        from ctagan_tpu_torch.serving.server import serve_async
        from ctagan_tpu_torch.utils.config import load_config

        g = Generator(1, 1, n_residual_blocks=1).reset_parameters(0)
        with torch.inference_mode():
            y = g(torch.zeros(1, 16, 16, 1))
        assert y.shape == (1, 16, 16, 1) and torch.isfinite(y).all()
        cfg = load_config({{"size": {SIZE}}})
        g, path = serving_generator(cfg, torch.device("cpu"))
        assert path is None and g.fused_body
        srv, svc, port = serve_async(g, size={SIZE}, max_batch=2)
        ds = make_ct_slice(synthetic_ct_pixels(np.random.default_rng(0), {SIZE}))
        req = urllib.request.Request(
            f"http://127.0.0.1:{{port}}/synthesize", data=dicom_bytes(ds),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            out = read_dicom(r.read()).pixel_array()
        srv.shutdown(); srv.server_close(); svc.stop()
        assert out.shape == ({SIZE}, {SIZE})
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "flax", "yaml",
                                               "ctagan_tpu")
                        and sys.modules[m] is not None)
        assert not leaked, leaked
        print("NOJAX_OK")
    """)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NOJAX_OK" in res.stdout


def test_entry_point_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path cannot be reached")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    res = subprocess.run(
        [sys.executable, "-m", "ctagan_tpu_torch", "--config",
         os.path.join(REPO, "configs", "HdGan.yaml"), "--device", "cuda"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
