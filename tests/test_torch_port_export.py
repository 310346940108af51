"""The port's generator artifact (``serving/export.py``) against the JAX
package's (``ctagan_tpu/serving/export.py``, ``tests/test_export.py``).

- A symbolic-batch export of the plain route, loaded by ``load_exported``
  in a fresh interpreter where no module of ``ctagan_tpu_torch.models`` is
  imported, run at b=1 and b=3: within 2e-5 of the eager plain route (JAX's
  own tolerance for its round trip), and within 2e-5 of JAX's artifact of
  the same weights (a G of 2 residual blocks at base 16; JAX's f32 G's own
  distance from a float64 forward is added, as the infer tests hold it).
- The header: JAX's keys, ``batch`` null (symbolic) or pinned.
- ``fused_body`` and ``fused_body_grad`` are off in the artifact whatever
  the model had, and the model itself is left as it was.
- A JAX ``.ctax`` artifact is refused with the reason.
- ``--mode export --device cpu`` in a fresh interpreter, on a JAX
  ``.ckpt`` found in ``save_root``: the artifact holds that checkpoint's G.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctagan_tpu.models import Generator as JaxGenerator
from ctagan_tpu.serving import export as jax_export
from ctagan_tpu.utils import checkpoint as jax_ckpt
from ctagan_tpu_torch.models import Generator
from ctagan_tpu_torch.serving.export import (
    HEADER_MAGIC,
    export_generator,
    load_exported,
)
from tests.test_torch_port_p2p import SMALL_G, jax_tree

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64
TOL = 2e-5
BATCHES = (1, 3)


def _inputs(b):
    return np.random.default_rng(b).uniform(-1, 1, (b, SIZE, SIZE, 1)).astype(
        np.float32)


def _run_fresh(path, out_dir):
    """load_exported in a fresh interpreter: the outputs at BATCHES and the
    port's modules it imported."""
    code = (
        "import json, sys\n"
        "import numpy as np, torch\n"
        "from ctagan_tpu_torch.serving.export import load_exported\n"
        f"fn, header = load_exported({path!r})\n"
        f"for b in {BATCHES!r}:\n"
        "    x = np.random.default_rng(b).uniform(-1, 1, "
        f"(b, {SIZE}, {SIZE}, 1)).astype(np.float32)\n"
        f"    np.save({out_dir!r} + f'/out{{b}}.npy', "
        "fn(torch.from_numpy(x)).numpy())\n"
        "print(json.dumps({'header': header, 'modules': sorted(m for m in "
        "sys.modules if m.startswith('ctagan'))}))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    return ({b: np.load(f"{out_dir}/out{b}.npy") for b in BATCHES},
            info["header"], info["modules"])


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("export"))
    g = Generator(1, 1, fused_body=True, fused_body_grad=True,
                  **SMALL_G).reset_parameters(3)
    path = export_generator(g, f"{root}/g.ctpt", size=SIZE)
    outs, header, modules = _run_fresh(path, root)
    return dict(g=g, path=path, outs=outs, header=header, modules=modules,
                root=root)


def test_round_trip_matches_the_eager_plain_route(exported):
    g = exported["g"]
    for b in BATCHES:
        with torch.no_grad():
            want = g(torch.from_numpy(_inputs(b)), fused_body=False)
        got = exported["outs"][b]
        assert got.shape == (b, SIZE, SIZE, 1)
        np.testing.assert_allclose(got, want.numpy(), rtol=0, atol=TOL)


def test_loader_needs_no_module_of_the_port(exported):
    assert exported["modules"] == ["ctagan_tpu_torch",
                                   "ctagan_tpu_torch.serving",
                                   "ctagan_tpu_torch.serving.export"]


def test_header_has_jax_keys_and_a_symbolic_batch(exported, tmp_path):
    h = exported["header"]
    assert {"size", "channels", "batch", "platforms", "fingerprint"} <= set(h)
    assert (h["size"], h["channels"], h["batch"]) == (SIZE, 1, None)
    assert h["platforms"] == ["cpu"] and h["fingerprint"] == "Generator"
    with open(exported["path"], "rb") as f:
        assert f.read(len(HEADER_MAGIC)) == HEADER_MAGIC
    # the model keeps its own routes
    assert exported["g"].fused_body is True
    assert exported["g"].fused_body_grad is True
    # a pinned batch
    path = export_generator(exported["g"], str(tmp_path / "b2.ctpt"),
                            size=SIZE, batch=2)
    fn, header = load_exported(path)
    assert header["batch"] == 2
    assert tuple(fn(torch.zeros(2, SIZE, SIZE, 1)).shape) == (2, SIZE, SIZE,
                                                             1)


def test_round_trip_matches_jax_artifact(exported, tmp_path):
    g = exported["g"]
    params = jax_tree(g)
    jg = JaxGenerator(1, 1, **SMALL_G)
    path = jax_export.export_generator(jg, params, str(tmp_path / "g.ctax"),
                                       size=SIZE)
    jfn, jheader = jax_export.load_exported(path)
    assert jheader["batch"] is exported["header"]["batch"] is None
    g64 = Generator(1, 1, fused_body=False, **SMALL_G).double()
    g64.load_state_dict(g.state_dict())
    for b in BATCHES:
        x = _inputs(b)
        want = np.asarray(jfn(jnp.asarray(x)))
        with torch.no_grad():
            ref64 = g64(torch.from_numpy(x).double()).numpy()
        jax_own = float(np.abs(want - ref64).max())
        np.testing.assert_allclose(exported["outs"][b], want, rtol=0,
                                   atol=jax_own + TOL)
    # and the port refuses JAX's artifact, saying what it is
    with pytest.raises(ValueError, match="JAX package's artifact"):
        load_exported(path)


def test_export_mode_on_a_jax_checkpoint_in_a_fresh_interpreter(tmp_path):
    g = Generator(1, 1).reset_parameters(5)
    jax_ckpt.save_checkpoint(str(tmp_path / "model"), "P2p_p2p", 4, {
        "state": {"g_params": jax_tree(g), "g_ema": None}, "epoch": 4,
        "lr": 1e-4, "lr_d": 1e-4})
    cfg = os.path.join(tmp_path, "P2p_small.yaml")
    with open(cfg, "w") as f:
        f.write(f"name: P2p\nsize: {SIZE}\n"
                f"save_root: '{tmp_path}/model/'\n")
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'ctagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from ctagan_tpu_torch.__main__ import main\n"
            f"sys.exit(main(['--config', {cfg!r}, '--mode', 'export', "
            "'--device', 'cpu']))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = os.path.join(tmp_path, "model", "generator.ctpt")
    assert f"artifact written to: {out}" in res.stdout
    fn, header = load_exported(out)
    x = torch.from_numpy(_inputs(1))
    with torch.no_grad():
        want = g.eval()(x, fused_body=False)
    np.testing.assert_allclose(fn(x).numpy(), want.numpy(), rtol=0, atol=TOL)
