"""Parity: the port's 3-D demons registrar (``ctagan_tpu_torch/ops/
registration3d.py``) against the JAX package's, on seeded numpy inputs.

- Function by function in float64: ``smooth3d`` at σ 1 and 3 on a volume,
  on a 6-channel field and on a 5-slice axis shorter than the radius 9
  (the edge pad wider than the axis), ``warp3d`` with zero, integer,
  fractional and out-of-range flows and at D = 1, ``compose``,
  ``exp_field``, ``_grad3d`` (and at D = 1), ``_resize`` down (JAX
  antialiases: arange(8)² → [1, 7, 21, 40], where ``F.interpolate`` gives
  [0.5, 6.5, 20.5, 42.5]), up, with the depth kept and on a field,
  ``_solve3x3`` (and a system whose determinant the clamp caps), the
  population-std z-score.
- The pyramid at 16 × 32 × 32, whose depths run 16, 8, 16 (the depth is
  kept whole where halving would leave fewer than 8): each level in
  float64 against JAX's from the same inputs, and the whole f64 pipeline;
  then ``demons_register`` in f32 against JAX's (one level, one JAX
  compile), each side held to the float64 result by its own distance (the
  port's f32 within F32_TOL of it; the port within JAX's own distance plus
  F32_TOL of JAX).
- The device rule: with no card and no ``device``, the registrar and
  ``align_patient``'s demons path raise.

JAX's ``smooth3d`` refuses float64 (``conv_general_dilated`` of f64 data
with its f32 taps), so the float64 checks widen JAX's taps to f64 in this
process only (``_jax_x64``); the values are the same f32 taps. Each JAX
level shape is compiled once per dtype, through module-scoped fixtures.
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ctagan_tpu.ops import registration3d as jreg
from ctagan_tpu_torch.data.dicom import make_ct_slice, write_dicom
from ctagan_tpu_torch.data.registration import align_patient
from ctagan_tpu_torch.ops import registration3d as reg

torch.set_num_threads(2)

F64_TOL = 1e-9   # float64 on both sides: the same arithmetic, summed apart
F32_TOL = 1e-5   # voxels: the port's f32 φ from float64 (measured ~1e-7)
LEVEL_ARGS = dict(sigma_w=3.0, sigma_diff=1.0, lam_rel=0.02, lam_abs=0.02,
                  step_cap=0.5, n_squarings=4)
SHAPE = (16, 32, 32)
ITERS = (4, 4, 4)


@contextlib.contextmanager
def _jax_x64():
    """JAX in float64, its Gaussian taps widened to f64 (same values)."""
    taps = jreg.gaussian_kernel1d
    jax.config.update("jax_enable_x64", True)
    jreg.gaussian_kernel1d = lambda s: taps(s).astype(np.float64)
    try:
        yield
    finally:
        jreg.gaussian_kernel1d = taps
        jax.config.update("jax_enable_x64", False)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=F64_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(1.0, np.abs(want).max()), err


def _blobs_pair(shape, seed=0, n=12):
    """Smooth blobs (z extent 2-4 slices, radii 3-8 voxels) and the same
    anatomy under a sine deformation of 2 and 1.5 voxels, f32-valued."""
    D, H, W = shape
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.meshgrid(np.arange(D), np.arange(H), np.arange(W),
                             indexing="ij")
    params = [(rng.uniform(0, D), rng.uniform(H * 0.15, H * 0.85),
               rng.uniform(W * 0.15, W * 0.85), rng.uniform(3, 8),
               rng.uniform(0.3, 1.0), rng.uniform(2.0, 4.0))
              for _ in range(n)]

    def anatomy(z, y, x):
        out = np.zeros(z.shape)
        for cz, cy, cx, s, a, sz in params:
            out += a * np.exp(-(((z - cz) / sz) ** 2 + ((y - cy) / s) ** 2
                                + ((x - cx) / s) ** 2) / 2)
        return out

    dy = 2.0 * np.sin(2 * np.pi * yy / H) * np.cos(2 * np.pi * xx / W)
    dx = 1.5 * np.cos(2 * np.pi * yy / H) * np.sin(2 * np.pi * xx / W)
    fixed = anatomy(zz, yy, xx) * 1500 + 200
    moving = anatomy(zz, yy + dy, xx + dx) * 1500 + 280
    return fixed.astype(np.float32), moving.astype(np.float32)


# ---------------------------------------------------------------------------
# function by function, float64
# ---------------------------------------------------------------------------

SMOOTH_CASES = {
    "volume-s1": ((6, 12, 14), 1.0),
    "field6-s1": ((6, 12, 14, 6), 1.0),
    # radius 9 on a 5-slice axis: the edge pad is wider than the axis
    "volume-short5-s3": ((5, 12, 14), 3.0),
    "field6-short5-s3": ((5, 6, 7, 6), 3.0),
}
FLOWS = ("zero", "integer", "fractional", "out_of_range")
RESIZE_CASES = {
    "down": ((7, 15, 21), (3, 7, 10)),
    "up": ((4, 8, 10), (8, 16, 20)),
    "depth-kept": ((16, 8, 8), (16, 16, 16)),
    "field-depth-halved": ((16, 8, 8, 3), (8, 16, 16, 3)),
}


def _flow(kind, shape, rng):
    if kind == "zero":
        return np.zeros(shape + (3,))
    if kind == "integer":
        return np.round(rng.normal(size=shape + (3,)) * 2)
    if kind == "fractional":
        return rng.normal(size=shape + (3,)) * 1.5
    return rng.normal(size=shape + (3,)) * 40  # past every border


def _solve_inputs(case):
    rng = np.random.default_rng(6)
    shape = (4, 5, 6)
    b = rng.normal(size=shape + (3,))
    if case == "clamped":
        # diagonal, det = a·d·f ~ 1e-24 < 1e-20: the clamp caps 1/det, so
        # u = (1e-4·b0, 1e8·b1, 1e8·b2) up to the diagonal's spread
        T = np.zeros(shape + (6,))
        T[..., 0] = rng.uniform(0.5, 2.0, shape)
        T[..., 3] = rng.uniform(0.5, 2.0, shape) * 1e-12
        T[..., 5] = rng.uniform(0.5, 2.0, shape) * 1e-12
        return T, b, np.zeros(shape)
    J = rng.normal(size=shape + (3,))
    T = np.stack([J[..., 0] * J[..., 0], J[..., 0] * J[..., 1],
                  J[..., 0] * J[..., 2], J[..., 1] * J[..., 1],
                  J[..., 1] * J[..., 2], J[..., 2] * J[..., 2]], -1)
    return T, b, np.abs(rng.normal(size=shape)) * 0.1


def _jax_zscore(x):
    """JAX's demons_register normalization (jnp.std is the population
    std)."""
    return (x - jnp.mean(x)) / jnp.maximum(jnp.std(x), 1e-6)


@pytest.fixture(scope="module")
def ref():
    """Every function-level case's inputs and JAX's float64 result, in one
    x64 session, each function jitted (one small program a shape)."""
    out = {}
    with _jax_x64():
        smooth = jax.jit(jreg.smooth3d, static_argnums=1)
        for case, (shape, sigma) in SMOOTH_CASES.items():
            x = np.random.default_rng(1).normal(size=shape)
            out["smooth", case] = x, smooth(jnp.asarray(x), sigma)
        warp = jax.jit(jreg.warp3d)
        for depth in (6, 1):
            rng = np.random.default_rng(2)
            shape = (depth, 10, 12)
            v = rng.normal(size=shape)
            for kind in FLOWS:
                d = _flow(kind, shape, rng)
                out["warp", kind, depth] = v, d, warp(jnp.asarray(v),
                                                      jnp.asarray(d))
        a, b = np.random.default_rng(3).normal(size=(2, 6, 10, 12, 3)) * 1.5
        compose = jreg.compose
        out["compose"] = a, b, jax.jit(compose)(a, b)
        # JAX's exp_field over its compose, jitted (compiled just above)
        jreg.compose = jax.jit(compose)
        try:
            out["exp"] = a, jreg.exp_field(jnp.asarray(a), 4)
        finally:
            jreg.compose = compose
        grad = jax.jit(jreg._grad3d)
        for depth in (6, 2, 1):
            v = np.random.default_rng(4).normal(size=(depth, 10, 12))
            out["grad", depth] = v, grad(jnp.asarray(v))
        resize = jax.jit(jreg._resize, static_argnums=1)
        for case, (src, dst) in RESIZE_CASES.items():
            v = np.random.default_rng(5).normal(size=src)
            out["resize", case] = v, resize(jnp.asarray(v), dst)
        solve = jax.jit(jreg._solve3x3)
        for case in ("spd", "clamped"):
            T, b, damp = _solve_inputs(case)
            out["solve", case] = (T, b, damp), solve(T, b, damp)
        x = np.random.default_rng(7).normal(size=(2, 2, 2)) * 5 + 3
        out["zscore"] = x, jax.jit(_jax_zscore)(x)
        out = {k: v[:-1] + (np.asarray(v[-1]),) for k, v in out.items()}
    return out


def test_gaussian_taps_equal_jax():
    for sigma in (1.0, 3.0, 0.4):
        np.testing.assert_array_equal(reg.gaussian_kernel1d(sigma),
                                      jreg.gaussian_kernel1d(sigma))


@pytest.mark.parametrize("case", list(SMOOTH_CASES))
def test_smooth3d_matches_jax(ref, case):
    x, want = ref["smooth", case]
    _close(reg.smooth3d(_t(x), SMOOTH_CASES[case][1]), want)


def test_edge_pad_wider_than_axis_is_jnp_edge_pad():
    """One row of 5 padded by 9 a side: picking single samples out of the
    padded row with one-hot taps gives jnp.pad(mode="edge")'s row (a pad of
    reflected, wrapped or zero samples fails)."""
    row = np.array([3.0, -1.0, 4.0, 1.0, -5.0])
    taps = np.zeros(19, np.float32)
    for j in (0, 4, 9, 14, 18):
        taps[:] = 0
        taps[j] = 1
        got = reg._conv_axis(_t(row), taps, 0)
        want = np.asarray(jnp.pad(jnp.asarray(row), 9, mode="edge"))
        np.testing.assert_array_equal(got.numpy(), want[j:j + 5])


@pytest.mark.parametrize("kind", FLOWS)
@pytest.mark.parametrize("depth", [6, 1])
def test_warp3d_matches_jax(ref, kind, depth):
    v, d, want = ref["warp", kind, depth]
    _close(reg.warp3d(_t(v), _t(d)), want)
    if kind == "zero":
        _close(reg.warp3d(_t(v), _t(d)), v)


def test_compose_and_exp_field_match_jax(ref):
    a, b, want = ref["compose"]
    _close(reg.compose(_t(a), _t(b)), want)
    a, want = ref["exp"]
    _close(reg.exp_field(_t(a), 4), want)


@pytest.mark.parametrize("depth", [6, 2, 1])
def test_grad3d_matches_jax(ref, depth):
    v, want = ref["grad", depth]
    got = reg._grad3d(_t(v))
    _close(got, want)
    if depth == 1:
        assert not got[..., 0].any()


def test_resize_downsample_antialiases_as_jax():
    x = np.arange(8.0) ** 2
    got = reg._resize(_t(x), (4,))
    np.testing.assert_allclose(got.numpy(), [1.0, 7.0, 21.0, 40.0])
    plain = F.interpolate(_t(x)[None, None], size=4, mode="linear",
                          align_corners=False)[0, 0]
    np.testing.assert_allclose(plain.numpy(), [0.5, 6.5, 20.5, 42.5])


@pytest.mark.parametrize("case", list(RESIZE_CASES))
def test_resize_matches_jax(ref, case):
    v, want = ref["resize", case]
    _close(reg._resize(_t(v), RESIZE_CASES[case][1]), want)


@pytest.mark.parametrize("case", ["spd", "clamped"])
def test_solve3x3_matches_jax(ref, case):
    (T, b, damp), want = ref["solve", case]
    got = reg._solve3x3(_t(T), _t(b), _t(damp))
    _close(got, want)
    if case == "clamped":
        a, d, f = T[..., 0], T[..., 3], T[..., 5]
        cap = 1e20 * np.stack([d * f * b[..., 0], a * f * b[..., 1],
                               a * d * b[..., 2]], -1)
        np.testing.assert_allclose(got.numpy(), cap, rtol=1e-12)


def test_zscore_is_population_std(ref):
    """On 8 voxels the sample std (n − 1) is 7 % off: the registrar
    normalizes as JAX does."""
    x, want = ref["zscore"]
    _close(reg._zscore(_t(x)), want)


def test_level_shapes_keep_jax_depth_rule():
    assert reg._level_shapes((16, 32, 32), 3) == [(16, 8, 8), (8, 16, 16),
                                                  (16, 32, 32)]
    assert reg._level_shapes((128, 512, 512), 3) == [
        (32, 128, 128), (64, 256, 256), (128, 512, 512)]
    assert reg._level_shapes((5, 12, 12), 3) == [(5, 4, 4), (5, 6, 6),
                                                 (5, 12, 12)]


# ---------------------------------------------------------------------------
# the pyramid
# ---------------------------------------------------------------------------

def _jax_walk(fixed, moving, iters):
    """JAX's demons_register body in the inputs' dtype (JAX's own fixes
    f32): each level's inputs and output."""
    fixed = _jax_zscore(jnp.asarray(fixed))
    moving = _jax_zscore(jnp.asarray(moving))
    D, H, W = fixed.shape
    shapes = []
    for lv in range(len(iters)):
        f = 2 ** lv
        shapes.append((max(D // f if D // f >= 8 else D, 1),
                       max(H // f, 4), max(W // f, 4)))
    shapes = shapes[::-1]
    phi = jnp.zeros(shapes[0] + (3,), fixed.dtype)
    levels = []
    for lv, shp in enumerate(shapes):
        f_l = jreg._resize(fixed, shp)
        m_l = jreg._resize(moving, shp)
        prev = phi
        if phi.shape[:3] != shp:
            ratio = jnp.asarray([shp[i] / phi.shape[i] for i in range(3)],
                                jnp.float32)
            phi = jreg._resize(phi, shp + (3,)) * ratio
        phi_in = phi
        phi = jreg._demons_level(f_l, m_l, phi, iters=int(iters[lv]),
                                 **LEVEL_ARGS)
        levels.append({k: np.asarray(v) for k, v in dict(
            f_l=f_l, m_l=m_l, prev=prev, phi_in=phi_in, phi=phi).items()})
    return levels


@pytest.fixture(scope="module")
def pyramid():
    fixed, moving = _blobs_pair(SHAPE)
    with _jax_x64():
        levels = _jax_walk(fixed.astype(np.float64),
                           moving.astype(np.float64), ITERS)
    return fixed, moving, levels


@pytest.mark.parametrize("lv", [0, 1, 2])
def test_pyramid_level_matches_jax_float64(pyramid, lv):
    """Level ``lv`` from JAX's inputs: the resized volumes, the field
    carried over from the level before (resized and rescaled by the shape
    ratio: 16 → 8 → 16 slices), the level's iterations."""
    fixed, moving, levels = pyramid
    level = levels[lv]
    shp = level["f_l"].shape
    fz = reg._zscore(_t(fixed).double())
    _close(reg._resize(fz, shp), level["f_l"])
    if lv > 0:
        prev = level["prev"]
        ratio = torch.tensor([shp[i] / prev.shape[i] for i in range(3)],
                             dtype=torch.float32).double()
        _close(reg._resize(_t(prev), shp + (3,)) * ratio, level["phi_in"])
    got = reg._demons_level(_t(level["f_l"]), _t(level["m_l"]),
                            _t(level["phi_in"]), iters=ITERS[lv],
                            **LEVEL_ARGS)
    _close(got, level["phi"])


@pytest.fixture(scope="module")
def port_f64(pyramid):
    fixed, moving, _ = pyramid
    return reg._register(_t(fixed).double(), _t(moving).double(), 3, ITERS,
                         **LEVEL_ARGS).numpy()


def test_pyramid_whole_matches_jax_float64(pyramid, port_f64):
    _close(port_f64, pyramid[2][-1]["phi"])
    assert np.abs(port_f64).max() > 0.5  # the registrar moved


def test_demons_register_f32_matches_jax(pyramid):
    """The whole ``demons_register`` in f32 on both sides, at one level of 8
    iterations on the full 16 × 32 × 32 (one JAX compile; the pyramid is
    held in float64 above, and in f32 through ``align_patient`` in
    ``test_torch_port_corpus.py``), each side against the port's float64
    run (which equals JAX's float64 to F64_TOL, above): the port within
    F32_TOL of it, and within JAX's own f32 distance plus F32_TOL of JAX."""
    fixed, moving, _ = pyramid
    ref64 = reg._register(_t(fixed).double(), _t(moving).double(), 1, (8,),
                          **LEVEL_ARGS).numpy()
    got = reg.demons_register(fixed, moving, levels=1, iters=(8,),
                              device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy().astype(np.float64)
    want = np.asarray(jreg.demons_register(fixed, moving, levels=1,
                                           iters=(8,)))
    assert want.dtype == np.float32
    own = np.abs(got - ref64).max()
    jax_own = np.abs(want - ref64).max()
    assert np.abs(ref64).max() > 0.5  # the registrar moved
    assert own <= F32_TOL, own
    assert np.abs(got - want).max() <= jax_own + F32_TOL, (own, jax_own)
    print(f"f32 from float64: port {own:.3e}, JAX {jax_own:.3e} voxels")


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------

def test_registrar_needs_a_card_unless_told(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path cannot be reached")
    vol = np.zeros((2, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reg.demons_register(vol, vol)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        reg.demons_register(vol, vol, device="cuda")
    # align_patient's demons path (no ants here) reaches the same rule
    rng = np.random.default_rng(8)
    for se in ("SE0", "SE1"):
        d = tmp_path / "pat0" / "ST0" / se
        os.makedirs(d)
        for s in range(5):
            write_dicom(make_ct_slice(
                rng.integers(500, 2000, (8, 8)).astype(np.uint16),
                slice_location=float(s), series_uid="1.2." + se[-1]),
                str(d / f"IM{s}"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        align_patient(str(tmp_path), "pat0")
