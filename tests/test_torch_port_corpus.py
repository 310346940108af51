"""Parity: the port's offline corpus stage (``ctagan_tpu_torch/data/
corpus.py``, ``data/registration.py`` and the DICOM accessors they read)
against the JAX package's, on one seeded tree that JAX's writer built.

- One parametrised case per behaviour that ``tests/test_corpus.py`` covers:
  each runs JAX's function on a fresh copy of the tree, then the port's on
  another fresh copy at the same path, and compares what each returned,
  printed and left on disk (every file's bytes, moved or deleted files
  included): ``build_lists`` under each ``repair`` mode, ``collect_pairs``,
  ``repair_reference_tree``, ``patient_split``, ``statistic``,
  ``make_equip_split``, ``phase_correlation_shift``, the NIfTI-view round
  trip, ``_load_series`` beside a scout series, ``register_translation``,
  ``invert_lists``, and ``align_patient`` by translation, by SyN through a
  mock of antspyx (JAX's ``_MockAnts`` for JAX, a copy over the port's
  phase correlation for the port), and skipping a short series.
- The new DICOM accessors equal JAX's on every slice of the tree, and
  ``make_ct_slice``'s new keywords write JAX's bytes.
- The demons end to end at JAX's 64² × 8 (``tests/test_registration3d.py``'s
  deformed tree): the port on the CPU, JAX as it runs there; SE1's stored
  pixels within 1 unit of JAX's, and JAX's own bar (SE0 unchanged, the
  last slice unwarped, the interior error cut ≥ 4×).
- The CLI, ``python -m ctagan_tpu_torch.data.corpus``, in a fresh
  interpreter with ``jax``, ``flax`` and ``ctagan_tpu`` blocked: the lists,
  ``--stats``, ``--equip-split`` and ``--register`` against JAX's functions
  on the same tree.
"""
import contextlib
import dataclasses
import io
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ctagan_tpu.data import corpus as jax_corpus
from ctagan_tpu.data import dicom as jax_dicom
from ctagan_tpu.data import registration as jax_registration
from ctagan_tpu_torch.data import corpus, dicom, registration
from tests.test_corpus import _MockAnts
from tests.test_registration3d import _deformed_tree

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": SimpleNamespace(corpus=jax_corpus, reg=jax_registration),
        "port": SimpleNamespace(corpus=corpus, reg=registration)}
SIZE = 16


def _mock_ants(shift_fn):
    """A copy of ``tests/test_corpus.py::_MockAnts`` over the given phase
    correlation: 'SyN' is the exact rigid alignment it finds."""

    class Image:
        def __init__(self, arr):
            self.arr = np.asarray(arr)

        def numpy(self):
            return self.arr

    class MockAnts:
        calls = []

        @staticmethod
        def from_numpy(a):
            return Image(a)

        @staticmethod
        def registration(fixed, moving, type_of_transform):
            assert type_of_transform == "SyN"
            shift = shift_fn(fixed.arr, moving.arr)
            MockAnts.calls.append(("registration", tuple(shift)))
            return {"fwdtransforms": [tuple(int(s) for s in shift)]}

        @staticmethod
        def apply_transforms(fixed, moving, transformlist,
                             interpolator="linear"):
            assert interpolator == "linear"
            (shift,) = transformlist
            return Image(np.roll(moving.arr, shift, axis=(0, 1, 2)))

    return MockAnts


MOCKS = {"jax": _MockAnts,
         "port": _mock_ants(registration.phase_correlation_shift)}


# ---------------------------------------------------------------------------
# the tree, written by JAX's codec
# ---------------------------------------------------------------------------

def _write(root, pat, se, name, px, **kw):
    d = os.path.join(root, pat, "ST0", se)
    os.makedirs(d, exist_ok=True)
    jax_dicom.write_dicom(jax_dicom.make_ct_slice(px, **kw),
                          os.path.join(d, name))


def _pairs(root, rng, pat, n, pid, manu="GE MEDICAL SYSTEMS", sex="M",
           age="060Y", se1=None, tweak=None):
    """``n`` NCCT/CTA slice pairs; ``se1`` SE1 files (default ``n``);
    ``tweak(se, i, kw)`` edits one slice's header keywords."""
    for se, count in (("SE0", n), ("SE1", n if se1 is None else se1)):
        for i in range(count):
            kw = dict(series_description="C-" if se == "SE0" else "C+",
                      patient_id=pid, accession="A" + pid,
                      slice_location=float(i), manufacturer=manu, sex=sex,
                      age=age, series_uid=f"1.2.{pid}.{se[-1]}")
            if tweak:
                tweak(se, i, kw)
            px = (rng.integers(900, 1300, (SIZE, SIZE))
                  + (300 if se == "SE1" else 0)).astype(np.uint16)
            _write(root, pat, se, f"IM{i}", px, **kw)


def _patterned(root, rng, pat, pid, slices, shift, offset):
    """SE1 = the SE0 pattern shifted in-plane plus a contrast offset (a
    wrap-free ground truth for the rigid and mock-SyN alignments)."""
    base = [rng.integers(200, 3000, (SIZE, SIZE)).astype(np.uint16)
            for _ in range(slices)]
    for se in ("SE0", "SE1"):
        for s in range(slices):
            px = base[s]
            if se == "SE1":
                px = np.roll(px, shift, axis=(0, 1)) + offset
            _write(root, pat, se, f"IM{s}", px.astype(np.uint16),
                   series_description="C-" if se == "SE0" else "C+",
                   patient_id=pid, accession="A" + pid,
                   slice_location=float(s), series_uid=f"1.2.{pid}.{se[-1]}")


def _build_tree(root):
    rng = np.random.default_rng(0)
    _pairs(root, rng, "pat0", 4, "P0", sex="F", age="045Y")

    def swapped(se, i, kw):  # the CTA filed in SE0 on IM0
        if i == 0:
            kw["series_description"] = "C+" if se == "SE0" else "C-"
    _pairs(root, rng, "pat1", 2, "P1", manu="SIEMENS", age="070Y",
           tweak=swapped)

    def filters(se, i, kw):  # IM1: accession mismatch; IM2: both "C+"
        if i == 1 and se == "SE1":
            kw["accession"] = "OTHER"
        if i == 2:
            kw["series_description"] = "C+"
    _pairs(root, rng, "pat2", 3, "P2", manu="Philips", sex="F", age="052Y",
           tweak=filters)

    def location_intercept(se, i, kw):  # IM0 location, IM1 intercept
        if i == 0 and se == "SE1":
            kw["slice_location"] = 99.0
        if i == 1 and se == "SE0":
            kw["rescale_intercept"] = -1000.0
    _pairs(root, rng, "pat3", 2, "P3", age="033Y", tweak=location_intercept)
    _pairs(root, rng, "pat4", 2, "P0")  # pat0's PatientID again
    _pairs(root, rng, "pat5", 4, "P5", se1=2)  # 4 % 2 == 0: series swap
    _pairs(root, rng, "pat6", 3, "P6", se1=2)  # 3 vs 2: removed
    _pairs(root, rng, "pat7", 2, "P7")
    os.makedirs(os.path.join(root, "pat7", "ST0", "SE2"))
    with open(os.path.join(root, "pat7", "ST0", "SE2", "IM0"), "wb") as f:
        f.write(b"stale synthesis output")
    shutil.copy(os.path.join(root, "pat7", "ST0", "SE1", "IM0"),
                os.path.join(root, "pat7", "ST0", "SE1", "IM9"))
    _pairs(root, rng, "pat8", 2, "P8", manu="SIEMENS", age="")
    _pairs(root, rng, "pat9", 2, "P9", manu="Philips", sex="F")
    _patterned(root, rng, "regA", "RA", 6, (2, 3), 100)
    # a one-slice scout with its own SeriesInstanceUID beside regA's NCCT
    _write(root, "regA", "SE0", "IM99", np.zeros((SIZE, SIZE), np.uint16),
           patient_id="RA", accession="ARA", slice_location=-50.0,
           series_uid="9.9.9")
    _patterned(root, rng, "regB", "RB", 6, (5, -3), 0)
    _patterned(root, rng, "regC", "RC", 3, (2, 3), 100)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus_src") / "tree")
    _build_tree(root)
    return root


def _snapshot(root):
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            with open(os.path.join(d, n), "rb") as f:
                files[os.path.relpath(os.path.join(d, n), root)] = f.read()
    return files


def _plain(x):
    """Results in comparable form: dataclasses as dicts, arrays as lists."""
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tolist())
    if isinstance(x, (tuple, list)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _list_of(root, pats, name):
    paths = [os.path.join(root, p, "ST0", "SE0", f)
             for p in pats
             for f in sorted(os.listdir(os.path.join(root, p, "ST0", "SE0")))
             if f != "IM99"]
    lp = os.path.join(root, name)
    with open(lp, "w") as f:
        f.write("\n".join(paths) + "\n")
    return lp


def _case_build_lists(mode):
    def run(side, pkg, root, out):
        return pkg.corpus.build_lists(root, out, seed=3, repair=mode)
    return run


def _case_collect_pairs(side, pkg, root, out):
    stats = pkg.corpus.CorpusStats()
    return pkg.corpus.collect_pairs(root, stats), stats


def _case_repair_reference(side, pkg, root, out):
    return pkg.corpus.repair_reference_tree(root)


def _case_patient_split(side, pkg, root, out):
    rng = np.random.default_rng(4)
    by = {f"P{i}": [f"/x/p{i}/IM{j}" for j in range(rng.integers(1, 4))]
          for i in range(11)}
    return [pkg.corpus.patient_split(by, seed=s) for s in range(4)]


def _case_statistic(side, pkg, root, out):
    lp = _list_of(root, ["pat0", "pat1", "pat2", "pat8", "pat9"], "l.txt")
    return pkg.corpus.statistic(lp)


def _case_equip_split(side, pkg, root, out):
    lp = _list_of(root, ["pat0", "pat1", "pat2", "pat8", "pat9"], "l.txt")
    return pkg.corpus.make_equip_split(lp, out)


def _case_phase_correlation(side, pkg, root, out):
    vol = np.random.default_rng(2).uniform(0, 1, (8, 32, 32))
    shifted = np.roll(vol, (1, 3, -2), axis=(0, 1, 2))
    return pkg.reg.phase_correlation_shift(vol, shifted)


def _case_nii_view(side, pkg, root, out):
    v = np.random.default_rng(5).normal(size=(5, 7, 9)).astype(np.float32)
    nii = pkg.reg.dicom_to_nii(v)
    return nii.copy(), pkg.reg.nii_to_dicom(nii).copy()


def _case_load_series(side, pkg, root, out):
    vol, paths = pkg.reg._load_series(os.path.join(root, "regA", "ST0",
                                                   "SE0"))
    return vol, paths


def _case_register_translation(side, pkg, root, out):
    return pkg.reg.register_translation(root, "regB")


def _case_invert_lists(side, pkg, root, out):
    return pkg.reg.invert_lists(_list_of(root, ["regA"], "inv.txt"))


def _case_align_translation(side, pkg, root, out):
    return pkg.reg.align_patient(root, "regB", method="translation")


def _case_align_syn_mock(side, pkg, root, out):
    mock = MOCKS[side]
    mock.calls.clear()
    return pkg.reg.align_patient(root, "regA", ants_module=mock), mock.calls


def _case_register_syn_mock(side, pkg, root, out):
    return pkg.reg.register_syn(root, "regA", ants_module=MOCKS[side])


def _case_align_skip(side, pkg, root, out):
    return pkg.reg.align_patient(root, "regC", ants_module=MOCKS[side])


CASES = {
    "build_lists-slice": _case_build_lists(True),
    "build_lists-off": _case_build_lists(False),
    "build_lists-reference": _case_build_lists("reference"),
    "collect_pairs": _case_collect_pairs,
    "repair_reference_tree": _case_repair_reference,
    "patient_split": _case_patient_split,
    "statistic": _case_statistic,
    "make_equip_split": _case_equip_split,
    "phase_correlation_shift": _case_phase_correlation,
    "nii_view_round_trip": _case_nii_view,
    "load_series_longest": _case_load_series,
    "register_translation": _case_register_translation,
    "invert_lists": _case_invert_lists,
    "align_patient-translation": _case_align_translation,
    "align_patient-syn_mock": _case_align_syn_mock,
    "register_syn-mock": _case_register_syn_mock,
    "align_patient-skip_short": _case_align_skip,
}


def _run_side(side, case, tree, work):
    root, out = os.path.join(work, "tree"), os.path.join(work, "out")
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(tree, root)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        result = CASES[case](side, PKGS[side], root, out)
    return _plain(result), printed.getvalue(), _snapshot(work)


@pytest.mark.parametrize("case", list(CASES))
def test_corpus_case_matches_jax(case, tree, tmp_path):
    work = str(tmp_path / "work")
    want = _run_side("jax", case, tree, work)
    got = _run_side("port", case, tree, work)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert sorted(got[2]) == sorted(want[2])
    changed = [k for k in want[2] if got[2][k] != want[2][k]]
    assert not changed, changed[:5]


def test_cases_change_the_tree(tree, tmp_path):
    """The cases above reach their repairs and writebacks: the reference
    mode moves and deletes, the slice mode swaps, the alignments rewrite
    SE1 (a comparison of two untouched trees would pass vacuously)."""
    before = _snapshot(tree)
    work = str(tmp_path / "work")
    for case, check in (
            ("build_lists-reference", lambda a: "pat6/ST0/SE0/IM0" not in a
             and "pat7/ST0/SE2/IM0" not in a),
            ("build_lists-slice", lambda a: a["pat1/ST0/SE0/IM0"]
             == before["pat1/ST0/SE1/IM0"]),
            ("align_patient-syn_mock", lambda a: a["regA/ST0/SE1/IM0"]
             != before["regA/ST0/SE1/IM0"]),
            ("align_patient-skip_short", lambda a: all(
                a[k] == before[k] for k in before if k.startswith("regC")))):
        snap = _run_side("port", case, tree, work)[2]
        after = {os.path.relpath(k, "tree"): v for k, v in snap.items()
                 if k.startswith("tree")}
        assert check(after), case


ACCESSORS = ("rescale_intercept", "rescale_slope", "series_description",
             "patient_id", "accession_number", "slice_location", "hu_array")


@pytest.mark.parametrize("name", ACCESSORS)
def test_accessor_reads_as_jax_on_every_slice(name, tree):
    paths = [os.path.join(d, n) for d, _, ns in os.walk(tree) for n in ns
             if n.startswith("IM") and "SE2" not in d]
    assert len(paths) > 80
    for p in paths:
        want = getattr(jax_dicom.read_dicom(p), name)
        got = getattr(dicom.read_dicom(p), name)
        if name == "hu_array":
            want, got = want(), got()
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want and type(got) is type(want), (p, got, want)


def test_make_ct_slice_keywords_write_jax_bytes():
    px = np.random.default_rng(9).integers(0, 4095, (8, 12)).astype(np.uint16)
    kw = dict(series_uid="1.2.3.9", manufacturer="SIEMENS", sex="F",
              age="071Y", wc=300.0, ww=1500.0, rescale_intercept=-1000.0,
              slice_location=2.5, series_description="C+", patient_id="Q",
              accession="B7")
    got, want = dicom.make_ct_slice(px, **kw), jax_dicom.make_ct_slice(
        px, **kw)
    for ds in (got, want):  # the generated SOP instance UID
        ds.set_str(dicom.TAG_SOP_INSTANCE, "1.2.3.7", b"UI")
    assert dicom.dicom_bytes(got) == jax_dicom.dicom_bytes(want)


# ---------------------------------------------------------------------------
# the demons end to end, JAX's 64² × 8
# ---------------------------------------------------------------------------

def test_align_patient_demons_matches_jax(tmp_path):
    src = str(tmp_path / "src")
    fixed, moving = _deformed_tree(src)
    runs = {}
    for side, kw in (("jax", {}), ("port", {"device": "cpu"})):
        root = str(tmp_path / side)
        shutil.copytree(src, root)
        assert PKGS[side].reg.align_patient(root, "pat0", **kw) == "demons"
        runs[side] = [registration._load_series(
            os.path.join(root, "pat0", "ST0", se))[0] for se in ("SE0",
                                                                 "SE1")]
    se0, se1 = runs["port"]
    assert np.abs(se1 - runs["jax"][1]).max() <= 1.0
    np.testing.assert_array_equal(se0, runs["jax"][0])
    # JAX's own bar: SE0 unchanged, the deformation removed
    np.testing.assert_array_equal(
        se0, np.clip(fixed, 0, 4095).astype(np.int64) - 1024)
    target = (fixed + 80.0 - 1024.0)[:-1, 4:-4, 4:-4]
    before = np.abs((moving - 1024.0)[:-1, 4:-4, 4:-4] - target).mean()
    after = np.abs(se1[:-1, 4:-4, 4:-4] - target).mean()
    assert after < before / 4, (before, after)
    # the reference's unwarped last slice
    np.testing.assert_allclose(se1[-1], np.clip(moving[-1], 0, 4095)
                               - 1024.0, atol=1.0)


# ---------------------------------------------------------------------------
# the CLI, without JAX
# ---------------------------------------------------------------------------

def _cli(args, cwd):
    code = ("import sys\n"
            "for m in ('jax', 'flax', 'ctagan_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import runpy\n"
            "sys.argv = ['corpus'] + sys.argv[1:]\n"
            "runpy.run_module('ctagan_tpu_torch.data.corpus', "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH", "")) if p))
    res = subprocess.run([sys.executable, "-c", code] + args, cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


@pytest.mark.parametrize("mode", ["lists", "stats", "equip-split",
                                  "register"])
def test_corpus_cli_without_jax(mode, tree, tmp_path):
    work = str(tmp_path / "work")
    root, out = os.path.join(work, "tree"), os.path.join(work, "out")
    outputs = {}
    for side in ("jax", "port"):
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(tree, root)
        lp = _list_of(root, ["pat0", "pat1", "pat2", "pat8", "pat9"],
                      "l.txt")
        if side == "port":
            args = {"lists": [root, "--out", out, "--seed", "2"],
                    "stats": [lp, "--stats"],
                    "equip-split": [lp, "--equip-split", "--out", out],
                    "register": [root, "--register", "regB"]}[mode]
            printed = _cli(args, work)
        else:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                if mode == "lists":
                    jax_corpus.build_lists(root, out, seed=2)
                elif mode == "stats":
                    st = jax_corpus.statistic(lp)
                    mean_age = f"{sum(st.ages) / len(st.ages):.1f}"
                    print(f"patients {st.patients}, slices {st.slices}, "
                          f"by_vendor {st.by_manufacturer}, by_sex "
                          f"{st.by_sex}, mean_age {mean_age}")
                elif mode == "equip-split":
                    print(jax_corpus.make_equip_split(lp, out))
                else:
                    print("shift:", jax_registration.register_translation(
                        root, "regB"))
            printed = buf.getvalue()
        outputs[side] = printed, _snapshot(work)
    assert outputs["port"][0] == outputs["jax"][0]
    assert outputs["port"][1] == outputs["jax"][1]
    if mode == "lists":  # complete, paired, patient-disjoint lists
        lists = {n: [p for p in open(os.path.join(out, f"{n}.txt"))
                     .read().split("\n") if p]
                 for n in ("train", "val", "test")}
        pats = {n: {p.split(os.sep)[-4] for p in ps}
                for n, ps in lists.items()}
        assert all(os.path.exists(p) and os.path.exists(
            p.replace("SE0", "SE1")) for ps in lists.values() for p in ps)
        assert not (pats["train"] & pats["val"] or pats["train"]
                    & pats["test"] or pats["val"] & pats["test"])
