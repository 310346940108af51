"""Offline corpus construction of the port (``ctagan_tpu/data/corpus.py``):
walk a hospital DICOM tree into the ``train``/``val``/``test`` list files
every trainer reads, in numpy and the standard library (no torch).

- walk ``root/<patient>/ST*/{SE0,SE1}/IM*``, pairing NCCT (SE0) with CTA
  (SE1);
- repair swapped pairs by the SeriesDescription contrast marker (the CTA
  says "C+"): a pair whose SE0 looks contrasted and SE1 not is swapped on
  disk;
- integrity filters: RescaleIntercept must be -1024, paired slices must
  agree on AccessionNumber and SliceLocation;
- de-dup by PatientID and a 60/20/20 patient split into the list files;
- demographics and vendor statistics, per-manufacturer test lists;
- ``repair='reference'``: the reference builder's destructive
  series-level repairs, opt-in, for a scratch copy of the tree.

Run as ``python -m ctagan_tpu_torch.data.corpus <root> --out <dir>`` (the
JAX package's flags: ``--seed``, ``--stats``, ``--equip-split``,
``--register``, ``--repair``). The deformable registration stage is
``ctagan_tpu_torch.data.registration.align_patient``.
"""
from __future__ import annotations

import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ctagan_tpu_torch.data.dicom import read_dicom


@dataclass
class CorpusStats:
    patients: int = 0
    slices: int = 0
    rejected_intercept: int = 0
    rejected_accession: int = 0
    rejected_location: int = 0
    rejected_contrast: int = 0  # reference mode: neither/both series "C+"
    swapped_pairs: int = 0
    # destructive series-level repairs (repair='reference' only)
    se2_purged: int = 0
    series_renamed: int = 0
    deleted_unmatched: int = 0
    removed_patient_dirs: int = 0
    by_manufacturer: Dict[str, int] = field(default_factory=dict)
    by_sex: Dict[str, int] = field(default_factory=dict)
    ages: List[int] = field(default_factory=list)


def _is_contrast(desc: str) -> bool:
    return "C+" in desc


def _slice_paths(series_dir: str) -> List[str]:
    if not os.path.isdir(series_dir):
        return []
    return sorted(
        os.path.join(series_dir, f)
        for f in os.listdir(series_dir)
        if f.startswith("IM")
    )


def repair_reference_tree(
    root: str, stats: Optional[CorpusStats] = None
) -> CorpusStats:
    """The reference builder's DESTRUCTIVE series-level repairs, faithful
    to data_process.py:36-60 (opt-in via ``collect_pairs(...,
    repair='reference')`` — the default per-slice mode never deletes):

    - SE2 purge: every ``ST*/SE2`` directory is rmtree'd before the walk
      (:36-39 — stale synthesis outputs from earlier runs);
    - count-mismatch series swap: when ``len(SE0) % len(SE1) == 0`` with
      differing counts, the whole SE0/SE1 directories swap via the SE33
      rename dance (:44-47 — the misfiled-series case where the thin-slice
      reconstruction landed in SE0);
    - unmatched-target deletion: any SE1 file whose same-named SE0 partner
      is missing is deleted (:48-52);
    - zero-file / still-mismatched patients: the whole patient directory
      is rmtree'd (:54-60).

    The duplicate-PatientID rmtree (:73-78) is header-driven and runs
    inside ``collect_pairs``'s walk under the same mode.
    """
    import shutil

    stats = stats if stats is not None else CorpusStats()
    for patient_dir in sorted(os.listdir(root)):
        pdir = os.path.join(root, patient_dir)
        if not os.path.isdir(pdir):
            continue
        removed = False
        for st in sorted(os.listdir(pdir)):
            se0 = os.path.join(pdir, st, "SE0")
            se1 = os.path.join(pdir, st, "SE1")
            se2 = os.path.join(pdir, st, "SE2")
            if os.path.isdir(se2):
                shutil.rmtree(se2)
                stats.se2_purged += 1
            if not (os.path.isdir(se0) and os.path.isdir(se1)):
                continue
            d0, d1 = os.listdir(se0), os.listdir(se1)
            if d0 and d1 and len(d1) != len(d0):
                if len(d0) % len(d1) == 0:
                    tmp = os.path.join(pdir, st, "SE33")
                    os.rename(se0, tmp)
                    os.rename(se1, se0)
                    os.rename(tmp, se1)
                    stats.series_renamed += 1
                for name in os.listdir(se1):
                    if not os.path.exists(os.path.join(se0, name)):
                        os.remove(os.path.join(se1, name))
                        stats.deleted_unmatched += 1
            if len(os.listdir(se0)) == 0 or (
                len(os.listdir(se1)) != len(os.listdir(se0))
            ):
                shutil.rmtree(pdir)
                stats.removed_patient_dirs += 1
                removed = True
                break
        if removed:
            continue
    return stats


def collect_pairs(
    root: str, stats: Optional[CorpusStats] = None, repair=True
) -> Dict[str, List[str]]:
    """Scan the tree; returns {patient_id: [valid SE0 slice paths]}.

    Applies the reference's pair-repair and integrity filters per slice.
    ``repair`` modes:

    - ``True`` (default, non-destructive beyond pair swaps): physically
      swaps misfiled slice pairs on disk (CTA found in SE0 <-> NCCT in
      SE1), matching the reference's file-move repair
      (data_process.py:89-98) — the list format encodes "A lives in SE0",
      so an in-memory swap alone would silently train with inverted roles.
    - ``False``: rejects swapped pairs instead of repairing.
    - ``'reference'``: full reference fidelity — runs the DESTRUCTIVE
      series-level repairs first (``repair_reference_tree``: SE2 purge,
      count-mismatch series rename, unmatched-file deletion, bad-patient
      rmtree), deletes duplicate-PatientID patient directories during the
      walk (data_process.py:73-78), and rejects pairs whose contrast
      markers are ambiguous (neither or both series "C+", :88-99) — the
      default mode keeps such pairs. Point this at a scratch COPY of the
      hospital tree, exactly as the reference expects.
    """
    import shutil

    stats = stats if stats is not None else CorpusStats()
    reference_mode = repair == "reference"
    if reference_mode:
        repair_reference_tree(root, stats)
    by_patient: Dict[str, List[str]] = {}
    pid_dir: Dict[str, str] = {}  # PatientID -> first patient dir seen
    for patient_dir in sorted(os.listdir(root)):
        pdir = os.path.join(root, patient_dir)
        if not os.path.isdir(pdir):
            continue
        for st in sorted(os.listdir(pdir)):
            se0_dir = os.path.join(pdir, st, "SE0")
            se1_dir = os.path.join(pdir, st, "SE1")
            slices0 = _slice_paths(se0_dir)
            if not slices0:
                continue
            kept: List[str] = []
            patient_id = None
            for p0 in slices0:
                p1 = p0.replace("SE0", "SE1")
                if not os.path.exists(p1):
                    continue
                try:
                    ds0 = read_dicom(p0)
                    ds1 = read_dicom(p1)
                except Exception:
                    continue
                # swapped-series repair: CTA ("C+") should live in SE1
                if _is_contrast(ds0.series_description) and not _is_contrast(
                    ds1.series_description
                ):
                    stats.swapped_pairs += 1
                    if not repair:
                        continue
                    tmp = p0 + ".swap"
                    shutil.move(p0, tmp)
                    shutil.move(p1, p0)
                    shutil.move(tmp, p1)
                    ds0, ds1 = ds1, ds0
                if reference_mode and not (
                    _is_contrast(ds1.series_description)
                    and not _is_contrast(ds0.series_description)
                ):
                    # reference: keep only clean NCCT->CTA markers; a pair
                    # where neither or both series say "C+" is skipped
                    # (data_process.py:88-99 else-branch)
                    stats.rejected_contrast += 1
                    continue
                if ds0.rescale_intercept != -1024.0:
                    stats.rejected_intercept += 1
                    continue
                if ds0.accession_number != ds1.accession_number:
                    stats.rejected_accession += 1
                    continue
                if ds0.slice_location != ds1.slice_location:
                    stats.rejected_location += 1
                    continue
                patient_id = patient_id or ds0.patient_id or patient_dir
                kept.append(p0)
                manu = (ds0.get_str((0x0008, 0x0070)) or "UNKNOWN").split()[0]
                stats.by_manufacturer[manu] = stats.by_manufacturer.get(manu, 0) + 1
                sex = ds0.get_str((0x0010, 0x0040)) or "?"
                stats.by_sex[sex] = stats.by_sex.get(sex, 0) + 1
                age = ds0.get_str((0x0010, 0x1010)) or ""
                if age and age[:-1].isdigit():
                    stats.ages.append(int(age[:-1]))
            if kept and patient_id:
                dup = (
                    patient_id in pid_dir
                    and pid_dir[patient_id] != patient_dir
                )
                if dup and reference_mode:
                    # duplicate PatientID under ANOTHER directory: the
                    # reference rmtree's the later occurrence
                    # (data_process.py:73-78)
                    shutil.rmtree(pdir)
                    stats.removed_patient_dirs += 1
                    break
                pid_dir.setdefault(patient_id, patient_dir)
                # patient-level de-dup: first occurrence wins
                if patient_id not in by_patient:
                    by_patient[patient_id] = kept
                    stats.patients += 1
                stats.slices += len(kept)
    return by_patient


def patient_split(
    by_patient: Dict[str, List[str]],
    fractions: Tuple[float, float, float] = (0.6, 0.2, 0.2),
    seed: int = 0,
) -> Tuple[List[str], List[str], List[str]]:
    """60/20/20 split at PATIENT granularity (never split a patient across
    sets — data_process.py:104-109)."""
    rng = np.random.default_rng(seed)
    pids = sorted(by_patient)
    rng.shuffle(pids)
    n = len(pids)
    n_train = int(n * fractions[0])
    n_val = int(n * fractions[1])
    groups = (
        pids[:n_train],
        pids[n_train : n_train + n_val],
        pids[n_train + n_val :],
    )
    return tuple([p for pid in g for p in by_patient[pid]] for g in groups)  # type: ignore[return-value]


def build_lists(
    root: str,
    out_dir: str,
    seed: int = 0,
    prefix: str = "",
    repair=True,
) -> Dict[str, str]:
    """End-to-end corpus build: scan, filter, split, write
    {train,val,test}.txt; returns the list paths + prints stats.
    ``repair``: True (default per-slice mode) | False | 'reference'
    (destructive series-level reference fidelity — see collect_pairs)."""
    stats = CorpusStats()
    by_patient = collect_pairs(root, stats, repair=repair)
    train, val, test = patient_split(by_patient, seed=seed)
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for name, paths in (("train", train), ("val", val), ("test", test)):
        lp = os.path.join(out_dir, f"{prefix}{name}.txt")
        with open(lp, "w") as f:
            f.write("\n".join(paths) + ("\n" if paths else ""))
        out[name] = lp
    print(
        f"corpus: {stats.patients} patients, {stats.slices} slices "
        f"(train {len(train)} / val {len(val)} / test {len(test)}); "
        f"rejected: intercept {stats.rejected_intercept}, "
        f"accession {stats.rejected_accession}, "
        f"location {stats.rejected_location}, "
        f"contrast {stats.rejected_contrast}; swapped {stats.swapped_pairs}"
        + (
            f"; reference repairs: se2 purged {stats.se2_purged}, "
            f"series renamed {stats.series_renamed}, unmatched deleted "
            f"{stats.deleted_unmatched}, patient dirs removed "
            f"{stats.removed_patient_dirs}"
            if repair == "reference"
            else ""
        )
    )
    return out


def statistic(list_file: str) -> CorpusStats:
    """Demographics + vendor stats over a list file (data_process.py:389-456)."""
    stats = CorpusStats()
    seen = set()
    with open(list_file) as f:
        for line in f:
            p = line.strip()
            if not p:
                continue
            ds = read_dicom(p)
            stats.slices += 1
            pid = ds.patient_id
            if pid not in seen:
                seen.add(pid)
                stats.patients += 1
                sex = ds.get_str((0x0010, 0x0040)) or "?"
                stats.by_sex[sex] = stats.by_sex.get(sex, 0) + 1
                age = ds.get_str((0x0010, 0x1010)) or ""
                if age and age[:-1].isdigit():
                    stats.ages.append(int(age[:-1]))
            manu = (ds.get_str((0x0008, 0x0070)) or "UNKNOWN").split()[0]
            stats.by_manufacturer[manu] = stats.by_manufacturer.get(manu, 0) + 1
    return stats


def make_equip_split(list_file: str, out_dir: str) -> Dict[str, str]:
    """Per-manufacturer (GE/SIEMENS/Philips/...) test lists
    (data_process.py:459-505)."""
    groups: Dict[str, List[str]] = defaultdict(list)
    with open(list_file) as f:
        for line in f:
            p = line.strip()
            if not p:
                continue
            ds = read_dicom(p)
            manu = (ds.get_str((0x0008, 0x0070)) or "UNKNOWN").split()[0].upper()
            groups[manu].append(p)
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for manu, paths in groups.items():
        lp = os.path.join(out_dir, f"test_{manu.lower()}.txt")
        with open(lp, "w") as f:
            f.write("\n".join(paths) + "\n")
        out[manu] = lp
    return out


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Corpus engineering CLI")
    ap.add_argument("root", help="DICOM tree root (or a list file for "
                    "--stats/--equip-split)")
    ap.add_argument("--out", default="./data", help="output dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stats", action="store_true",
                    help="print demographics/vendor stats for a list file")
    ap.add_argument("--equip-split", action="store_true",
                    help="write per-manufacturer test lists for a list file")
    ap.add_argument("--register", metavar="PATIENT",
                    help="rigid-align a patient's CTA onto the NCCT in-place")
    ap.add_argument("--repair", choices=["slice", "off", "reference"],
                    default="slice",
                    help="repair mode: 'slice' (default; pair swaps only), "
                    "'off', or 'reference' (DESTRUCTIVE reference-fidelity "
                    "series repairs — run on a scratch copy)")
    args = ap.parse_args()
    if args.stats:
        st = statistic(args.root)
        mean_age = f"{sum(st.ages)/len(st.ages):.1f}" if st.ages else "n/a"
        print(
            f"patients {st.patients}, slices {st.slices}, "
            f"by_vendor {st.by_manufacturer}, by_sex {st.by_sex}, "
            f"mean_age {mean_age}"
        )
    elif args.equip_split:
        print(make_equip_split(args.root, args.out))
    elif args.register:
        from ctagan_tpu_torch.data.registration import register_translation

        print("shift:", register_translation(args.root, args.register))
    else:
        mode = {"slice": True, "off": False, "reference": "reference"}[
            args.repair
        ]
        build_lists(args.root, args.out, seed=args.seed, repair=mode)
