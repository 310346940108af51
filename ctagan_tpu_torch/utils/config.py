"""The port's config: the fields the serving path and the trainers
(pix2pix, CycleGAN, RegGAN, HD stage 1 and stage 2, the 3-D P3d) read, from
the same ``configs/*.yaml`` files as ``ctagan_tpu/utils/config.py``, with
the same defaults and validation.

The repo's configs are flat ``key: value`` YAML. This reader parses that
subset without PyYAML (scalars: quoted or bare strings, ints, floats,
booleans, null; ``#`` comments), plus one-level maps of ints in both forms
PyYAML reads (``mesh: {dp: 2}``, and ``mesh:`` followed by indented ``dp:
2`` lines), and rejects any line it cannot parse, such as deeper maps,
lists or other flow collections. Keys that are not fields land in
``extras``, as in the JAX package (``serve_port``, ``serve_quantize``,
``max_batch`` and stage 2's ``num_d`` and ``pyramid`` are read from there).

``mesh`` (the parallel plans) is validated as in JAX. The dp, fsdp, tp, sp
and depth plans are ported (``parallel/mesh.py``): ``data_parallel: true``
(JAX's default), ``mesh: {dp: N}``, ``{fsdp: N}``, ``{dp: M, fsdp: N}``,
``{tp: N}``, ``{dp: M, tp: N}``, ``{sp: N}``, ``{dp: M, sp: N}``, ``{depth:
N}`` or ``{dp: M, depth: N}`` trains over the ranks of a process group,
one card each, ``batchSize`` rows per rank, or per dp column under tp, sp
and depth (under fsdp with the state sharded, ``parallel/fsdp.py``; under
tp with the residual pairs split, ``parallel/tensor.py``; under sp with
the rows of every activation split, ``parallel/spatial.py``: P2p,
CycleGAN, RegGAN, HD stage 1 and stage 2, and P3d, whose sp step is the
depth plan's; under depth with the D axis of every volume split,
``parallel/volume.py``, the 2-D families on the sp step). pp above 1
raises naming its ROADMAP item (M12e) when a trainer is built.
``infer_depth_sharded: true`` runs JAX's exact depth-sharded forward in
``infer_series``. ``pp_microbatches`` and ``pp_schedule`` are validated
as in JAX whatever the mesh.

The keys of the JAX package's TPU workarounds are accepted and ignored:
``checkpoint_backend`` (validated as in JAX, but it picks a JAX serialiser;
the port writes its own ``.pt`` checkpoints, ``utils/checkpoint.py``), and
in ``extras`` ``compilation_cache``, ``warp_impl``, ``reg_tap_convs`` and
``reg_im2col_levels``.
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict

_LINE = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(.*)$")
_CHILD = re.compile(r"^(\s+)([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(.*)$")
_INT = re.compile(r"^[-+]?[0-9]+$")
# YAML 1.1 floats as PyYAML reads them: a dot is required ("1e-4" is a
# string there, so it is one here too)
_FLOAT = re.compile(
    r"^[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?$|^[-+]?\.(inf|Inf|INF)$"
)
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}


@dataclass
class Config:
    name: str = "P2p"
    size: int = 512
    input_nc: int = 1
    output_nc: int = 1
    context_slices: int = 1
    compute_dtype: str = "float32"
    pad_mode: str = "reflect"
    seed: int = 42
    generator_ckpt: str = ""
    save_root: str = "./output/model/"
    image_save: str = "./output/img/"
    # --- training ---
    noise_level: int = 1
    Adv_lamda: float = 1.0  # the P2p, Cyc and Reg adversarial weight
    Cyc_lamda: float = 10.0  # CycleGAN's cycle L1
    Corr_lamda: float = 20.0  # RegGAN's correlation L1
    P2P_lamda: float = 100.0  # pix2pix's L1
    unaligned: bool = False  # a fresh random B per visit (PairedSliceDataset)
    Adv_lamda1: float = 1.0  # both stages' adversarial weight
    # read by nothing, as in the JAX package: its stage 2 weights the
    # adversarial terms with Adv_lamda1 too
    Adv_lamda2: float = 0.1
    Corr_lamda1: float = 20.0
    Corr_lamda2: float = 2.0  # stage 2's window-masked SR_loss2
    FM_lamda: float = 0.0  # stage 2's feature matching (0: the reference)
    stage1_ckpt: str = ""  # stage 2's bootstrap (G and R from stage 1)
    Smooth_lamda: float = 10.0
    epoch: int = 0  # starting epoch
    n_epochs: int = 60
    decay_epoch: int = 20
    decay_mode: str = "reference"  # accelerating decay quirk | 'linear'
    lr: float = 1e-4
    lrd: float = 1e-4  # discriminator lr (frozen in the HD family)
    batchSize: int = 1
    train_list: str = "./data/train.txt"
    val_list: str = "./data/val.txt"
    test_list: str = "./data/test.txt"
    n_cpu: int = 4
    device_windowing: bool = True  # feed raw uint16, window on the device
    fused_body_grad: Any = "auto"  # True/'on', False/'off', 'auto' = on CUDA
    d_refwd: bool = True  # D's update re-forwards the updated G
    aligned_aug: bool = False  # A and B share one affine draw
    log_every: int = 50
    live_panels: bool = True  # the live batch's panel at each log point
    stall_timeout: float = 0.0  # > 0: the stall watchdog (exit 42) armed
    remat: bool = False  # the layer route recomputes each residual block
    # --- validation, checkpoints, test() ---
    val_every: int = 5  # epochs between validations
    eval_batch: int = 1  # slices per val/test forward
    fused_body: bool = False  # val/test run the serving route (K1-K3)
    checkpoint_every_iters: int = 40000  # mid-epoch checkpoint cadence
    resume: bool = False  # start from the newest checkpoint in save_root
    collapse_guard: bool = True
    collapse_drop_db: float = 6.0  # val-PSNR drop below the best that fires
    collapse_lrd_backoff: float = 0.5  # D-lr multiplier on each fire
    lpips_weights: str = ""  # LPIPS weights file (ops/lpips.py); "" = none
    checkpoint_backend: str = "msgpack"  # accepted and ignored (see above)
    r1_gamma: float = 0.0  # R1 penalty on D(real) (0: the reference)
    warp_max_disp: int = 0  # > 0: the warp's flow clipped to [-R, R]
    reg_downsample: int = 1  # > 1: R runs at 1/ds resolution
    grad_accum: int = 1  # > 1: losses and grads averaged over K microbatches
    ema_decay: float = 0.0  # > 0: an EMA of G, read by val/test
    # --- the 3-D family (P3d) ---
    patch_depth: int = 8  # slices per depth window
    depth_downsample: int = 1  # the body's depth reduction: 1, 2 or 4
    # --mode infer: the exact forward of the whole series, its D split over
    # the ranks (parallel/volume.py), not the Hann-blended windows
    infer_depth_sharded: bool = False
    # train over every rank of the process group (--mode train starts one a
    # card), batchSize rows each; without ``mesh``
    data_parallel: bool = True
    # the parallel plan, e.g. {dp: 2}, {fsdp: 2}, {tp: 2}, {sp: 2} or
    # {depth: 2}; pp > 1 raises (ROADMAP M12e)
    mesh: Dict[str, int] = field(default_factory=dict)
    # mesh.pp > 1: the microbatches a step's pipeline schedule runs
    # (batchSize must divide by them) and the schedule, 'gpipe' or '1f1b';
    # validated as in JAX, read by the pp plan (not ported: ROADMAP M12e)
    pp_microbatches: int = 2
    pp_schedule: str = "gpipe"
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def total_epochs(self) -> int:
        return self.n_epochs + self.decay_epoch

    @property
    def serve_port(self) -> int:
        return int(self.extras.get("serve_port", 8080))

    @property
    def serve_quantize(self) -> str:
        return str(self.extras.get("serve_quantize", "") or "")

    @property
    def max_batch(self) -> int:
        return int(self.extras.get("max_batch", 16))

    @property
    def num_d(self) -> int:
        """Stage 2's discriminator scales (the reference's num_D=1)."""
        return int(self.extras.get("num_d", 1))

    @property
    def pyramid(self) -> str:
        """Stage 2's scale transition: 'center_crop' (the reference's) or
        'avg_pool'."""
        return str(self.extras.get("pyramid", "center_crop"))

    def validate(self) -> "Config":
        if self.size % 4 != 0:
            raise ValueError("size must be divisible by 4 (generator strides)")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype}")
        if self.pad_mode not in ("reflect", "zero"):
            raise ValueError("pad_mode must be 'reflect' or 'zero'")
        if self.context_slices % 2 != 1:
            raise ValueError("context_slices must be odd")
        if self.decay_mode not in ("reference", "linear"):
            raise ValueError(f"unknown decay_mode {self.decay_mode}")
        if self.batchSize < 1:
            raise ValueError("batchSize must be >= 1")
        if self.fused_body_grad not in (True, False, "auto", "on", "off"):
            raise ValueError(
                "fused_body_grad must be a bool, 'auto', 'on' or 'off'")
        if self.checkpoint_backend not in ("msgpack", "orbax"):
            raise ValueError(
                f"unknown checkpoint_backend {self.checkpoint_backend}")
        if self.collapse_drop_db <= 0:
            raise ValueError("collapse_drop_db must be > 0")
        if not (0 < self.collapse_lrd_backoff <= 1):
            raise ValueError("collapse_lrd_backoff must be in (0, 1]")
        if self.mesh:
            if not isinstance(self.mesh, dict):
                raise ValueError("mesh must be a dict of axis extents")
            unknown = set(self.mesh) - set(MESH_AXES)
            if unknown:
                raise ValueError(f"unknown mesh axes {sorted(unknown)} "
                                 "(have dp/fsdp/tp/sp/depth/pp)")
            for k, v in self.mesh.items():
                if not isinstance(v, int) or isinstance(v, bool) or v < 1:
                    raise ValueError(
                        f"mesh.{k} must be an int >= 1, got {v!r}")
            if sum(int(self.mesh.get(k, 1)) > 1 for k in MESH_AXES[1:]) > 1:
                raise ValueError(
                    "at most one of mesh.fsdp/tp/sp/depth/pp may exceed 1 "
                    "(dp composes with any single one)")
            if int(self.mesh.get("pp", 1)) > 1:
                # each data-parallel pipeline group splits its own
                # batchSize rows into microbatches
                if self.batchSize % self.pp_microbatches != 0:
                    raise ValueError(
                        f"batchSize {self.batchSize} must divide into "
                        f"pp_microbatches {self.pp_microbatches}")
        if self.pp_microbatches < 1:
            raise ValueError("pp_microbatches must be an int >= 1")
        if self.pp_schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"pp_schedule must be 'gpipe' or '1f1b', got "
                             f"{self.pp_schedule!r}")
        if self.depth_downsample not in (1, 2, 4):
            raise ValueError("depth_downsample must be 1, 2 or 4")
        if self.patch_depth % self.depth_downsample != 0:
            raise ValueError(
                "patch_depth must be divisible by depth_downsample")
        return self


# the parallel plan's axes: dp, then the model axes (at most one above 1)
MESH_AXES = ("dp", "fsdp", "tp", "sp", "depth", "pp")


def _strip_comment(v: str) -> str:
    if v[:1] in ("'", '"'):
        end = v.find(v[0], 1)
        if end < 0:
            raise ValueError(f"unterminated string {v!r}")
        rest = v[end + 1:].strip()
        if rest and not rest.startswith("#"):
            raise ValueError(f"text after string {v!r}")
        return v[: end + 1]
    cut = re.search(r"(^|\s)#", v)
    return (v[: cut.start()] if cut else v).strip()


def _scalar(v: str) -> Any:
    """One comment-free YAML scalar."""
    if v[:1] in ("'", '"'):
        return v[1:-1]
    if v[:1] in ("[", "{", "|", ">", "&", "*", "!", "-") and not _FLOAT.match(
            v) and not _INT.match(v):
        raise ValueError(f"unsupported YAML value {v!r}")
    if v in _NULL:
        return None
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    if _INT.match(v):
        return int(v)
    if _FLOAT.match(v):
        return float(v)
    return v


def _int_map_entry(key: str, v: str, into: Dict[str, Any]) -> None:
    if not _INT.match(v):
        raise ValueError(f"a map value must be an int, got {key}: {v!r}")
    into[key] = int(v)


def _flow_int_map(v: str) -> Dict[str, int]:
    """``{a: 1, b: 2}`` -> {"a": 1, "b": 2}; anything deeper raises."""
    inner = v[1:-1].strip()
    out: Dict[str, int] = {}
    if not inner:
        return out
    for item in inner.split(","):
        m = _LINE.match(item.strip())
        if m is None:
            raise ValueError(f"cannot parse map entry {item.strip()!r}")
        _int_map_entry(m.group(1), m.group(2).strip(), out)
    return out


def parse_flat_yaml(text: str) -> Dict[str, Any]:
    """Parse flat ``key: value`` YAML and one-level maps of ints; raise
    ValueError on anything else."""
    out: Dict[str, Any] = {}
    block = None  # [key, indent of its lines, line number] of a ``key:``

    def close_block():
        if block is not None and block[0] not in out:
            raise ValueError(f"line {block[2]}: key {block[0]!r}: no value")

    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#") or stripped == "---":
            continue
        child = _CHILD.match(line)
        if child is not None:
            indent = len(child.group(1))
            if block is None or block[1] not in (None, indent):
                raise ValueError(f"line {lineno}: cannot parse {line!r}")
            block[1] = indent
            try:
                _int_map_entry(child.group(2),
                               _strip_comment(child.group(3).strip()),
                               out.setdefault(block[0], {}))
            except ValueError as e:
                raise ValueError(
                    f"line {lineno}: key {block[0]!r}: {e}") from None
            continue
        close_block()
        block = None
        m = _LINE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: cannot parse {line!r}")
        key = m.group(1)
        try:
            value = _strip_comment(m.group(2).strip())
            if not value:  # opens a block of ``sub: int`` lines
                block = [key, None, lineno]
            elif value[:1] == "{" and value[-1:] == "}":
                out[key] = _flow_int_map(value)
            else:
                out[key] = _scalar(value)
        except ValueError as e:
            raise ValueError(f"line {lineno}: key {key!r}: {e}") from None
    close_block()
    return out


def load_config(path_or_dict) -> Config:
    """Load a repo config (path or dict) into a validated Config."""
    if isinstance(path_or_dict, dict):
        raw = dict(path_or_dict)
    else:
        with open(path_or_dict) as f:
            raw = parse_flat_yaml(f.read())
    known = {f.name for f in dataclasses.fields(Config)} - {"extras"}
    cfg = Config(**{k: v for k, v in raw.items() if k in known})
    cfg.extras = {k: v for k, v in raw.items() if k not in known}
    return cfg.validate()
