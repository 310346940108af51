"""The port's config: the fields the serving slice reads, from the same
``configs/*.yaml`` files as ``ctagan_tpu/utils/config.py``.

The repo's configs are flat ``key: value`` YAML. This reader parses that
subset without PyYAML (scalars: quoted or bare strings, ints, floats,
booleans, null; ``#`` comments) and rejects any line it cannot parse, such
as nested mappings, lists or flow collections. Keys that are not fields land
in ``extras``, as in the JAX package (``serve_port``, ``serve_quantize``,
``max_batch`` are read from there).
"""
from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from typing import Any, Dict

_LINE = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)\s*:\s*(.*)$")
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
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def serve_port(self) -> int:
        return int(self.extras.get("serve_port", 8080))

    @property
    def serve_quantize(self) -> str:
        return str(self.extras.get("serve_quantize", "") or "")

    @property
    def max_batch(self) -> int:
        return int(self.extras.get("max_batch", 16))

    def validate(self) -> "Config":
        if self.size % 4 != 0:
            raise ValueError("size must be divisible by 4 (generator strides)")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype}")
        if self.pad_mode not in ("reflect", "zero"):
            raise ValueError("pad_mode must be 'reflect' or 'zero'")
        if self.context_slices % 2 != 1:
            raise ValueError("context_slices must be odd")
        return self


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


def parse_flat_yaml(text: str) -> Dict[str, Any]:
    """Parse flat ``key: value`` YAML; raise ValueError on anything else."""
    out: Dict[str, Any] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        stripped = line.strip()
        if not stripped or stripped.startswith("#") or stripped == "---":
            continue
        m = _LINE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: cannot parse {line!r}")
        key = m.group(1)
        try:
            value = _strip_comment(m.group(2).strip())
            if not value:  # an empty value opens a nested block in YAML
                raise ValueError("no scalar value")
            out[key] = _scalar(value)
        except ValueError as e:
            raise ValueError(f"line {lineno}: key {key!r}: {e}") from None
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
