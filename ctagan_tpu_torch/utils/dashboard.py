"""Self-contained live training dashboard of the port
(``ctagan_tpu/utils/dashboard.py``, copied): one HTML file over the CSV
logs, byte-equal to the JAX package's for the same CSVs and panel.

Replaces the reference's visdom surface (trainer/utils.py:50-117 — loss
curves + image panels served by a visdom server) with a zero-dependency
equivalent: ``TrainLogger`` regenerates ``<save_root>/dashboard.html`` at
every epoch boundary and validation, embedding

- per-loss small-multiple SVG line charts from ``{name}_losses.csv``,
- validation PSNR / SSIM charts from ``{name}_val.csv`` (separate charts —
  different scales never share an axis),
- the newest qualitative panel (``{name}_latest_panel.png``) base64-inline.

The page carries ``<meta http-equiv="refresh">`` so a browser pointed at
the file (file:// or any static server) self-refreshes — no process in the
training hot loop, no sockets, works over ssh-mounted checkouts.  Writes
are atomic (tmp + rename) so a refresh never catches a torn file.
"""
from __future__ import annotations

import base64
import csv
import html
import os
from typing import Dict, List, Optional, Sequence, Tuple

# categorical slot 1 (blue) for every single-series chart; light/dark pairs
_SERIES_LIGHT = "#2a78d6"
_SERIES_DARK = "#3987e5"

_W, _H = 320, 150
_ML, _MR, _MT, _MB = 46, 10, 10, 22  # margins: left axis, right, top, x axis


def _fmt(v: float) -> str:
    if v == 0:
        return "0"
    a = abs(v)
    if a >= 1000 or a < 0.01:
        return f"{v:.2e}"
    return f"{v:.4g}"


def _svg_line_chart(title: str, xs: Sequence[float], ys: Sequence[float]) -> str:
    """One recessive-axis single-series line chart (change-over-time form).
    Per-point hover tooltips ride native SVG ``<title>`` elements so the
    static file needs no scripting."""
    pts = [(x, y) for x, y in zip(xs, ys) if y is not None]
    if not pts:
        return ""
    x0, x1 = pts[0][0], pts[-1][0]
    ylo = min(y for _, y in pts)
    yhi = max(y for _, y in pts)
    if yhi == ylo:
        yhi, ylo = yhi + 1, ylo - 1
    sx = lambda x: _ML + (x - x0) / max(x1 - x0, 1e-12) * (_W - _ML - _MR)
    sy = lambda y: _MT + (yhi - y) / (yhi - ylo) * (_H - _MT - _MB)
    poly = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in pts)
    # sparse hover targets: every point, invisible 8px hit circle + <title>
    hovers = "".join(
        f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="8" fill="transparent" '
        f'pointer-events="all"><title>epoch {x:g}: {_fmt(y)}</title></circle>'
        for x, y in pts
    )
    last_x, last_y = pts[-1]
    return f"""<figure class="chart">
<figcaption>{html.escape(title)}</figcaption>
<svg viewBox="0 0 {_W} {_H}" role="img" aria-label="{html.escape(title)}">
<line x1="{_ML}" y1="{_MT}" x2="{_ML}" y2="{_H - _MB}" class="axis"/>
<line x1="{_ML}" y1="{_H - _MB}" x2="{_W - _MR}" y2="{_H - _MB}" class="axis"/>
<text x="{_ML - 4}" y="{_MT + 4}" class="tick" text-anchor="end">{_fmt(yhi)}</text>
<text x="{_ML - 4}" y="{_H - _MB}" class="tick" text-anchor="end">{_fmt(ylo)}</text>
<text x="{_ML}" y="{_H - 6}" class="tick">{x0:g}</text>
<text x="{_W - _MR}" y="{_H - 6}" class="tick" text-anchor="end">{x1:g}</text>
<polyline points="{poly}" fill="none" class="series" stroke-width="2"/>
<circle cx="{sx(last_x):.1f}" cy="{sy(last_y):.1f}" r="3" class="dot"/>
<text x="{sx(last_x) - 4:.1f}" y="{max(sy(last_y) - 6, 10):.1f}" class="val" text-anchor="end">{_fmt(last_y)}</text>
{hovers}
</svg>
</figure>"""


def _read_csv(path: str) -> Tuple[List[str], List[List[float]]]:
    if not os.path.exists(path):
        return [], []
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return [], []
    header, out = rows[0], []
    for r in rows[1:]:
        if len(r) != len(header):
            continue  # torn tail line mid-write
        try:
            out.append([float(v) for v in r])
        except ValueError:
            continue
    return header, out


def _table(header: List[str], rows: List[List[float]], keep: int = 12) -> str:
    if not rows:
        return ""
    body = "".join(
        "<tr>" + "".join(f"<td>{_fmt(v)}</td>" for v in r) + "</tr>"
        for r in rows[-keep:]
    )
    head = "".join(f"<th>{html.escape(h)}</th>" for h in header)
    return (
        f"<details><summary>table (last {min(keep, len(rows))} epochs)"
        f"</summary><table><tr>{head}</tr>{body}</table></details>"
    )


def render_dashboard(
    name: str,
    loss_header: List[str],
    loss_rows: List[List[float]],
    val_header: List[str],
    val_rows: List[List[float]],
    panel_png: Optional[bytes] = None,
    refresh_s: int = 30,
) -> str:
    charts: List[str] = []
    if loss_rows and loss_header and loss_header[0] == "epoch":
        xs = [r[0] for r in loss_rows]
        for j, key in enumerate(loss_header[1:], start=1):
            ys = [r[j] for r in loss_rows]
            charts.append(_svg_line_chart(key, xs, ys))
    if val_rows and val_header and val_header[0] == "epoch":
        xs = [r[0] for r in val_rows]
        for j, key in enumerate(val_header[1:], start=1):
            charts.append(
                _svg_line_chart(f"val {key}", xs, [r[j] for r in val_rows])
            )
    panel = ""
    if panel_png:
        b64 = base64.b64encode(panel_png).decode("ascii")
        panel = (
            '<h2>latest validation sample (input | synthesized | target)</h2>'
            f'<img alt="latest qualitative panel" '
            f'src="data:image/png;base64,{b64}"/>'
        )
    n_ep = int(loss_rows[-1][0]) if loss_rows else 0
    return f"""<!doctype html>
<html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="{refresh_s}">
<title>{html.escape(name)} — training</title>
<style>
:root {{ color-scheme: light dark; }}
body {{ font: 13px/1.45 system-ui, sans-serif; margin: 18px;
       background: #fcfcfb; color: #0b0b0b; }}
h1 {{ font-size: 17px; margin: 0 0 2px; }}
.sub {{ color: #52514e; margin-bottom: 14px; }}
.grid {{ display: flex; flex-wrap: wrap; gap: 14px; }}
figure.chart {{ margin: 0; width: {_W}px; }}
figure.chart figcaption {{ font-size: 12px; color: #52514e; margin: 0 0 2px 6px; }}
svg {{ display: block; }}
.axis {{ stroke: #d8d7d2; stroke-width: 1; }}
.tick, .val {{ font-size: 9px; fill: #52514e; }}
.val {{ font-weight: 600; }}
.series {{ stroke: {_SERIES_LIGHT}; }}
.dot {{ fill: {_SERIES_LIGHT}; }}
img {{ max-width: 100%; image-rendering: auto; border: 1px solid #d8d7d2; }}
table {{ border-collapse: collapse; font-size: 11px; margin-top: 6px; }}
td, th {{ border: 1px solid #d8d7d2; padding: 2px 7px; text-align: right; }}
details {{ margin-top: 14px; }}
@media (prefers-color-scheme: dark) {{
  body {{ background: #1a1a19; color: #ffffff; }}
  .sub, .tick, .val, figure.chart figcaption {{ fill: #c3c2b7; color: #c3c2b7; }}
  .axis {{ stroke: #3a3a38; }}
  .series {{ stroke: {_SERIES_DARK}; }}
  .dot {{ fill: {_SERIES_DARK}; }}
  td, th, img {{ border-color: #3a3a38; }}
}}
</style></head><body>
<h1>{html.escape(name)}</h1>
<div class="sub">epoch {n_ep} &middot; auto-refreshes every {refresh_s}s
&middot; running means per epoch</div>
<div class="grid">
{''.join(charts)}
</div>
{panel}
{_table(loss_header, loss_rows)}
</body></html>"""


def write_dashboard(log_dir: str, name: str, refresh_s: int = 30) -> str:
    """(Re)generate ``<log_dir>/dashboard.html`` from the CSVs + newest
    panel currently on disk; atomic so a browser refresh never tears."""
    loss_h, loss_r = _read_csv(os.path.join(log_dir, f"{name}_losses.csv"))
    val_h, val_r = _read_csv(os.path.join(log_dir, f"{name}_val.csv"))
    panel_path = os.path.join(log_dir, f"{name}_latest_panel.png")
    panel = None
    if os.path.exists(panel_path):
        with open(panel_path, "rb") as f:
            panel = f.read()
    out = os.path.join(log_dir, "dashboard.html")
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        f.write(
            render_dashboard(
                name, loss_h, loss_r, val_h, val_r, panel, refresh_s
            )
        )
    os.replace(tmp, out)
    return out


def append_val_csv(log_dir: str, name: str, epoch: int, psnr: float, ssim: float):
    path = os.path.join(log_dir, f"{name}_val.csv")
    new = not os.path.exists(path)
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if new:
            w.writerow(["epoch", "PSNR", "SSIM"])
        w.writerow([epoch, psnr, ssim])
