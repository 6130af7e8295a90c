"""Interactive 2D data comparison page (a copy of ``er3t_tpu/vis/intv.py``,
lines 1-119; the fields may be torch tensors on any device).

The reference's ``er3t.vis.intv.compare_data_2d`` builds a Bokeh page with
linked side-by-side images and hover readout (er3t/vis/intv.py:16-...).
Bokeh is not a framework dependency here; this module writes a fully
self-contained HTML page (inline canvas + JS, zero external assets) with
the same interactions: linked hover readout and a shared intensity-scale slider, a shared
hover readout showing (ix, iy, value_left, value_right, difference), and a
colormap range slider.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .plot import host_array

__all__ = ['compare_data_2d_html']

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: sans-serif; background: #111; color: #ddd; margin: 16px; }}
 .row {{ display: flex; gap: 24px; }}
 canvas {{ border: 1px solid #444; image-rendering: pixelated; }}
 #readout {{ margin-top: 8px; font-family: monospace; }}
 .pane {{ text-align: center; }}
</style></head><body>
<h2>{title}</h2>
<div class="row">
 <div class="pane"><div>{name0}</div><canvas id="c0" width="{w}" height="{h}"></canvas></div>
 <div class="pane"><div>{name1}</div><canvas id="c1" width="{w}" height="{h}"></canvas></div>
</div>
<div>range: <input type="range" id="vmax" min="1" max="100" value="100" style="width:300px">
 <span id="vmaxval"></span></div>
<div id="readout">hover over a panel</div>
<script>
const A = {data0};
const B = {data1};
const NX = {nx}, NY = {ny}, SCALE = {scale};
const vhi0 = {vmax};
function draw(canvas, D, vmax) {{
  const ctx = canvas.getContext('2d');
  const img = ctx.createImageData(NX, NY);
  for (let j = 0; j < NY; j++) for (let i = 0; i < NX; i++) {{
    const v = Math.max(0, Math.min(1, D[i][j] / vmax));
    const k = 4 * ((NY - 1 - j) * NX + i);
    // viridis-ish ramp
    img.data[k] = 255 * Math.min(1, Math.max(0, 1.5 * v - 0.25));
    img.data[k+1] = 255 * Math.min(1, 0.2 + 0.8 * v);
    img.data[k+2] = 255 * Math.min(1, Math.max(0, 0.6 - 0.4 * v + 0.6 * (1 - v)));
    img.data[k+3] = 255;
  }}
  createImageBitmap(img).then(bm => {{
    ctx.imageSmoothingEnabled = false;
    ctx.clearRect(0, 0, canvas.width, canvas.height);
    ctx.drawImage(bm, 0, 0, canvas.width, canvas.height);
  }});
}}
const c0 = document.getElementById('c0'), c1 = document.getElementById('c1');
function redraw() {{
  const f = document.getElementById('vmax').value / 100.0;
  document.getElementById('vmaxval').textContent = (vhi0 * f).toPrecision(4);
  draw(c0, A, vhi0 * f); draw(c1, B, vhi0 * f);
}}
document.getElementById('vmax').oninput = redraw;
function hover(ev) {{
  const r = ev.target.getBoundingClientRect();
  const i = Math.floor((ev.clientX - r.left) / SCALE);
  const j = NY - 1 - Math.floor((ev.clientY - r.top) / SCALE);
  if (i < 0 || i >= NX || j < 0 || j >= NY) return;
  const a = A[i][j], b = B[i][j];
  document.getElementById('readout').textContent =
    `(${{i}}, ${{j}})  {name0}=${{a.toPrecision(5)}}  ` +
    `{name1}=${{b.toPrecision(5)}}  diff=${{(a-b).toPrecision(4)}}  ` +
    `rel=${{(100*(a-b)/(b||1e-30)).toFixed(2)}}%`;
}}
c0.onmousemove = hover; c1.onmousemove = hover;
redraw();
</script></body></html>
"""


def compare_data_2d_html(data0, data1, name0='data 0', name1='data 1',
                         fname='compare.html', title='er3t_tpu comparison',
                         vmax=None, max_px=480):
    """Write a self-contained interactive comparison page for two 2D fields.

    Returns the output path.  Fields larger than ``max_px`` per side are
    block-averaged to keep the page light.
    """
    a = host_array(data0).astype(np.float64)
    b = host_array(data1).astype(np.float64)
    if a.shape != b.shape or a.ndim != 2:
        raise ValueError('data0/data1 must be 2D arrays of the same shape')
    step = max(1, int(np.ceil(max(a.shape) / max_px)))
    if step > 1:
        nx0, ny0 = (a.shape[0] // step) * step, (a.shape[1] // step) * step
        a = a[:nx0, :ny0].reshape(-1, step, ny0 // step, step).mean((1, 3))
        b = b[:nx0, :ny0].reshape(-1, step, ny0 // step, step).mean((1, 3))
    nx, ny = a.shape
    scale = max(1, int(480 / max(nx, ny)))
    if vmax is None:
        with np.errstate(all='ignore'):
            vmax = float(np.nanpercentile(
                np.concatenate([a.ravel(), b.ravel()]), 99.0))
        if not np.isfinite(vmax) or vmax == 0.0:   # all-NaN/zero fields
            vmax = 1.0
    a = np.nan_to_num(a)
    b = np.nan_to_num(b)
    html = _PAGE.format(
        title=title, name0=name0, name1=name1,
        w=nx * scale, h=ny * scale, nx=nx, ny=ny, scale=scale, vmax=vmax,
        data0=json.dumps(np.round(a, 7).tolist()),
        data1=json.dumps(np.round(b, 7).tolist()))
    with open(fname, 'w') as f:
        f.write(html)
    return os.path.abspath(fname)
