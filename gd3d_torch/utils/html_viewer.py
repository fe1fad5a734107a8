"""Self-contained HTML point-cloud viewer for aligned scenes (counterpart of
gd3d/utils/html_viewer.py, copied: numpy and json).

One .html file with the points and camera frusta inlined as JSON, drawn by
~100 lines of dependency-free canvas JavaScript (drag to orbit, wheel to
zoom): the headless stand-in for the reference's gradio demos. Open it in
any browser; no server, no network, no WebGL needed.
"""
from __future__ import annotations

import json
from typing import Optional, Tuple

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>gd3d scene</title><style>
body {{ margin: 0; background: #111; color: #ccc; font: 12px monospace; }}
#hud {{ position: fixed; top: 8px; left: 8px; }}
canvas {{ display: block; }}
</style></head><body>
<div id="hud">gd3d scene &mdash; drag to orbit, wheel to zoom &mdash;
{npts} points, {ncams} cameras</div>
<canvas id="c"></canvas>
<script>
const PTS = {pts};   // [x,y,z,r,g,b] flat
const CAMS = {cams}; // per-camera 5 frustum points [apex,4 corners] flat xyz
const cv = document.getElementById("c");
const ctx = cv.getContext("2d");
let yaw = 0.5, pitch = -0.4, dist = {dist}, cx = {cx}, cy = {cy}, cz = {cz};
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
window.onmouseup = () => drag = null;
window.onmousemove = e => {{
  if (!drag) return;
  yaw += (e.clientX - drag[0]) * 0.01;
  pitch += (e.clientY - drag[1]) * 0.01;
  pitch = Math.max(-1.55, Math.min(1.55, pitch));
  drag = [e.clientX, e.clientY];
  draw();
}};
cv.onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001); draw(); e.preventDefault(); }};
function project(x, y, z, W, H) {{
  x -= cx; y -= cy; z -= cz;
  const cyw = Math.cos(yaw), syw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  let X = cyw * x + syw * z, Z0 = -syw * x + cyw * z;
  let Y = cp * y - sp * Z0, Z = sp * y + cp * Z0 + dist;
  if (Z <= 0.05) return null;
  const f = 1.2 * Math.min(W, H);
  return [W / 2 + f * X / Z, H / 2 + f * Y / Z, Z];
}}
function draw() {{
  const W = cv.width = window.innerWidth, H = cv.height = window.innerHeight;
  ctx.fillStyle = "#111"; ctx.fillRect(0, 0, W, H);
  for (let i = 0; i < PTS.length; i += 6) {{
    const p = project(PTS[i], PTS[i+1], PTS[i+2], W, H);
    if (!p) continue;
    ctx.fillStyle = `rgb(${{PTS[i+3]}},${{PTS[i+4]}},${{PTS[i+5]}})`;
    const s = Math.max(1, 2.5 / p[2]);
    ctx.fillRect(p[0], p[1], s, s);
  }}
  ctx.strokeStyle = "#4af"; ctx.lineWidth = 1;
  for (let c = 0; c < CAMS.length; c += 15) {{
    const q = [];
    for (let k = 0; k < 5; k++)
      q.push(project(CAMS[c+3*k], CAMS[c+3*k+1], CAMS[c+3*k+2], W, H));
    if (q.some(v => !v)) continue;
    ctx.beginPath();
    for (let k = 1; k <= 4; k++) {{
      ctx.moveTo(q[0][0], q[0][1]); ctx.lineTo(q[k][0], q[k][1]);
      ctx.lineTo(q[k % 4 + 1][0], q[k % 4 + 1][1]);
    }}
    ctx.stroke();
  }}
}}
window.onresize = draw;
draw();
</script></body></html>
"""


def write_html_viewer(
    path: str,
    pts3d: np.ndarray,
    colors: np.ndarray,
    poses_c2w: np.ndarray,
    focals: np.ndarray,
    hw: Optional[Tuple[int, int]] = None,
    max_points: int = 60_000,
    frustum_scale: float = 0.08,
    seed: int = 0,
) -> str:
    """Write a standalone scene viewer.

    pts3d (P, 3) float; colors (P, 3) uint8; poses_c2w (N, 4, 4);
    focals (N,). With `hw`, frusta open at the true field of view
    (half-width = (W/2)/f at unit depth); otherwise a nominal aspect.
    Subsamples to max_points for browser responsiveness.
    """
    pts3d = np.asarray(pts3d, np.float32).reshape(-1, 3)
    colors = np.asarray(colors).reshape(-1, 3)
    if len(pts3d) > max_points:
        sel = np.random.RandomState(seed).choice(
            len(pts3d), max_points, replace=False)
        pts3d, colors = pts3d[sel], colors[sel]

    flat = np.concatenate(
        [pts3d, colors.astype(np.float32)], axis=1).reshape(-1)
    cams = []
    for pose, f in zip(np.asarray(poses_c2w), np.asarray(focals)):
        s = frustum_scale
        if hw is not None and f > 0:
            wx = s * (hw[1] / 2.0) / float(f)  # true FOV at unit depth
            wy = s * (hw[0] / 2.0) / float(f)
        else:
            wx = wy = s * 0.8
        corners = np.array(
            [[0, 0, 0], [-wx, -wy, s], [wx, -wy, s],
             [wx, wy, s], [-wx, wy, s]])
        world = corners @ pose[:3, :3].T + pose[:3, 3]
        cams.append(world.reshape(-1))
    cams_flat = np.concatenate(cams) if cams else np.zeros(0)

    center = pts3d.mean(0) if len(pts3d) else np.zeros(3)
    spread = float(np.percentile(
        np.linalg.norm(pts3d - center, axis=1), 90)) if len(pts3d) else 1.0

    def js(a):
        return json.dumps([round(float(v), 4) for v in np.asarray(a)])

    html = _PAGE.format(
        npts=len(pts3d), ncams=len(cams),
        pts=js(flat), cams=js(cams_flat),
        dist=round(3.0 * max(spread, 1e-3), 4),
        cx=round(float(center[0]), 4), cy=round(float(center[1]), 4),
        cz=round(float(center[2]), 4),
    )
    with open(path, "w") as fh:
        fh.write(html)
    return path
