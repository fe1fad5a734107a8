"""Interactive reconstruction demo of the port: upload photos -> align ->
inspect in 3D (counterpart of gd3d/cli/demo.py; the gradio demos of
dust3r/demo.py and mast3r/demo.py, on the stdlib).

A ThreadingHTTPServer whose

  GET  /                 serves the upload form + the list of past scenes
  POST /reconstruct      saves the uploaded images, runs
                         gd3d_torch.cli.align's main (MASt3R pairs -> global
                         alignment) with --html, and redirects to the viewer
  GET  /scenes/...       serves the per-session artifacts (scene.html, the
                         self-contained orbit viewer of
                         gd3d_torch/utils/html_viewer.py, plus .npz/.ply)

Run: python -m gd3d_torch.cli.demo --output <dir> [--teacher-ckpt mast3r.pth |
--tiny] [--device cuda]. Reconstructions run on the card unless --device
says otherwise. `make_server` and `serve_background` take a teacher (a
Mast3rTeacher on the device) to use in place of the one the flags would
build. The module imports no torch at its top level.
"""
from __future__ import annotations

import argparse
import html
import io
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

_FORM = """<!doctype html>
<html><head><title>gd3d reconstruction demo</title><style>
body {{ font-family: sans-serif; max-width: 42em; margin: 3em auto; }}
fieldset {{ border: 1px solid #aaa; margin-bottom: 1.5em; }}
li {{ margin: 0.3em 0; }}
</style></head><body>
<h2>gd3d: photos &rarr; posed 3D reconstruction</h2>
<form action="/reconstruct" method="post" enctype="multipart/form-data">
<fieldset><legend>images (2+; one shared aspect works best)</legend>
<input type="file" name="images" multiple required accept="image/*">
</fieldset>
<fieldset><legend>alignment</legend>
<label>iterations <input type="number" name="niter" value="{niter}"></label>
<label>pair graph <select name="pairs">
<option>complete</option><option>sliding</option><option>swin-3</option>
<option>oneref-0</option></select></label>
</fieldset>
<button type="submit">reconstruct</button>
</form>
<h3>scenes</h3><ul>{scenes}</ul>
</body></html>"""


def _parse_multipart(body: bytes, content_type: str):
    """Minimal multipart/form-data parser (stdlib-only; cgi is deprecated).

    Returns (fields: dict[str, str], files: list[(filename, bytes)])."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    boundary = m.group(1).encode()
    fields, files = {}, []
    for part in body.split(b"--" + boundary):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        try:
            head, _, payload = part.partition(b"\r\n\r\n")
        except ValueError:
            continue
        disp = b""
        for line in head.split(b"\r\n"):
            if line.lower().startswith(b"content-disposition"):
                disp = line
        name_m = re.search(rb'name="([^"]*)"', disp)
        file_m = re.search(rb'filename="([^"]*)"', disp)
        if file_m and file_m.group(1):
            files.append((Path(file_m.group(1).decode("utf-8", "replace")
                               ).name, payload))
        elif name_m:
            fields[name_m.group(1).decode()] = payload.decode(
                "utf-8", "replace").strip()
    return fields, files


def _make_handler(cfg, teacher=None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; errors still raise
            pass

        def _send(self, code, body, ctype="text/html; charset=utf-8",
                  extra=()):
            data = body if isinstance(body, bytes) else body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            for k, v in extra:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            root = Path(cfg.output)
            if self.path in ("/", "/index.html"):
                scenes = []
                for d in sorted(root.glob("scene_*")):
                    page = ("scene.html" if (d / "scene.html").exists()
                            else "")
                    name = html.escape(d.name)
                    link = (f'<a href="/scenes/{name}/{page}">{name}</a>'
                            if page else name)
                    scenes.append(f"<li>{link}</li>")
                self._send(200, _FORM.format(
                    niter=cfg.niter,
                    scenes="".join(scenes) or "<li>(none yet)</li>"))
                return
            if self.path.startswith("/scenes/"):
                rel = self.path[len("/scenes/"):].split("?", 1)[0]
                target = (root / rel).resolve()
                if root.resolve() not in target.parents or not target.is_file():
                    self._send(404, "not found", "text/plain")
                    return
                ctype = ("text/html; charset=utf-8"
                         if target.suffix == ".html"
                         else "application/octet-stream")
                self._send(200, target.read_bytes(), ctype)
                return
            self._send(404, "not found", "text/plain")

        def do_POST(self):
            if self.path != "/reconstruct":
                self._send(404, "not found", "text/plain")
                return
            length = int(self.headers.get("Content-Length", "0"))
            fields, files = _parse_multipart(
                self.rfile.read(length),
                self.headers.get("Content-Type", ""))
            if len(files) < 2:
                self._send(400, "need at least 2 images", "text/plain")
                return
            session = f"scene_{time.strftime('%Y%m%d_%H%M%S')}"
            outdir = Path(cfg.output) / session
            updir = outdir / "uploads"
            updir.mkdir(parents=True, exist_ok=True)
            paths = []
            for i, (fname, payload) in enumerate(files):
                p = updir / f"{i:03d}_{fname or 'img.png'}"
                p.write_bytes(payload)
                paths.append(str(p))
            argv = ["--images", *paths, "--output", str(outdir),
                    "--size", str(cfg.size),
                    "--niter", fields.get("niter", str(cfg.niter)),
                    "--pairs", fields.get("pairs", "complete"),
                    "--html", "--ply", "--min-conf", str(cfg.min_conf)]
            if cfg.teacher_ckpt:
                argv += ["--teacher-ckpt", cfg.teacher_ckpt]
            if cfg.tiny:
                argv += ["--tiny"]
            argv += ["--device", cfg.device]
            from gd3d_torch.cli.align import main as align_main

            try:
                align_main(argv, teacher=teacher)
            except Exception as e:  # surface the failure in the browser
                self._send(500, f"reconstruction failed: {e!r}",
                           "text/plain")
                return
            self._send(303, "", extra=(
                ("Location", f"/scenes/{session}/scene.html"),))

    return Handler


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m gd3d_torch.cli.demo",
        description="Browser demo: upload images, reconstruct with "
                    "the align CLI, inspect the scene")
    p.add_argument("--output", required=True,
                   help="directory for per-session scenes")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--teacher-ckpt", default=None,
                   help="MASt3R torch state_dict (.pth)")
    p.add_argument("--tiny", action="store_true",
                   help="tiny random teacher (smoke/demo without weights)")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--niter", type=int, default=300)
    p.add_argument("--min-conf", type=float, default=1.5)
    p.add_argument("--device", default="cuda",
                   help="torch device the reconstructions run on (default: the card)")
    return p.parse_args(argv)


def make_server(args, teacher=None) -> ThreadingHTTPServer:
    Path(args.output).mkdir(parents=True, exist_ok=True)
    return ThreadingHTTPServer((args.host, args.port), _make_handler(args, teacher))


def main(argv=None) -> None:
    args = parse_args(argv)
    srv = make_server(args)
    host, port = srv.server_address[:2]
    print(f"gd3d_torch demo serving on http://{host}:{port}  "
          f"(output -> {args.output})", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()


def serve_background(args, teacher=None) -> tuple:
    """Start the server on a daemon thread (tests); returns (server, port)."""
    srv = make_server(args, teacher)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, srv.server_address[1]


if __name__ == "__main__":
    main()
