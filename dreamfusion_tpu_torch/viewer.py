"""Interactive orbit viewer in the browser (``dreamfusion_tpu/viewer.py``).

A self-contained HTML page served by the standard library's
``http.server``: mouse-drag orbit, wheel zoom, the shading mode and the
frame size, and, when the run has guidance, "train 16 steps".  Frames come
from the trainer's own renders with the EMA parameters (K1-K4, or K6 under
``-O``; the DMTet stage's through K7 and K8), on the card unless
``--device cpu``; the lambertian and textureless modes light from
``--light_theta`` / ``--light_phi``.  ``main --gui`` serves the live state
of a run on port ``DFTPU_VIEWER_PORT`` (7860).

    python -m dreamfusion_tpu_torch.viewer --workspace ws [--port 7860]
        [--text "a hamburger" --tiny_guidance]   # /train stepping
"""

from __future__ import annotations

import argparse
import json
import math
import os
import threading
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch
from torch.func import functional_call

from .config import Config, finalize, load_config_json
from .core.poses import circle_poses
from .core.rays import (get_rays, intrinsics_from_fov, mvp_from_pose,
                        projection_matrix)
from .models.renderer import RenderFlags
from .ops.activation import (SHADING_ALBEDO, SHADING_LAMBERTIAN,
                             SHADING_NORMAL, SHADING_TEXTURELESS)
from .utils.image import encode_png, to_uint8

SHADING_IDS = {"albedo": SHADING_ALBEDO, "lambertian": SHADING_LAMBERTIAN,
               "textureless": SHADING_TEXTURELESS, "normal": SHADING_NORMAL}

_PAGE = """<!doctype html>
<html><head><title>dreamfusion_tpu_torch viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#hud{position:fixed;top:8px;left:8px;background:#0008;padding:8px}
canvas{display:block;margin:auto;image-rendering:pixelated}
</style></head><body>
<div id="hud">drag: orbit &nbsp; wheel: zoom &nbsp;
<select id="shading"><option>albedo</option><option>lambertian</option>
<option>textureless</option><option>normal</option></select>
<select id="size"><option>128</option><option selected>256</option>
<option>512</option></select>
<button id="train" style="display:none">train 16 steps</button>
<span id="stat"></span></div>
<canvas id="c" width="512" height="512"></canvas>
<script>
let polar=90, azim=0, radius=__RADIUS__, busy=false, dirty=true;
const c=document.getElementById('c'), ctx=c.getContext('2d');
let drag=null;
c.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;
 azim-= (e.clientX-drag[0])*0.5; polar-=(e.clientY-drag[1])*0.5;
 polar=Math.max(1,Math.min(179,polar)); drag=[e.clientX,e.clientY]; dirty=true;};
c.onwheel=e=>{radius*=Math.exp(e.deltaY*0.001); dirty=true; e.preventDefault();};
document.getElementById('shading').onchange=()=>dirty=true;
document.getElementById('size').onchange=()=>dirty=true;
async function loop(){
 if(dirty&&!busy){busy=true;dirty=false;
  const s=document.getElementById('size').value;
  const sh=document.getElementById('shading').value;
  const t0=performance.now();
  const r=await fetch(`/render?polar=${polar}&azimuth=${azim}&radius=${radius}&size=${s}&shading=${sh}`);
  const b=await r.blob(); const img=await createImageBitmap(b);
  ctx.imageSmoothingEnabled=false; ctx.drawImage(img,0,0,c.width,c.height);
  document.getElementById('stat').textContent=` ${(performance.now()-t0)|0} ms`;
  busy=false;}
 requestAnimationFrame(loop);}
loop();
fetch('/caps').then(r=>r.json()).then(j=>{
 if(j.train){const b=document.getElementById('train');b.style.display='inline';
  b.onclick=async()=>{b.disabled=true;
   const r=await fetch('/train?steps=16');const j=await r.json();
   document.getElementById('stat').textContent=` step ${j.step} loss ${j.loss.toFixed(3)}`;
   b.disabled=false;dirty=true;};}});
</script></body></html>"""


def make_view(cfg: Config, polar: float, azimuth: float, radius: float,
              size: int, device) -> SimpleNamespace:
    """One orbit view at size²: rays [1, size², 3] and its mvp [1, 4, 4]
    (the default FOV, near ``min_near``, far 100)."""
    t = lambda v: torch.tensor([float(v)], device=device)  # noqa: E731
    poses, _ = circle_poses(t(radius), t(polar), t(azimuth % 360.0))
    intr = intrinsics_from_fov(torch.tensor(float(cfg.default_fovy),
                                            device=device), size, size)
    rays_o, rays_d = get_rays(poses, intr, size, size)
    focal = torch.tensor(size / (2 * math.tan(math.radians(
        cfg.default_fovy) / 2)), dtype=torch.float32, device=device)
    proj = projection_matrix(focal, size, size, cfg.min_near, 100.0)
    return SimpleNamespace(rays_o=rays_o, rays_d=rays_d,
                           mvp=mvp_from_pose(poses, proj))


class ViewerState:
    """The trainer and its state behind the server; one request at a
    time renders or trains."""

    def __init__(self, trainer, state, gen=None):
        self.trainer, self.state, self.gen = trainer, state, gen
        self.lock = threading.Lock()

    @torch.no_grad()
    def render(self, polar: float, azimuth: float, radius: float, size: int,
               shading: str = "albedo") -> np.ndarray:
        """→ [size, size, 3] float32 in [0, 1]."""
        tr = self.trainer
        cfg = tr.cfg
        batch = make_view(cfg, polar, azimuth, radius, size, tr.device)
        with self.lock:
            if getattr(tr, "dmtet_renderer", None) is not None:
                img = tr.render_view(self.state, batch, size, size)[0]
                return img.reshape(size, size, 3).clamp(0, 1).cpu().numpy()
            th, ph = math.radians(cfg.light_theta), \
                math.radians(cfg.light_phi)
            light_d = torch.tensor(
                [math.sin(th) * math.sin(ph), math.cos(th),
                 math.sin(th) * math.cos(ph)], device=tr.device)
            sid = SHADING_IDS.get(shading, SHADING_ALBEDO)
            ro, rd = batch.rays_o[0], batch.rays_d[0]
            kw = {"light_d": light_d, "shading": sid,
                  "ambient_ratio": 0.3 if sid == SHADING_LAMBERTIAN else 1.0}
            st = self.state
            outs = [functional_call(
                st.renderer, st.ema_params,
                (RenderFlags(perturb=False), ro[i:i + cfg.max_ray_batch],
                 rd[i:i + cfg.max_ray_batch], tr.occ_grid(st)), kw,
                strict=True)["image"]
                for i in range(0, ro.shape[0], cfg.max_ray_batch)]
        return torch.cat(outs).reshape(size, size, 3).clamp(0, 1
                                                             ).cpu().numpy()

    def train_steps(self, n: int) -> dict:
        """n steps of the run's own step → {"step", "loss"}."""
        tr = self.trainer
        with self.lock:
            metrics = None
            for _ in range(n):
                metrics, _ = tr.run_step(self.state, self.gen)
            loss = float(metrics["loss"]) if metrics else float("nan")
            return {"step": int(self.state.step), "loss": loss}


def make_handler(vs: ViewerState, can_train: bool):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="text/html"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            q = {k: v[0] for k, v in parse_qs(u.query).items()}
            cfg = vs.trainer.cfg
            if u.path == "/":
                self._send(200, _PAGE.replace(
                    "__RADIUS__", repr(float(cfg.default_radius))).encode())
            elif u.path == "/caps":
                self._send(200, json.dumps({"train": can_train}).encode(),
                           "application/json")
            elif u.path == "/render":
                img = vs.render(float(q.get("polar", 90)),
                                float(q.get("azimuth", 0)),
                                float(q.get("radius", cfg.default_radius)),
                                int(q.get("size", 256)),
                                q.get("shading", "albedo"))
                self._send(200, encode_png(to_uint8(img)), "image/png")
            elif u.path == "/train" and can_train:
                out = vs.train_steps(int(q.get("steps", 16)))
                self._send(200, json.dumps(out).encode(), "application/json")
            else:
                self._send(404, b"not found")

    return Handler


def make_server(vs: ViewerState, can_train: bool, port: int,
                host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """The viewer's server (``serve_forever`` runs it; port 0 takes a free
    one, ``server_address`` says which)."""
    return ThreadingHTTPServer((host, port), make_handler(vs, can_train))


def main(argv=None):
    ap = argparse.ArgumentParser("viewer")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument("--text", default=None,
                    help="enable train-in-viewer with this prompt")
    ap.add_argument("--tiny_guidance", action="store_true")
    ap.add_argument("--backbone", default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="default cuda; cpu runs the kernels' plain versions")
    args = ap.parse_args(argv)
    from .main import build_run

    cfg_path = os.path.join(args.workspace, "config.json")
    if os.path.exists(cfg_path):
        cfg = load_config_json(cfg_path)
    else:
        kw = dict(text=args.text or "a hamburger", workspace=args.workspace)
        if args.backbone:
            kw["backbone"] = args.backbone
        cfg = finalize(Config(**kw))
    can_train = args.text is not None
    # without a prompt no prior is built: a --test run's trainer
    run_cfg = replace(cfg, text=args.text) if can_train else \
        replace(cfg, test=True)
    trainer, state, gen = build_run(run_cfg, args.device, args.tiny_guidance)
    state, loaded = trainer.load_checkpoint(state, "latest")
    status = "loaded" if loaded else "NOT found - rendering random field"
    srv = make_server(ViewerState(trainer, state, gen), can_train, args.port)
    print(f"[viewer] checkpoint {status}; serving "
          f"http://0.0.0.0:{srv.server_address[1]}", flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
