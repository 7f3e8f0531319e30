"""K7's backward against its plain version on the DMTet stage's own
surfaces, with a cotangent on every output of every pixel.

For each stage-1 seed it runs chip_smoke.py's oracle stage 1 (300 steps)
at that seed, builds the DMTet surface from the checkpoint as main does,
and in the far views (``chip_smoke.dmtet_far_views``) whose fullest tiles
list the most holds ``raster_cuda``'s forward and backward against
``raster_plain``'s at chip_smoke.py's tolerance (1e-4 of the largest
gradient + 1e-4 relative).  Per view it prints the face count, the fullest
tile, the pixels whose winner differs, the gradient entries outside the
tolerance and the largest error in units of the largest gradient, and
where an entry is outside, ``chip_smoke.explain_raster_bwd``'s account.
``--save`` writes the views; ``--views`` reads them instead of training,
so that a second checkout (another kernel) is held on the very same
surfaces.  Not a test; on the card:

    python3 tests/k7_backward_witness.py --seeds 0 1 2 3 --save views.pt
    python3 <other checkout>/tests/k7_backward_witness.py --views views.pt
"""

import argparse
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402

TOP = 3          # views per surface, the fullest tiles first


def build_views(seeds, ws):
    from dreamfusion_tpu_torch import main as port_main
    from dreamfusion_tpu_torch.ops.raster import project_verts, screen_coords
    views = []
    for seed in seeds:
        flags = list(S.FLAGSHIP)
        flags[flags.index("--seed") + 1] = str(seed)
        run = os.path.join(ws, f"stage1_{seed}")
        port_main.main(flags + S.STAGE1_END + ["--iters", str(S.STEPS),
                                               "--workspace", run])
        cfg, dmr, mesh, mvp, fullest = S.dmtet_far_views(
            torch, port_main, os.path.join(run, "checkpoints"),
            os.path.join(ws, f"dmtet_{seed}"))
        order = sorted(range(len(fullest)), key=fullest.__getitem__)[::-1]
        for i in order[:TOP]:
            with torch.no_grad():
                sx, sy, sz, valid = screen_coords(project_verts(
                    mesh.verts.detach(), mvp[i]), mesh.faces, mesh.face_mask,
                    cfg.h, cfg.w)
            views.append({
                "name": f"seed {seed} view {i}", "faces": mesh.faces.cpu(),
                "n_faces": int(mesh.n_faces), "fullest": fullest[i],
                "sx": sx.cpu(), "sy": sy.cpu(), "sz": sz.cpu(),
                "valid": valid.cpu(), "H": cfg.h, "W": cfg.w,
                "cap": dmr.tile_cap, "soft": dmr.soft_edge_px})
    return views


def compare(v):
    from dreamfusion_tpu_torch.ops import raster as K7
    dev = torch.device("cuda")
    sx, sy, sz, valid = (v[k].to(dev) for k in ("sx", "sy", "sz", "valid"))
    faces, H, W = v["faces"].to(dev), v["H"], v["W"]
    args = (faces, valid, H, W, 32, v["cap"], v["soft"])
    ins_k = [t.clone().requires_grad_() for t in (sx, sy, sz)]
    ins_p = [t.clone().requires_grad_() for t in (sx, sy, sz)]
    ok = K7.raster_cuda(*ins_k, *args)
    op = K7.raster_plain(*ins_p, *args)
    flips = int((ok.tri_id != op.tri_id).sum())
    g = torch.Generator(device=dev).manual_seed(3)
    cots = [torch.randn(o.shape, device=dev, generator=g)
            for o in (ok.bary, ok.depth, ok.alpha)]

    def loss(o):
        return sum((x * c).sum() for x, c in zip((o.bary, o.depth, o.alpha),
                                                  cots))
    gk = torch.autograd.grad(loss(ok), ins_k)
    gp = torch.autograd.grad(loss(op), ins_p)
    scale = max(float(x.abs().max()) for x in gp)
    bad = torch.stack([(a - b).abs() > 1e-4 * scale + 1e-4 * b.abs()
                       for a, b in zip(gk, gp)], -1)             # [V, 3]
    err = max(float((a - b).abs().max()) for a, b in zip(gk, gp)) / scale
    print(f"[{v['name']}] {v['n_faces']} faces, fullest tile "
          f"{v['fullest']}, {flips} pixels' winners differ, "
          f"{int(bad.sum())} of {bad.numel()} gradient entries outside, "
          f"max err {err:.3e} of the largest ({scale:.4g})", flush=True)
    if bool(bad.any()):
        S.explain_raster_bwd(torch, ok, op, sx, sy, sz, faces, gk, gp, bad)
    return int(bad.sum())


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--views", default=None)
    p.add_argument("--save", default=None)
    a = p.parse_args()
    if a.views:
        views = torch.load(a.views)
    else:
        views = build_views(a.seeds, tempfile.mkdtemp(prefix="k7_witness_"))
        if a.save:
            torch.save(views, a.save)
    total = sum(compare(v) for v in views)
    print(f"{len(views)} views, {total} gradient entries outside the "
          f"tolerance", flush=True)


if __name__ == "__main__":
    main()
