"""A witness for the pixel-oracle known-view step at random field params.

tests/test_torch_lifted_steps.py's known-view step (the image preset, a
file reference, 16² renders, 24-sample march) from
``torch_parity.jax_train_state``'s random params, against the jitted JAX
step: it prints the triplane gradient values outside the test's tolerance
and the texels they lie on, how far the two sides' sample depths and masks
differ, the sample whose 2x2 footprints cover those texels and its
smallest hidden pre-activation in the port's MLP, then the same check with
that one ReLU switched off in the port.

    JAX_PLATFORMS=cpu python tests/kv_relu_witness.py
"""

import dataclasses
import os
import pathlib
import sys
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import dreamfusion_tpu.ops.occupancy as jocc  # noqa: E402
import dreamfusion_tpu.training.trainer as jtrainer  # noqa: E402
import dreamfusion_tpu_torch.models.nerf as pnerf  # noqa: E402
import dreamfusion_tpu_torch.models.renderer as prend  # noqa: E402
from dreamfusion_tpu.config import apply_image_mode  # noqa: E402
from dreamfusion_tpu.guidance.oracle import \
    PixelOracleGuidance as JOracle  # noqa: E402
from dreamfusion_tpu.guidance.sd import SDConfig as JSDConfig  # noqa: E402
from dreamfusion_tpu.training.image_data import \
    load_ref_images as j_load_ref_images  # noqa: E402
from dreamfusion_tpu_torch.training.image_data import \
    load_ref_images  # noqa: E402
from dreamfusion_tpu_torch.training.trainer import Trainer  # noqa: E402
from dreamfusion_tpu_torch.utils.convert import params_from_jax  # noqa
from test_torch_multi_prior import _cfg, _port_ref, _refs, _states  # noqa
from torch_parity import jax_known_view_draws, port_cfg  # noqa: E402

STEP = 104
CAP = {}


def _mlp_forward(off=None):
    """BasicMLP.forward recording each hidden pre-activation; ``off`` =
    (layer, row, unit) switches that one ReLU off."""
    def forward(self, x, dtype, tangents=None):
        x = x.to(dtype)
        t = None if tangents is None else tangents.to(dtype)
        last = len(self.layers) - 1
        for i, lin in enumerate(self.layers):
            W = lin.weight.to(dtype)
            x = F.linear(x, W, lin.bias.to(dtype))
            if t is not None:
                t = F.linear(t, W)
            if i < last:
                CAP.setdefault("pre", []).append(x.detach().numpy().copy())
                keep = (x > 0).to(dtype)
                if off is not None and off[0] == i and \
                        x.shape[0] > off[1]:
                    keep = keep.clone()
                    keep[off[1], off[2]] = 0
                if t is not None:
                    t = t * keep
                x = x * keep
        return x if tangents is None else (x, t)
    return forward


def run(off=None):
    CAP.clear()
    tmp = pathlib.Path(tempfile.mkdtemp())
    _, png = _refs(tmp)
    cfg = dataclasses.replace(_cfg(
        tmp, apply_image_mode, image=png, text=None, guidance=("oracle",)),
        lambda_3d_normal_smooth=0.0)
    g = JOracle(JSDConfig(t_range=cfg.t_range), scene=cfg.oracle_scene)
    jt = jtrainer.Trainer(cfg, guidances={"oracle": g},
                          guidance_params={"oracle": {}},
                          embeddings={"oracle": jnp.zeros(())},
                          ref_images=j_load_ref_images(cfg, cfg.h, cfg.w))
    pt = Trainer(port_cfg(cfg), "cpu", ref_images=_port_ref(
        load_ref_images(port_cfg(cfg), cfg.h, cfg.w)))
    saved = (jocc.sample_pdf, prend.march_region, pnerf.BasicMLP.forward,
             jtrainer.apply_updates_guarded)

    def sample_pdf(*a, **k):
        z = saved[0](*a, **k)
        jax.debug.callback(lambda v: CAP.update(jz=np.asarray(v)), z)
        return z

    def march_region(*a, **k):
        out = saved[1](*a, **k)
        CAP.update(pz=out[0].z_vals.numpy().copy(),
                   pxyz=out[1].numpy().copy())
        return out

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: CAP.update(grads=gr), grads)
        return saved[3](optimizer, c, state, grads)

    jocc.sample_pdf, prend.march_region = sample_pdf, march_region
    pnerf.BasicMLP.forward = _mlp_forward(off)
    jtrainer.apply_updates_guarded = capture
    try:
        base = jax.random.PRNGKey(0)
        js, ps = _states(jt, pt, STEP)
        js2, _ = jt._make_known_view_step()(js, base)
        jax.block_until_ready(js2)
        R = pt.kv_batch.rays_o.shape[1]
        _, pgrads = pt.known_view_step(ps, jax_known_view_draws(
            cfg, jt.renderer, base, STEP, 1, R))
    finally:
        (jocc.sample_pdf, prend.march_region, pnerf.BasicMLP.forward,
         jtrainer.apply_updates_guarded) = saved
    jg = params_from_jax(jax.tree.map(np.asarray, CAP["grads"]))
    bad = {}
    for name, grad in zip(dict(ps.renderer.named_parameters()), pgrads):
        ref = jg[name].numpy()
        scale = np.abs(ref).max()
        out = np.abs(grad.numpy() - ref) > 1e-3 * np.abs(ref) + 1e-3 * scale
        if out.any():
            bad[name] = np.argwhere(out)
    return cfg, bad


def main():
    cfg, bad = run()
    for name, idx in bad.items():
        print(f"{name}: {len(idx)} values outside; texels (plane, u, v) "
              f"{sorted(set(map(tuple, idx[:, :3].tolist())))}")
    print(f"sample depths |JAX - port| max {np.abs(CAP['jz'] - CAP['pz']).max():.3e}")
    # the sample whose footprint on each plane covers the first scale's
    # texels: its 2x2 corners hold all of them
    R0 = cfg.triplane_resolution
    u = (CAP["pxyz"].reshape(-1, 3) + cfg.bound) / (2 * cfg.bound) * (R0 - 1)
    tex = bad["field.triplanes.0"][:, :3]
    axes = ((0, 1), (0, 2), (1, 2))
    fits = [k for k in range(len(u)) if all(
        np.floor(u[k, axes[p][0]]) <= a <= np.floor(u[k, axes[p][0]]) + 1
        and np.floor(u[k, axes[p][1]]) <= b <= np.floor(u[k, axes[p][1]]) + 1
        for p, a, b in tex)]
    S = CAP["pz"].shape[1]
    for k in fits:
        for layer, pre in enumerate(CAP["pre"]):
            a = np.abs(pre[k])
            print(f"sample {k} (ray {k // S}, sample {k % S}): hidden layer "
                  f"{layer}'s smallest |pre-activation| {a.min():.3e} (unit "
                  f"{a.argmin()}), the layer's largest {np.abs(pre).max():.3e}")
    k = fits[0]
    layer = int(np.argmin([np.abs(p[k]).min() for p in CAP["pre"]]))
    unit = int(np.abs(CAP["pre"][layer][k]).argmin())
    _, bad = run(off=(layer, k, unit))
    print(f"with that ReLU off in the port: "
          f"{sum(len(i) for i in bad.values())} values outside")


if __name__ == "__main__":
    main()
