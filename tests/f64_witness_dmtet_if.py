"""A float64 witness for the DMTet step under the tiny IF.

Runs tests/test_torch_if.py's DMTet IF step (tet grid 8, the 16² raster
render, step 5) with the same parameters and draws: the jitted JAX step in
float32, the port's plain path in float32 and the port's plain path in
float64.  For each geometry gradient it prints how far each float32 side
lies from the float64 one, in units of the gradient's largest entry, and
splits that into its two sources: the image gradient (the SDS loss's, from
the UNet) and the render's backward, by running each float32 step again
with the float64 image gradient put in place of its own.

    JAX_PLATFORMS=cpu python tests/f64_witness_dmtet_if.py
"""

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
import torch  # noqa: E402

import dreamfusion_tpu.training.trainer as jtrainer  # noqa: E402
import dreamfusion_tpu_torch.training.dmtet_trainer as pdt  # noqa: E402
import test_torch_if as T  # noqa: E402
from dreamfusion_tpu.guidance.deepfloyd import IFConfig, IFGuidance  # noqa
from dreamfusion_tpu_torch.utils.convert import params_from_jax  # noqa: E402
from torch_parity import (float64_port, float64_state,  # noqa: E402
                          jax_dmtet_step_draws, widened)

NAMES = ("geo.sdf", "geo.deform")
BASE = jax.random.PRNGKey(0)


def _tmp():
    return pathlib.Path(tempfile.mkdtemp())


def _jp():
    return {"unet": T._unet_params(IFGuidance(IFConfig(tiny=True)).unet.cfg,
                                   11)}


def jax_grads(jp, image_grad=None):
    """The JAX step's geometry gradients and its image gradient; with
    ``image_grad`` the SDS loss is <image, image_grad>."""
    _, jt, js, _, _ = T.dmtet_if_pair(_tmp(), jp)
    captured = {}

    @jax.custom_vjp
    def tap(x):
        return x

    def tap_bwd(_, g):
        jax.debug.callback(lambda v: captured.update(image=np.asarray(v)), g)
        return (g,)

    tap.defvjp(lambda x: (x, None), tap_bwd)
    loss = jt._guidance_loss
    if image_grad is None:
        jt._guidance_loss = lambda gp, k, pred, batch, **kw: loss(
            gp, k, tap(pred), batch, **kw)
    else:
        g = jnp.asarray(image_grad)
        jt._guidance_loss = lambda gp, k, pred, batch, **kw: jnp.sum(pred * g)
    orig = jtrainer.apply_updates_guarded

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: captured.update(grads=gr), grads)
        return orig(optimizer, c, state, grads)

    jtrainer.apply_updates_guarded = capture
    try:
        js2, _ = jt._make_train_step("main")(js, BASE)
        jax.block_until_ready(js2)
    finally:
        jtrainer.apply_updates_guarded = orig
    g = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    return {n: g[n].double().numpy().ravel() for n in NAMES}, \
        captured.get("image")


def port_grads(jp, draws, f64=False, image_grad=None):
    """The port step's geometry gradients and its image gradient."""
    captured = {}
    loss = pdt.DMTetTrainer.guidance_loss

    def tapped(self, pred, *a, **k):
        pred.register_hook(lambda g: captured.update(image=g.double()))
        if image_grad is not None:
            return (pred * image_grad.to(pred.dtype)).sum()
        return loss(self, pred, *a, **k)

    pdt.DMTetTrainer.guidance_loss = tapped
    try:
        if f64:
            with float64_port():
                _, _, _, pt, ps = T.dmtet_if_pair(_tmp(), jp)
                _, grads = pt.train_step(float64_state(ps), widened(draws))
        else:
            _, _, _, pt, ps = T.dmtet_if_pair(_tmp(), jp)
            _, grads = pt.train_step(ps, draws)
    finally:
        pdt.DMTetTrainer.guidance_loss = loss
    g = dict(zip([n for n, _ in ps.model.named_parameters()], grads))
    return {n: g[n].double().numpy().ravel() for n in NAMES}, \
        captured["image"].numpy()


def _off(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


def main():
    torch.set_num_threads(4)
    jp = _jp()
    cfg = T.dmtet_if_pair(_tmp(), jp)[0]
    draws = jax_dmtet_step_draws(cfg, BASE, T.DMTET_STEP, pixel_size=16)
    j32, jimg = jax_grads(jp)
    p32, pimg = port_grads(jp, draws)
    p64, img64 = port_grads(jp, draws, f64=True)
    print(f"image gradient, |f32 - f64| / max: JAX {_off(jimg, img64):.3e}, "
          f"port {_off(pimg, img64):.3e}")
    jr, _ = jax_grads(jp, image_grad=img64.astype(np.float32))
    pr, _ = port_grads(jp, draws, image_grad=torch.from_numpy(img64))
    for n in NAMES:
        ref = p64[n]
        i = int(np.argmax(np.abs(j32[n] - p32[n])))
        print(f"{n}: |f32 - f64| / max, the whole step: JAX "
              f"{_off(j32[n], ref):.3e}, port {_off(p32[n], ref):.3e}; the "
              f"render's backward alone (the f64 image gradient): JAX "
              f"{_off(jr[n], ref):.3e}, port {_off(pr[n], ref):.3e}; where "
              f"the two f32 sides differ most (element {i}): JAX "
              f"{j32[n][i]:.8f}, port {p32[n][i]:.8f}, f64 {ref[i]:.8f}")


if __name__ == "__main__":
    main()
