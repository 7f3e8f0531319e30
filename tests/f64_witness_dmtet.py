"""A float64 witness for the image-oracle DMTet step's gradients.

Runs tests/test_torch_image.py's image-oracle DMTet step (K5 at 0.01, tet
grid 16, 32², step 7) three ways with the same parameters and draws, each
listing every triangle of the one tile (no tile_cap cut): the jitted JAX
step in float32, the port's plain path in float32, and the port's plain
path in float64 (the float32 casts and factories of the port widened for
the run).  For each geometry gradient it prints how far each float32 side
lies from the float64 one, in units of the gradient's largest entry, at
the worst element and where the two float32 sides disagree most.

    JAX_PLATFORMS=cpu python tests/f64_witness_dmtet.py
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

import numpy as np  # noqa: E402
import torch  # noqa: E402

import dreamfusion_tpu.training.trainer as jtrainer  # noqa: E402
import test_torch_image as T  # noqa: E402
from dreamfusion_tpu_torch.utils.convert import params_from_jax  # noqa: E402
from torch_parity import (float64_port, float64_state,  # noqa: E402
                          jax_dmtet_step_draws, widened)

NAMES = ("geo.sdf", "geo.deform")


def _pair():
    return T._dmtet_pair(pathlib.Path(tempfile.mkdtemp()),
                         grad_clip_rgb=0.01)


def _grads(pt, ps, draws):
    names = [n for n, _ in ps.model.named_parameters()]
    pm, pgrads = pt.train_step(ps, draws)
    g = dict(zip(names, pgrads))
    return {n: g[n].double().numpy().ravel() for n in NAMES}, \
        int(pm["tile_max"])


def jax_and_port32():
    cfg, jt, js, pt, ps = _pair()
    base = jax.random.PRNGKey(0)
    captured = {}
    orig = jtrainer.apply_updates_guarded

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: captured.update(grads=gr), grads)
        return orig(optimizer, c, state, grads)

    jtrainer.apply_updates_guarded = capture
    try:
        js2, _ = jt._make_train_step("main")(js, base)
        jax.block_until_ready(js2)
    finally:
        jtrainer.apply_updates_guarded = orig
    jg = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    draws = jax_dmtet_step_draws(cfg, base, 7)
    p32, tiles = _grads(pt, ps, draws)
    return ({n: jg[n].double().numpy().ravel() for n in NAMES}, p32, draws,
            tiles)


def port64(draws):
    """The port's step with float32 widened to float64 throughout."""
    with float64_port():
        _, _, _, pt, ps = _pair()
        return _grads(pt, float64_state(ps), widened(draws))


def main():
    torch.set_num_threads(4)
    j32, p32, draws, tiles = jax_and_port32()
    p64, tiles64 = port64(draws)
    print(f"fullest tile {tiles} (f32), {tiles64} (f64); lists uncut")
    for n in NAMES:
        ref = p64[n]
        scale = np.abs(ref).max()
        ej, ep = np.abs(j32[n] - ref) / scale, np.abs(p32[n] - ref) / scale
        i = int(np.argmax(np.abs(j32[n] - p32[n])))
        print(f"{n}: |JAX f32 - f64| / max {ej.max():.3e}, |port f32 - "
              f"f64| / max {ep.max():.3e}; where the two f32 sides differ "
              f"most (element {i}, |JAX - port| / max "
              f"{abs(j32[n][i] - p32[n][i]) / scale:.3e}): JAX "
              f"{j32[n][i]:.8f}, port {p32[n][i]:.8f}, f64 {ref[i]:.8f}")


if __name__ == "__main__":
    main()
