"""The port's DPT (``dreamfusion_tpu_torch/models/dpt.py``) against the JAX
package's on the CPU: the weight-standardised conv with TF-SAME padding,
the -inf-padded max pool, both resize grids (align_corners=True and the
half-pixel grid without antialiasing) and the pos-embed resize, a tiny DPT
forward with the JAX weights carried over by ``params_from_jax``, the
full-width model on the meta device (JAX's parameter count, the omnidata
checkpoint's keys and shapes, K10's and K12's routes at 384²), and the
converter (``convert_dpt`` on a written ``.pt``; the ``--kind dpt`` CLI).

Tolerances: the pieces 1e-5 of the output's largest magnitude (fp32 sums
in another order), the tiny DPT 1e-4 of it (rtol 1e-4: twenty fp32
layers), the resize matrices' products 1e-6, converted weights bit for
bit.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.models import dpt as jdpt
from dreamfusion_tpu.ops.resize import resize_bilinear as j_resize
from dreamfusion_tpu_torch.models import dpt as pdpt
from dreamfusion_tpu_torch.ops import attention as K10
from dreamfusion_tpu_torch.ops import conv as K12
from dreamfusion_tpu_torch.ops.resize import interp_matrix, resize_bilinear
from dreamfusion_tpu_torch.utils import convert as PC

from torch_parity import random_flax_params

torch.set_num_threads(2)
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
TINY = dict(num_channels=3, features=32, vit_dim=64, vit_depth=2,
            vit_heads=2, vit_mlp=128, hooks=(0, 1), resnet_depths=(1, 1, 1),
            grid=6)


def _close(got, want, rel):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rel,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("k, stride, n", [(3, 2, 9), (7, 2, 20), (1, 2, 10),
                                          (3, 1, 6), (1, 1, 5)])
def test_std_conv_matches_jax(k, stride, n):
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.standard_normal((2, n, n, 5), dtype=np.float32)
    w = rng.standard_normal((k, k, 5, 7), dtype=np.float32)
    want = jdpt.StdConv(features=7, kernel_size=k, strides=stride).apply(
        {"params": {"kernel": jnp.asarray(w)}}, jnp.asarray(x))
    m = pdpt.StdConv(5, 7, k, stride)
    m.weight.copy_(torch.from_numpy(w.transpose(3, 0, 1, 2).copy()))
    _close(m(torch.from_numpy(x)), want, 1e-5)


@pytest.mark.parametrize("n", [10, 11, 192])
def test_max_pool_same_matches_jax(n):
    x = np.random.default_rng(n).standard_normal((1, n, n, 4),
                                                 dtype=np.float32)
    got = pdpt.max_pool_same(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jdpt._max_pool_same(jnp.asarray(x))))


@pytest.mark.parametrize("hw, out, ac, aa", [
    ((5, 7), (10, 14), True, True), ((12, 12), (24, 24), True, True),
    ((6, 6), (9, 9), True, True), ((24, 24), (4, 4), False, False),
    ((24, 24), (4, 4), False, True), ((8, 8), (20, 12), False, True)])
def test_resize_grids_match_jax(hw, out, ac, aa):
    x = np.random.default_rng(3).standard_normal((2, *hw, 3),
                                                 dtype=np.float32)
    want = j_resize(jnp.asarray(x), out, align_corners=ac, antialias=aa)
    got = resize_bilinear(torch.from_numpy(x), out, align_corners=ac,
                          antialias=aa)
    _close(got, want, 1e-6)
    # one matrix per (shape, grid, device), kept there
    assert interp_matrix(out[0], hw[0], got.device, ac, aa) is \
        interp_matrix(out[0], hw[0], got.device, ac, aa)


def _tiny_pair(seed=5):
    cfg = jdpt.DPTConfig(**TINY)
    jm = jdpt.DPTDepthModel(cfg)
    params = random_flax_params(jm.init, jnp.zeros((1, 64, 64, 3)),
                                seed=seed)
    pm = pdpt.DPTDepthModel(pdpt.DPTConfig(**TINY))
    pm.load_state_dict(PC.params_from_jax({"params": params}))
    return jm, params, pm


def test_pos_embed_resize_matches_jax():
    jm, params, pm = _tiny_pair()
    pos = np.asarray(params["vit"]["pos_embed"])[:, 1:]
    want = j_resize(jnp.asarray(pos.reshape(1, 6, 6, 64)), (4, 4),
                    antialias=False)
    got = resize_bilinear(pm.pretrained.model.pos_embed[:, 1:].reshape(
        1, 6, 6, 64), (4, 4), antialias=False)
    _close(got, want, 1e-6)


def test_tiny_dpt_matches_jax():
    """vit_depth 2, ResNet stages of one block, 64² input (the pos embed
    resized 6 → 4), normals head: the whole forward against JAX's."""
    jm, params, pm = _tiny_pair()
    x = np.random.default_rng(6).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
    got = pm(torch.from_numpy(x))
    assert got.shape == (2, 64, 64, 3) and got.dtype == torch.float32
    assert float(np.abs(np.asarray(want)).max()) > 0
    _close(got, want, 1e-4)


def _jax_count(cfg):
    m = jdpt.DPTDepthModel(cfg)
    t = jax.eval_shape(lambda k: m.init(k, jnp.zeros((1, 384, 384, 3))),
                       jax.random.PRNGKey(0))["params"]
    return sum(int(np.prod(l.shape)) for l in jax.tree_util.tree_leaves(t))


@pytest.mark.parametrize("task", ["depth", "normal"])
def test_full_dpt_on_meta_has_jax_count_keys_and_card_routes(task):
    """vitb_rn50_384 on the meta device: JAX's parameter count, the
    omnidata checkpoint's keys (all but the dead refinenet4.resConfUnit1)
    and shapes (conv [O, I, kh, kw] as the port's [O, kh, kw, I]), and the
    route every K12 conv and K10 attention of a 384² forward takes on the
    card: every conv fp32 on the tiled fp32 route (none left on
    conv_fwd_mma), every attention on the fp32 forward."""
    import chip_smoke
    cfg = getattr(pdpt.DPTConfig, task)()
    with torch.device("meta"):
        m = pdpt.DPTDepthModel(cfg)
    assert sum(p.numel() for p in m.parameters()) == \
        _jax_count(getattr(jdpt.DPTConfig, task)())
    with open(os.path.join(FIX, "omnidata_dpt_keys.json")) as f:
        inv = {k: tuple(v) for k, v in json.load(f).items()}
    if task == "normal":
        inv["scratch.output_conv.4.weight"] = (3, 32, 1, 1)
        inv["scratch.output_conv.4.bias"] = (3,)
    state = m.state_dict()
    dead = {k for k in inv if k.startswith(
        "scratch.refinenet4.resConfUnit1.")}
    assert len(dead) == 4 and set(state) == set(inv) - dead
    for k, v in state.items():
        want = inv[k]
        if len(want) == 4:
            want = (want[0], want[2], want[3], want[1])
        assert tuple(v.shape) == want, k
    convs, attns = chip_smoke.dpt_calls(cfg, 384)
    routes = {}
    for x_shape, w_shape, stride, _ in convs:
        O, kh, kw, I = w_shape
        r = K12.conv_route(torch.float32, I, O, (stride, stride), kh * kw)
        routes[r] = routes.get(r, 0) + 1
    for q_shape in attns:
        r = K10.attention_route(q_shape[-1], torch.float32)
        routes[r] = routes.get(r, 0) + 1
    assert routes == {"conv_fwd_fp32_tiled": 40, "attention_fwd_fp32": 12}
    assert attns[0] == (1, 577, 12, 64)
    # the stem, the 96² RCU convs, head_conv1 at 192² and head_conv2
    assert ((1, 384, 384, 3), (64, 7, 7, 3), 2, ((2, 3), (2, 3))) in convs
    assert ((1, 96, 96, 256), (256, 3, 3, 256), 1, ((1, 1), (1, 1))) in convs
    assert ((1, 192, 192, 256), (128, 3, 3, 256), 1,
            ((1, 1), (1, 1))) in convs
    assert ((1, 384, 384, 128), (32, 3, 3, 128), 1,
            ((1, 1), (1, 1))) in convs


@pytest.mark.parametrize("sms", [132, 114])
def test_fp32_tiling_fills_the_card_at_every_dpt_shape(sms):
    """The tiled fp32 route's tiling (``fp32_tiling``) at each of the 17
    distinct conv shapes of a 384² DPT forward, on an H100 SXM's 132 SMs
    and a PCIe part's 114: an N tile that fits O (32 for head_conv2's 32
    channels, 64 for 64), a split of at most 32 that leaves every split 8
    K steps, and at least `sms` blocks on the card or, where K cannot split
    that far, the most splits K allows; and ``conv_route`` sends every
    fp32 conv but the narrow route's (O <= 8, I % 4 == 0), at any stride
    and any I, to that route."""
    import chip_smoke
    convs, _ = chip_smoke.dpt_calls(pdpt.DPTConfig.depth(), 384)
    shapes = list(dict.fromkeys(convs))
    assert len(shapes) == 17
    for (B, H, W, I), (O, kh, kw, _), st, pads in shapes:
        assert K12.conv_route(torch.float32, I, O, (st, st), kh * kw) == \
            "conv_fwd_fp32_tiled"
        Ho, Wo = K12.out_size(H, W, kh, kw, (st, st), pads)
        M, K = B * Ho * Wo, kh * kw * I
        bn, splits = K12.fp32_tiling(M, O, K, sms)
        assert bn == (32 if O <= 32 else 64)
        top = max(1, min(32, -(-K // 16) // 8))
        assert 1 <= splits <= top
        blocks = -(-M // 128) * -(-O // bn) * splits
        assert blocks >= sms or splits == top, \
            ((B, H, W, I, O, kh, st), bn, splits, blocks)
    for I, O, st in ((3, 64, 2), (5, 9, 1), (64, 768, 1), (128, 200, 2),
                     (3, 8, 1)):
        assert K12.conv_route(torch.float32, I, O, (st, st), 9) == \
            "conv_fwd_fp32_tiled"
    # the narrow fp32 route keeps O <= 8 with I % 4 == 0
    assert K12.conv_route(torch.float32, 64, 8, (1, 1), 9) == "conv_fwd_fp32"


def _torch_state(pm):
    """The port model's state as an omnidata checkpoint holds it (conv
    [O, I, kh, kw]), under the Lightning wrapper's ``model.`` prefix."""
    out = {}
    for k, v in pm.state_dict().items():
        out["model." + k] = v.permute(0, 3, 1, 2).contiguous() \
            if v.dim() == 4 else v.clone()
    for c in (1, 2):
        w = torch.randn(32, 32, 3, 3)
        out[f"model.scratch.refinenet4.resConfUnit1.conv{c}.weight"] = w
        out[f"model.scratch.refinenet4.resConfUnit1.conv{c}.bias"] = \
            torch.randn(32)
    return {"state_dict": out}


def test_convert_dpt_reads_a_torch_checkpoint_bit_for_bit(tmp_path):
    """``convert_dpt`` on a ``.pt`` written in the checkpoint's layout
    (the Lightning prefix, the dead refinenet4 unit) gives the port model
    the same weights, and JAX's converter the same tree."""
    from dreamfusion_tpu.utils import convert as JC
    jm, params, pm = _tiny_pair()
    path = tmp_path / "omnidata_dpt_normal_v2.pt"
    torch.save(_torch_state(pm), path)
    got = pdpt.DPTDepthModel(pdpt.DPTConfig(**TINY))
    PC.convert_dpt(str(path), got)
    for k, v in pm.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    jt = JC.convert_dpt(str(path), {"params": params})
    back = PC.params_from_jax(jax.tree.map(np.asarray, jt))
    for k, v in pm.state_dict().items():
        assert torch.equal(back[k], v), k


def test_convert_cli_writes_the_dpt_npz(tmp_path, monkeypatch):
    """``python -m dreamfusion_tpu_torch.utils.convert --kind dpt`` writes
    ``dpt_normal.npz`` (JAX's ``save_params_npz`` layout), which
    ``load_dpt`` reads back to the same weights."""
    _, _, pm = _tiny_pair()
    path = tmp_path / "omnidata_dpt_normal_v2.pt"
    torch.save(_torch_state(pm), path)
    monkeypatch.setattr(pdpt.DPTConfig, "normal",
                        staticmethod(lambda: pdpt.DPTConfig(**TINY)))
    PC.main(["--kind", "dpt", "--src", str(path), "--out",
             str(tmp_path / "out")])
    npz = tmp_path / "out" / "dpt_normal.npz"
    assert npz.exists()
    back = pdpt.load_dpt(str(npz), pdpt.DPTConfig(**TINY), "cpu")
    for k, v in pm.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(
        np.float32), shapes)


def _jax_towers(kind):
    """JAX's tiny towers of `kind` as the converter CLI writes them:
    {file name: (port tower name, random Flax params)}."""
    key = jax.random.PRNGKey(0)
    if kind.startswith("sd"):
        from dreamfusion_tpu.guidance.sd import SDConfig, \
            StableDiffusionGuidance
        g = StableDiffusionGuidance(SDConfig(
            sd_version="1.5" if kind == "sd15" else "2.1", tiny=True,
            image_size=16, latent_size=8))
        p = jax.eval_shape(g.init_params, key)
        names = {"unet": "unet", "vae": "vae", "text": "text"}
    elif kind == "zero123":
        from dreamfusion_tpu.guidance.zero123 import (Zero123Config,
                                                      Zero123Guidance)
        p = jax.eval_shape(Zero123Guidance(Zero123Config(tiny=True))
                           .init_params, key)
        names = {k: k for k in ("unet", "vae", "vision", "cc_projection")}
    elif kind == "clip":
        from dreamfusion_tpu.guidance.clip import CLIPConfig, CLIPGuidance
        p = {"clip": jax.eval_shape(CLIPGuidance(CLIPConfig(tiny=True))
                                    .init_params, key)}
        names = {"clip": "clip"}
    else:
        from test_torch_if import _t5_params, _unet_params
        from dreamfusion_tpu.guidance.deepfloyd import IFConfig, IFGuidance
        g = IFGuidance(IFConfig(tiny=True))
        return {"unet": ("if_unet", _unet_params(g.unet.cfg, 3)),
                "t5": ("t5", _t5_params(4))}
    return {n: (t, _random_tree(p[n], i)) for i, (n, t) in
            enumerate(names.items())}


@pytest.mark.parametrize("kind", ["sd", "sd15", "zero123", "clip", "if"])
def test_tower_to_flax_inverts_params_from_jax(kind):
    """Every tower the converter CLI writes: JAX's Flax tree carried into
    the port (``params_from_jax``) and back (``tower_to_flax``) gives the
    same paths, shapes and values, the file JAX's ``save_params_npz``
    writes (the DPT's in the CLI test above)."""
    from dreamfusion_tpu_torch.utils.convert import (_flat, _port_levels,
                                                     tower_to_flax)
    for name, (tower, tree) in _jax_towers(kind).items():
        if tower == "clip":
            state = {f"{k}.{kk}": vv for k, v in
                     PC.params_from_jax(tree).items() for kk, vv in
                     v.items()}
        else:
            state = PC.params_from_jax({"unet" if tower == "if_unet" else
                                        tower: tree})
            state = state["unet" if tower == "if_unet" else tower]
        flat = dict(_flat(jax.tree.map(
            lambda a: np.asarray(a, np.float32), tree)))
        got = tower_to_flax(tower, state, _port_levels(tower, state))
        assert set(got) == set(flat), (name, sorted(set(got) ^ set(flat))[:6])
        for path, a in flat.items():
            assert got[path].shape == a.shape, (name, path)
            np.testing.assert_array_equal(got[path], a, err_msg=path)


def test_convert_cli_writes_clip_npz_as_jax_reads_it(tmp_path, monkeypatch):
    """``--kind clip`` on a transformers CLIP checkpoint (the tiny towers'
    JAX weights written in its layout): ``clip.npz`` holds JAX's tree bit
    for bit, and JAX's ``load_params_npz`` reads it into its template."""
    from dreamfusion_tpu.guidance.clip import CLIPConfig as JCLIPConfig
    from dreamfusion_tpu.guidance.clip import CLIPGuidance as JCLIP
    from dreamfusion_tpu.utils.params import load_params_npz
    from dreamfusion_tpu_torch.guidance import clip as pclip
    from dreamfusion_tpu_torch.utils.convert import _flat
    jg = JCLIP(JCLIPConfig(tiny=True))
    tree = _random_tree(jax.eval_shape(jg.init_params,
                                       jax.random.PRNGKey(0)), 7)
    state = PC.params_from_jax(tree)
    raw = {}
    for tower, sd in state.items():
        for k, v in sd.items():
            v = v.permute(0, 3, 1, 2) if v.dim() == 4 else v
            key = {"vision": "vision_model.", "text": "text_model."}.get(
                tower, "") + k
            if k.startswith("visual_projection."):
                key = k
            if tower == "text_projection":
                key = f"text_projection.{k}"
            raw[key] = v.contiguous()
    torch.save(raw, tmp_path / "pytorch_model.bin")
    real = pclip.CLIPConfig
    monkeypatch.setattr(pclip, "CLIPConfig", lambda: real(tiny=True))
    PC.main(["--kind", "clip", "--src", str(tmp_path / "pytorch_model.bin"),
             "--out", str(tmp_path / "out")])
    with np.load(tmp_path / "out" / "clip.npz") as f:
        got = {k: f[k] for k in f.files}
    want = dict(_flat(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   tree)))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = load_params_npz(str(tmp_path / "out" / "clip.npz"),
                           jax.eval_shape(jg.init_params,
                                          jax.random.PRNGKey(0)))
    for k, v in dict(_flat(jax.tree.map(np.asarray, back))).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
