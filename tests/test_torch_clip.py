"""CLIP guidance and the image + text recipe against the JAX package on the
CPU.

The tiny fp32 ``CLIPGuidance`` (ViT and text tower, ``text_projection``)
holding the same weights (``params_from_jax``): the image and text
embeddings, the hash tokens' pooling at row 0 (and at the first 49407
where there is one), the loss for each target set and its gradient into
the render; one image + text stage-1 step (tiny SD and tiny CLIP summed,
the image's and the prompt's targets; an SDS step and a known-view step)
and one DMTet step under SD + CLIP against the jitted JAX steps with the
same weights and draws; the CLIP eval metric of two states against JAX's
(the same one is the better); and ``config_from_args`` of the image + text
command lines against JAX's.

Tolerances: embeddings, loss and the render's gradient 1e-5 relative (a
floor of 1e-5 of the largest entry for the gradient: float32, sums in
another order); the steps as ``tests/test_torch_image.py`` and
``tests/test_torch_dmtet_sd.py`` hold theirs (loss 1e-5 rel; stage 1's
gradients rtol 1e-3 with a floor of 1e-3 of the largest, DMTet's 1e-4 and
1e-4; updated parameters 1e-5 where the gradient is clearly nonzero); the
eval metric 1e-4 absolute (×100 cosines).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dreamfusion_tpu.training.trainer as jtrainer
from dreamfusion_tpu.config import (Config, apply_dmtet, apply_image_text_mode,
                                    finalize)
from dreamfusion_tpu.guidance import clip as jclip
from dreamfusion_tpu.guidance.embeddings import HashTokenizer as JTok
from dreamfusion_tpu.guidance.sd import SDConfig as JSDConfig
from dreamfusion_tpu.guidance.sd import StableDiffusionGuidance as JSD
from dreamfusion_tpu.main import build_parser as j_build_parser
from dreamfusion_tpu.main import config_from_args as j_config_from_args
from dreamfusion_tpu.mesh import tets as jtets
from dreamfusion_tpu.training.dmtet_trainer import DMTetTrainer as JDMTet
from dreamfusion_tpu.training.image_data import \
    analytic_ref_images as j_ref_images
from dreamfusion_tpu_torch.config import Config as PConfig
from dreamfusion_tpu_torch.guidance import clip as pclip
from dreamfusion_tpu_torch.guidance.embeddings import prepare_text_embeddings
from dreamfusion_tpu_torch.guidance.sd import SDConfig, StableDiffusionGuidance
from dreamfusion_tpu_torch.main import build_parser, config_from_args, main
from dreamfusion_tpu_torch.models.clip import CLIPTextConfig, CLIPTextEncoder
from dreamfusion_tpu_torch.mesh import tets as ptets
from dreamfusion_tpu_torch.training.dmtet_trainer import DMTetTrainer
from dreamfusion_tpu_torch.training.image_data import RefImages
from dreamfusion_tpu_torch.training.trainer import Trainer, check_slice
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import (jax_dmtet_step_draws, jax_known_view_draws,
                          jax_sd_draws, jax_step_draws, port_cfg,
                          random_flax_params, tt, uncut_jax_tile_cap)

torch.set_num_threads(2)
TINY_SD = dict(tiny=True, image_size=16, latent_size=8)
PROMPT = "a hamburger"


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else \
        np.asarray(got, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def _clip_params(jc, seed=0):
    vc, tc = jc.cfg.vision_config(), jc.cfg.text_config()
    rng = np.random.default_rng(seed + 2)
    return jax.tree.map(np.asarray, {
        "vision": random_flax_params(
            jc.vision.init, jnp.zeros((1, vc.image_size, vc.image_size, 3)),
            seed=seed),
        "text": random_flax_params(jc.text.init, jnp.zeros(
            (1, tc.max_len), jnp.int32), seed=seed + 1),
        "text_projection": (rng.standard_normal(
            (tc.hidden_size, vc.projection_dim)) / np.sqrt(tc.hidden_size))
        .astype(np.float32)})


def _sd_params(jg, seed=7):
    z = jnp.zeros
    return jax.tree.map(np.asarray, {
        "unet": random_flax_params(jg.unet.init, z((1, 8, 8, 4)), z((1,)),
                                   z((1, 16, 32)), seed=seed),
        "vae": random_flax_params(jg.vae.init, z((1, 16, 16, 3)),
                                  jax.random.PRNGKey(1), seed=seed + 1),
        "text": random_flax_params(jg.text_encoder.init,
                                   z((1, 16), jnp.int32), seed=seed + 2)})


@pytest.fixture(scope="module")
def clip_pair():
    """JAX's and the port's tiny CLIP guidance with the same weights."""
    jc = jclip.CLIPGuidance(jclip.CLIPConfig(tiny=True))
    jp = _clip_params(jc)
    pc = pclip.CLIPGuidance(pclip.CLIPConfig(tiny=True), "cpu")
    pc.load_state_dicts(params_from_jax(jp))
    return jc, jp, pc


def _image(seed, size=16, B=1):
    return np.random.default_rng(seed).random((B, size, size, 3)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the towers, the embeddings and the loss
# ---------------------------------------------------------------------------

def test_embeddings_match_jax(clip_pair):
    """The image embedding (the resize to the tower's side, the ViT), the
    prompt's (hash tokens, pooled, projected) and prepare_embeddings'."""
    jc, jp, pc = clip_pair
    img = _image(1, 20, B=2)
    _close(pc.get_img_embeds(torch.from_numpy(img)),
           jax.jit(jc.get_img_embeds)(jp, jnp.asarray(img)))
    tc = jc.cfg.text_config()
    ids = JTok(tc.vocab_size, tc.max_len)(PROMPT)
    _close(pc.get_text_embeds(torch.from_numpy(ids).long()),
           jax.jit(jc.get_text_embeds)(jp, jnp.asarray(ids)))
    jz = jc.prepare_embeddings(jp, PROMPT, img[0])
    pz = pc.prepare_embeddings(PROMPT, img[0])
    assert sorted(pz) == sorted(jz) == ["image", "text"]
    for k in jz:
        assert tuple(pz[k].shape) == tuple(jz[k].shape)
        _close(pz[k], jz[k])
    assert pc.prepare_embeddings(None, None) == {} == \
        jc.prepare_embeddings(jp, None, None)


def test_hash_tokens_pool_row_0(clip_pair):
    """The hash tokenizer's EOS is 1: no id is CLIP's 49407, so JAX's
    argmax picks row 0, and the port's too; a prompt holding 49407 pools
    its first occurrence on both sides."""
    jc, jp, pc = clip_pair
    tc = jc.cfg.text_config()
    ids = JTok(tc.vocab_size, tc.max_len)(PROMPT)
    assert not (ids == 49407).any()
    pooled = pc.text.pooled(torch.from_numpy(ids).long())
    _close(pooled, pc.text(torch.from_numpy(ids).long())[:, 0])
    # a text tower with CLIP's vocabulary: 49407 at positions 3 and 5
    tcfg = dataclasses.replace(tc, vocab_size=49408)
    jt = jclip.CLIPTextEncoder(tcfg)
    jtp = jax.tree.map(np.asarray, random_flax_params(
        jt.init, jnp.zeros((1, tc.max_len), jnp.int32), seed=4))
    pt = CLIPTextEncoder(dataclasses.replace(CLIPTextConfig.tiny(),
                                             vocab_size=49408))
    pt.load_state_dict(params_from_jax({"text": jtp})["text"])
    ids2 = np.array([[0, 7, 9, 49407, 3, 49407] + [49407] * (tc.max_len - 6),
                     [0, 5, 6, 8, 49407, 1] + [1] * (tc.max_len - 6)],
                    np.int32)
    want = jax.jit(lambda p, i: jt.apply({"params": p}, i,
                                         method=jt.pooled))(jtp, ids2)
    got = pt.pooled(torch.from_numpy(ids2).long())
    _close(got, want)
    _close(got[0], pt(torch.from_numpy(ids2).long())[0, 3])


@pytest.mark.parametrize("targets", [("text",), ("image",),
                                     ("image", "text")])
def test_loss_and_render_gradient_match_jax(clip_pair, targets):
    """−mean cos·grad_scale per target, and its gradient through the
    preprocess and the vision tower into the render (64² → the tower's
    32²: an upsampling resize, as 64² → 224² at full width)."""
    jc, jp, pc = clip_pair
    ref = _image(3)[0]
    jz = {k: v for k, v in jc.prepare_embeddings(jp, PROMPT, ref).items()
          if k in targets}
    pz = {k: tt(v) for k, v in jz.items()}
    rgb = _image(4, 64, B=2)
    w = np.float32(7.5)
    want, jgrad = jax.jit(jax.value_and_grad(
        lambda x: jc.loss(jp, jz, x, grad_scale=w)))(jnp.asarray(rgb))
    x = torch.from_numpy(rgb).requires_grad_()
    got = pc.loss(pz, x, torch.tensor(w))
    (grad,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    _close(grad, jgrad)
    assert float(np.abs(np.asarray(jgrad)).max()) > 0


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _capture(monkeypatch):
    captured = {}
    orig = jtrainer.apply_updates_guarded

    def capture(optimizer, c, state, grads):
        jax.debug.callback(lambda gr: captured.update(grads=gr), grads)
        return orig(optimizer, c, state, grads)

    monkeypatch.setattr(jtrainer, "apply_updates_guarded", capture)
    return captured


def _check_grads(pgrads, captured, js2, module, rtol, prefixes):
    """Each watched parameter's gradient and its update against JAX's."""
    names = [n for n, _ in module.named_parameters()]
    jgr = params_from_jax(jax.tree.map(np.asarray, captured["grads"]))
    new_j = params_from_jax(jax.tree.map(np.asarray, js2.params))
    params = dict(module.named_parameters())
    checked = 0
    for name, grad in zip(names, pgrads):
        if not name.startswith(prefixes) and not any(
                p in name for p in prefixes):
            continue
        ref = jgr[name].numpy()
        scale = np.abs(ref).max()
        if scale == 0:
            assert not grad.numpy().any(), name
            continue
        np.testing.assert_allclose(grad.numpy(), ref, rtol=rtol,
                                   atol=rtol * scale, err_msg=name)
        clear = np.abs(ref) > 1e-2 * scale
        np.testing.assert_allclose(params[name].detach().numpy()[clear],
                                   new_j[name].numpy()[clear], atol=1e-5,
                                   err_msg=name)
        checked += 1
    assert checked > 0


def _guidance_pairs(clip_pair, t_range):
    """(JAX guidances, params, embeddings; the port's SD and CLIP with
    their embeddings) for SD + CLIP on the analytic reference."""
    jc, jcp, pc = clip_pair
    jg = JSD(JSDConfig(t_range=t_range, **TINY_SD))
    jp = _sd_params(jg)
    pg = StableDiffusionGuidance(SDConfig(t_range=t_range, **TINY_SD), "cpu")
    pg.load_state_dicts(params_from_jax(jp))
    emb = prepare_text_embeddings(pg, PROMPT, "")
    return jg, jp, pg, emb


def _sd_clip_draws(draws, base, step, n_split, t_range):
    """JAX hands each of its sorted priors one key of the guide key's
    split: SD takes the first of two."""
    key = jax.random.fold_in(base, step)
    k_guide = jax.random.split(key, n_split)[3 if n_split == 5 else 2]
    t, noise, post = jax_sd_draws(jax.random.split(k_guide, 2)[0], 1, 8,
                                  t_range)
    return draws._replace(t=t, noise=noise, posterior_noise=post)


def _stage1_cfg(tmp_path):
    cfg = finalize(apply_image_text_mode(Config(
        image="analytic:two_sphere", text=PROMPT,
        workspace=str(tmp_path / "ws"), w=16, h=16, iters=400, batch_size=1,
        triplane_resolution=32, triplane_channels=8, triplane_scales=2,
        hidden_dim=32, grid_size=30, grid_coarse_steps=24,
        grid_fine_steps=24, fp16=False, seed=0, eval_interval=-1,
        use_tensorboard=False, lr=1e-2, backbone="triplane")))
    return dataclasses.replace(cfg, lambda_3d_normal_smooth=0.0)


@pytest.mark.parametrize("kind", ["SDS", "known-view"])
def test_one_image_text_step_matches_jax(tmp_path, monkeypatch, clip_pair,
                                         kind):
    """``--image`` with ``--text`` (SD + CLIP, no background MLP, known
    views every 2nd step) on the analytic reference, from the same field:
    an SDS step after the warm-up (SD's SDS through the tiny VAE and CLIP's
    term toward the image and the prompt), or a known-view step."""
    cfg = _stage1_cfg(tmp_path)
    assert cfg.guidance == ("SD", "clip") and cfg.bg_radius == -1.0
    assert cfg.known_view_interval == 2 and cfg.t_range == (0.2, 0.6)
    jc, jcp, pc = clip_pair
    jg, jp, pg, emb = _guidance_pairs(clip_pair, cfg.t_range)
    ref = j_ref_images(cfg, cfg.h, cfg.w, "two_sphere")
    jz = jc.prepare_embeddings(jcp, cfg.text, ref.rgb[0])
    pref = RefImages(**{f.name: getattr(ref, f.name)
                        for f in dataclasses.fields(RefImages)})
    pz = pc.prepare_embeddings(cfg.text, pref.rgb[0])
    for k in jz:
        _close(pz[k], jz[k])
    jt = jtrainer.Trainer(
        cfg, guidances={"SD": jg, "clip": jc},
        guidance_params={"SD": jp, "clip": jcp},
        embeddings={"SD": {k: jnp.asarray(v.numpy()) for k, v in emb.items()},
                    "clip": jz}, ref_images=ref)
    pt = Trainer(port_cfg(cfg), "cpu", pg, emb, ref_images=pref, clip=pc,
                 clip_z={k: tt(v) for k, v in jz.items()})
    step = 101 if kind == "SDS" else 104
    assert pt.is_known_view_step(step) == (kind == "known-view")
    assert not pt.latent_phase(step)
    captured = _capture(monkeypatch)
    base = jax.random.PRNGKey(0)
    js = jt.init_state(jax.random.PRNGKey(0)).replace(
        step=jnp.asarray(step, jnp.int32))
    ps = pt.init_state(0)
    sd = params_from_jax(jax.tree.map(np.asarray, js.params))
    ps.renderer.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    ps.step = step
    if kind == "SDS":
        js2, jm = jt._make_train_step("main")(js, base)
        draws = _sd_clip_draws(jax_step_draws(cfg, jt.renderer, base, step, 8),
                               base, step, 5, cfg.t_range)
        pm, pgrads = pt.train_step(ps, draws)
        np.testing.assert_allclose(float(pm["loss_sds"]),
                                   float(jm["loss_sds"]), rtol=1e-5)
    else:
        js2, jm = jt._make_known_view_step()(js, base)
        R = pt.kv_batch.rays_o.shape[1]
        pm, pgrads = pt.known_view_step(ps, jax_known_view_draws(
            cfg, jt.renderer, base, step, 1, R))
    jax.block_until_ready(js2)
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    _check_grads(pgrads, captured, js2, ps.renderer, 1e-3,
                 ("field.triplanes", "field.sigma_net"))


def test_the_clip_term_is_in_the_step(tmp_path, clip_pair):
    """SD + CLIP's loss is SD's plus CLIP's weighted term: the same step
    without CLIP differs by exactly the CLIP loss at the step's weight."""
    cfg = port_cfg(_stage1_cfg(tmp_path))
    jc, jcp, pc = clip_pair
    _, _, pg, emb = _guidance_pairs(clip_pair, cfg.t_range)
    pz = pc.prepare_embeddings(cfg.text, None)
    pt = Trainer(cfg, "cpu", pg, emb, clip=pc, clip_z=pz)
    ps = pt.init_state(0)
    ps.step = 101
    draws = pt.draw_step(torch.Generator().manual_seed(3))
    pred, _, batch, bg = pt.render_part(ps, draws, False)
    pred = pred.detach()
    both = pt.guidance_loss(pred, batch, draws, bg, False)
    sd_only = pt.prior_loss("SD", pred, batch, draws, bg, False)
    w = 10.0 * (1.0 - float(batch.delta_azimuth[0].abs()) / 180.0)
    torch.testing.assert_close(both - sd_only, pc.loss(pz, pred, w),
                               rtol=1e-5, atol=1e-6)


def test_one_dmtet_sd_clip_step_matches_jax(tmp_path, monkeypatch,
                                            clip_pair):
    """The DMTet stage of the image + text recipe (``apply_dmtet`` after
    ``apply_image_text_mode``): one SDS step under SD + CLIP (the 16²
    raster render through the tiny VAE, CLIP's term toward the image and
    the prompt) against the jitted JAX DMTet step."""
    from test_torch_dmtet_sd import _geometry
    STEP = 7
    cfg = finalize(apply_dmtet(apply_image_text_mode(Config(
        image="analytic:two_sphere", text=PROMPT,
        workspace=str(tmp_path / "ws"), backbone="triplane", w=2, h=2,
        iters=100, batch_size=1, triplane_resolution=32, triplane_channels=8,
        hidden_dim=32, num_layers=3, fp16=False, seed=0, eval_interval=-1,
        tet_grid_size=12, use_tensorboard=False, lr=2e-3))))
    assert cfg.guidance == ("SD", "clip") and cfg.h == cfg.w == 16
    assert cfg.t_range == (0.02, 0.5) and cfg.known_view_interval == 2
    jc, jcp, pc = clip_pair
    jg, jp, pg, emb = _guidance_pairs(clip_pair, cfg.t_range)
    ref = j_ref_images(cfg, 16, 16, "two_sphere")
    jz = jc.prepare_embeddings(jcp, cfg.text, ref.rgb[0])
    pref = RefImages(**{f.name: getattr(ref, f.name)
                        for f in dataclasses.fields(RefImages)})
    grid = jtets.generate_tet_grid(8)
    jt = JDMTet(cfg, tet_grid=grid, guidances={"SD": jg, "clip": jc},
                guidance_params={"SD": jp, "clip": jcp},
                embeddings={"SD": {k: jnp.asarray(v.numpy())
                                   for k, v in emb.items()}, "clip": jz},
                ref_images=ref)
    pt = DMTetTrainer(port_cfg(cfg), "cpu", pg, emb,
                      tet_grid=ptets.generate_tet_grid(8), ref_images=pref,
                      clip=pc, clip_z={k: tt(v) for k, v in jz.items()})
    assert not pt.is_known_view_step(STEP)
    js = jt.init_state(jax.random.PRNGKey(0))
    pos, sdf = _geometry(grid, 3)
    geo = {"sdf": jnp.asarray(sdf),
           "deform": jnp.asarray(np.arctanh(np.clip(
               (pos - grid.vertices) * 2 * grid.resolution, -0.9, 0.9)))}
    params = {**js.params, "geo": geo}
    js = js.replace(step=jnp.asarray(STEP, jnp.int32), params=params,
                    ema_params=params)
    ps = pt.init_state(0)
    sd = params_from_jax(jax.tree.map(np.asarray, {
        **js.params, "tet_scale": js.tet_scale}))
    ps.tet_scale = sd.pop("tet_scale")
    ps.model.load_state_dict(sd)
    for k, v in ps.ema_params.items():
        v.copy_(sd[k])
    ps.step = STEP
    uncut_jax_tile_cap(jt, pt, ps)
    captured = _capture(monkeypatch)
    base = jax.random.PRNGKey(0)
    js2, jm = jt._make_train_step("main")(js, base)
    jax.block_until_ready(js2)
    draws = _sd_clip_draws(jax_dmtet_step_draws(cfg, base, STEP,
                                                latent_size=8),
                           base, STEP, 3, cfg.t_range)
    pm, pgrads = pt.train_step(ps, draws)
    for k in ("loss", "loss_sds"):
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert bool(pm["grad_ok"]) and bool(jm["grad_ok"])
    _check_grads(pgrads, captured, js2, ps.model, 1e-4,
                 ("geo.", "triplanes"))


# ---------------------------------------------------------------------------
# the eval metric
# ---------------------------------------------------------------------------

def test_clip_eval_metric_matches_jax(tmp_path, clip_pair):
    """A text run's CLIP score of its EMA eval renders: the port's against
    JAX's ``_clip_eval_metric`` for the init and for a perturbed field; the
    same state scores higher on both sides (``--ckpt best`` keeps it)."""
    jc, jcp, pc = clip_pair
    cfg = finalize(Config(
        text=PROMPT, guidance=("SD",), workspace=str(tmp_path / "ws"), w=16,
        h=16, batch_size=1, triplane_resolution=32, triplane_channels=8,
        hidden_dim=32, grid_size=30, grid_coarse_steps=24,
        grid_fine_steps=24, fp16=False, seed=0, dataset_size_valid=3,
        use_tensorboard=False, backbone="triplane"))
    jz = jc.prepare_embeddings(jcp, cfg.text)
    jt = jtrainer.Trainer(cfg)
    jt.set_clip_scorer(jc, jcp, jz)
    pt = Trainer(dataclasses.replace(port_cfg(cfg), test=True), "cpu")
    pt.set_clip_scorer(pc, {k: tt(v) for k, v in jz.items()})
    scores = []
    js = jt.init_state(jax.random.PRNGKey(0))
    ps = pt.init_state(0)
    rng = np.random.default_rng(11)
    for i in range(2):
        if i:
            planes = js.ema_params["field"]["triplanes"]
            bumped = [np.asarray(p) + 0.5 * rng.standard_normal(
                p.shape).astype(np.float32) for p in planes]
            field = {**js.ema_params["field"], "triplanes": bumped}
            js = js.replace(ema_params={**js.ema_params, "field": field})
        sd = params_from_jax(jax.tree.map(np.asarray, js.ema_params))
        for k, v in ps.ema_params.items():
            v.copy_(sd[k])
        want = jt._clip_eval_metric(js)
        got = pt.eval_metric(ps)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        scores.append((got, want))
    assert (scores[0][0] > scores[1][0]) == (scores[0][1] > scores[1][1])
    assert scores[0][1] != scores[1][1]


def test_cli_installs_the_clip_scorer(tmp_path):
    """A tiny text run with evals scores them with CLIP and keeps the best
    snapshot by it; an image run keeps its known-view metric."""
    out = main(["--text", PROMPT, "--backbone", "triplane", "--iters", "2",
                "--w", "8", "--h", "8", "--H", "8", "--W", "8",
                "--triplane_resolution", "16", "--triplane_channels", "4",
                "--grid_size", "16", "--hidden_dim", "16",
                "--dataset_size_train", "1", "--dataset_size_test", "1",
                "--dataset_size_valid", "2", "--workspace",
                str(tmp_path / "ws"), "--device", "cpu", "--tiny_guidance",
                "--ckpt", "scratch"])
    assert out["grad_ok"]
    log = (tmp_path / "ws" / "log_df.txt").read_text()
    assert "eval metric: the CLIP score (a scorer)" in log
    meta = (tmp_path / "ws" / "checkpoints" / "df.meta.json").read_text()
    assert '"best_result": null' not in meta


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

IMAGE_TEXT = ["--image", "ref.png", "--text", PROMPT, "--backbone",
              "triplane", "--lambda_entropy", "0.5"]


@pytest.mark.parametrize("extra", [
    [], ["--dont_override_stuff"], ["--dmtet", "--init_with", "ws/ckpts"],
    ["--dmtet", "--dont_override_stuff"], ["--guidance_scale", "3"],
    ["--zero123_ckpt", "zero123-xl.ckpt", "--zero123_config", "x.yaml",
     "--clip_eval", "false"],
])
def test_cli_image_text_config_matches_jax(extra):
    """The finished Config of the image + text command lines (and JAX's
    zero123_config, zero123_ckpt and clip_eval fields), field by field."""
    p = config_from_args(build_parser().parse_args(IMAGE_TEXT + extra))
    j = j_config_from_args(j_build_parser().parse_args(IMAGE_TEXT + extra))
    for f in dataclasses.fields(PConfig):
        assert getattr(p, f.name) == getattr(j, f.name), f.name
    assert p.guidance == ("SD", "clip") and p.bg_radius == -1.0
    if "--dont_override_stuff" not in extra:
        assert p.guidance_scale == 10.0 and p.known_view_interval == 2
    check_slice(p)


@pytest.mark.parametrize("guidance,image,ok", [
    (("SD", "clip"), "ref.png", True), (("clip",), None, True),
    (("SD", "clip"), None, True), (("clip", "SD"), None, True),
    (("SD",), "config", True), (("clip",), "config", True),
    (("zero123", "clip"), "config", True), (("SD", "zero123"), None, False),
])
def test_check_slice_admits_the_clip_guidance_sets(guidance, image, ok):
    """Every set JAX's main builds; zero123 without a reference image is
    what JAX refuses."""
    cfg = PConfig(text=PROMPT, guidance=guidance,
                  image=image if image != "config" else None,
                  image_config="refs.csv" if image == "config" else None)
    if ok:
        check_slice(cfg)
        return
    with pytest.raises(ValueError, match="needs a reference image"):
        check_slice(cfg)
