"""Raw checkpoints (``--pretrained_root`` pointing at a diffusers directory
or a ``.ckpt``) against the JAX package's converter on the CPU.

The port's ``.safetensors`` reader against ``safetensors``; the restricted
``.ckpt`` load of a file that pickles a class which cannot be imported at
load time; for each layout (a diffusers directory of ``.safetensors``, one
of ``.bin`` files with the UNet sharded behind an index, an SD CompVis
``.ckpt`` with its text tower and one without it (SD 2.x's open_clip), a
zero123 ``.ckpt`` with EMA weights and the OpenAI ViT) a tiny checkpoint
written from seeded numpy, converted by JAX's ``convert_sd`` /
``convert_zero123`` and loaded by the port: the port's towers equal
``params_from_jax`` of JAX's result bit for bit.  JAX's ``convert_sd``
reads one file a tower and does not follow a shard index (its
``load_dir_state_dict`` does): the sharded directory is held against
JAX's conversion of the same tensors in one file.  Then full-width key
coverage on the meta device from the published checkpoints' key
inventories (``tests/fixtures``): every fixture key is consumed and every
port parameter is filled at a fitting shape.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dreamfusion_tpu.guidance import zero123 as jz
from dreamfusion_tpu.guidance.sd import SDConfig as JSDConfig
from dreamfusion_tpu.guidance.sd import StableDiffusionGuidance as JSD
from dreamfusion_tpu.utils import convert as C
from dreamfusion_tpu_torch.guidance import zero123 as pz
from dreamfusion_tpu_torch.guidance.sd import SDConfig, StableDiffusionGuidance
from dreamfusion_tpu_torch.models.clip import (CLIPTextConfig,
                                               CLIPTextEncoder,
                                               CLIPVisionConfig,
                                               CLIPVisionEncoder)
from dreamfusion_tpu_torch.models.unet import (Dense, UNet2DCondition,
                                               UNetConfig)
from dreamfusion_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from dreamfusion_tpu_torch.utils import raw_weights as R
from dreamfusion_tpu_torch.utils.convert import params_from_jax

from torch_parity import random_flax_params

torch.set_num_threads(2)
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
TINY_SD = dict(tiny=True, image_size=16, latent_size=8)
LINEAR_1X1 = ("to_q", "to_k", "to_v", "to_out", "proj_in", "proj_out")


# ---------------------------------------------------------------------------
# the file readers
# ---------------------------------------------------------------------------

def test_safetensors_reader_matches_safetensors(tmp_path):
    from safetensors import safe_open
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(4, 5, generator=g),
               "b": torch.randn(3, 2, 7, generator=g).half(),
               "c": torch.randn(6, generator=g).bfloat16(),
               "d.bias": torch.randn((), generator=g),
               "e": torch.zeros(0, 3), "ids": torch.arange(5)}
    path = str(tmp_path / "m.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    got = R.read_safetensors(path)
    assert sorted(got) == sorted(tensors)
    with safe_open(path, framework="pt") as f:
        for k in f.keys():
            want = f.get_tensor(k)
            assert got[k].dtype == want.dtype and got[k].shape == want.shape
            assert torch.equal(got[k], want), k
    assert R.load_torch_state_dict(path).keys() == got.keys()


def test_restricted_load_stubs_a_class_it_cannot_import(tmp_path):
    """A Lightning-style ``.ckpt``: the state dict beside a callback object
    and a config whose classes are gone at load time (a plain
    ``torch.load`` fails), and beside numpy values: the tensors load, the
    rest is inert."""
    mod = tmp_path / "gone_at_load_time.py"
    mod.write_text("class Callback:\n    def __init__(self):\n"
                   "        self.state = {'best': 1.5}\n"
                   "class HParams(dict):\n    pass\n")
    sd = {"model.w": torch.randn(3, 4), "model.b": torch.randn(4).half()}
    code = ("import sys, numpy, torch\n"
            f"sys.path.insert(0, {str(tmp_path)!r})\n"
            "import gone_at_load_time as m\n"
            "h = m.HParams(lr=1.0)\n"
            f"sd = torch.load({str(tmp_path / 'sd.pt')!r})\n"
            "torch.save({'state_dict': sd, 'callbacks': {'cb': m.Callback()},"
            " 'hyper_parameters': h, 'extra': numpy.arange(3), "
            "'global_step': 7, 'blob': b'\\x00\\xff'}, "
            f"{str(tmp_path / 'l.ckpt')!r})\n")
    torch.save(sd, tmp_path / "sd.pt")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    mod.unlink()
    path = str(tmp_path / "l.ckpt")
    with pytest.raises(Exception, match="gone_at_load_time"):
        torch.load(path, weights_only=False)
    raw = R.load_pickled(path)
    assert raw["global_step"] == 7 and raw["blob"] == b"\x00\xff"
    assert type(raw["callbacks"]["cb"]).__name__ == "Callback"
    assert not hasattr(raw["callbacks"]["cb"], "state")
    got = R.load_torch_state_dict(path)
    assert sorted(got) == sorted(sd)
    for k in sd:
        assert got[k].dtype == sd[k].dtype and torch.equal(got[k], sd[k])
    assert "gone_at_load_time" not in sys.modules


# ---------------------------------------------------------------------------
# tiny checkpoints in each layout, against JAX's converter
# ---------------------------------------------------------------------------

def _torch_layout(path, a, linear_1x1):
    """A Flax leaf as the torch checkpoint stores it; `linear_1x1`: 1×1
    convs of diffusers' linear modules stored as linears."""
    if a.ndim == 4:
        if linear_1x1 and a.shape[:2] == (1, 1) and \
                any(f"/{n}/" in f"/{path}" for n in LINEAR_1X1):
            return a[0, 0].T
        return a.transpose(3, 2, 0, 1)
    if a.ndim == 2 and path.endswith("kernel"):
        return a.T
    return a


def _state(tree, mapper, rng, linear_1x1=False, dtype=np.float32):
    """A checkpoint's {key: array} for the Flax `tree`'s shapes, filled from
    `rng`, under `mapper`'s keys."""
    out = {}
    for path, leaf in C._flax_paths(tree):
        a = rng.standard_normal(leaf.shape).astype(np.float32)
        out[mapper(path)] = _torch_layout(path, a, linear_1x1).astype(dtype)
    return out


def _save_st(d, name, sd):
    from safetensors.numpy import save_file
    os.makedirs(d, exist_ok=True)
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()},
              os.path.join(d, name))


def _save_pt(path, sd, wrap=None):
    obj = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    if wrap is not None:
        obj = {**wrap, "state_dict": obj}
    torch.save(obj, path)


def _sd_template(jg, seed):
    z = jnp.zeros
    return jax.tree.map(np.asarray, {
        "unet": random_flax_params(jg.unet.init, z((1, 8, 8, 4)), z((1,)),
                                   z((1, 16, 32)), seed=seed),
        "vae": random_flax_params(jg.vae.init, z((1, 16, 16, 3)),
                                  jax.random.PRNGKey(1), seed=seed + 1),
        "text": random_flax_params(jg.text_encoder.init,
                                   z((1, 16), jnp.int32), seed=seed + 2)})


def _check_towers(pg, jparams, names, keep=None):
    """The port's towers hold params_from_jax(JAX's result) bit for bit;
    `keep`: {tower: its state before loading}, towers JAX left as they
    were."""
    want = params_from_jax(jax.tree.map(np.asarray, {
        k: jparams[k] for k in names}))
    for name in names:
        got = pg.towers()[name].state_dict()
        assert set(got) == set(want[name]), name
        for k, v in want[name].items():
            np.testing.assert_array_equal(got[k].float().numpy(), v.numpy(),
                                          err_msg=f"{name}.{k}")
    for name, before in (keep or {}).items():
        for k, v in pg.towers()[name].state_dict().items():
            assert torch.equal(v, before[k]), f"{name}.{k}"


def _write_sd(kind, jg, tmp_path):
    """A tiny SD checkpoint of layout `kind` → its path."""
    rng = np.random.default_rng(3)
    src = _sd_template(jg, 11)
    ucfg, vcfg = jg.unet.cfg, jg.vae.cfg
    if kind.startswith("diffusers"):
        unet = _state(src["unet"], C.unet_mapper_diffusers(ucfg), rng, True)
        vae = _state(src["vae"], C.vae_mapper(vcfg, "diffusers"), rng, True,
                     np.float16)
        text = _state(src["text"], C.clip_text_mapper(), rng)
        root = tmp_path / kind
        if kind == "diffusers_safetensors":
            _save_st(root / "unet", "diffusion_pytorch_model.safetensors",
                     unet)
            _save_st(root / "vae", "diffusion_pytorch_model.safetensors", vae)
            _save_st(root / "text_encoder", "model.safetensors", text)
        else:
            keys = sorted(unet)
            shards = {"diffusion_pytorch_model-00001-of-00002.bin": keys[::2],
                      "diffusion_pytorch_model-00002-of-00002.bin":
                          keys[1::2]}
            (root / "unet").mkdir(parents=True)
            for fname, ks in shards.items():
                _save_pt(root / "unet" / fname, {k: unet[k] for k in ks})
            (root / "unet" / "diffusion_pytorch_model.bin.index.json"
             ).write_text(json.dumps({"weight_map": {
                 k: f for f, ks in shards.items() for k in ks}}))
            (root / "vae").mkdir()
            _save_pt(root / "vae" / "diffusion_pytorch_model.bin", vae)
            (root / "text_encoder").mkdir()
            _save_pt(root / "text_encoder" / "model.bin", text)
            # the same tensors in one file a tower: JAX's convert_sd's input
            one = tmp_path / "one_file"
            _save_st(one / "unet", "diffusion_pytorch_model.safetensors", unet)
            _save_st(one / "vae", "diffusion_pytorch_model.safetensors", vae)
            _save_st(one / "text_encoder", "model.safetensors", text)
        return str(root)
    sd = {**_state(src["unet"], C.unet_mapper_ldm(ucfg), rng),
          **_state(src["vae"], C.vae_mapper(vcfg, "ldm",
                                            "first_stage_model."), rng)}
    if kind == "ldm_ckpt":
        sd.update(_state(src["text"], C.clip_text_mapper(
            "cond_stage_model.transformer.text_model."), rng))
    else:                      # SD 2.x: an open_clip text tower JAX skips
        sd["cond_stage_model.model.token_embedding.weight"] = \
            rng.standard_normal((256, 32)).astype(np.float32)
    path = tmp_path / f"{kind}.ckpt"
    _save_pt(path, sd, wrap={"global_step": 470000, "epoch": 6})
    return str(path)


@pytest.mark.parametrize("kind", ["diffusers_safetensors", "diffusers_bin",
                                  "ldm_ckpt", "ldm_ckpt_open_clip"])
def test_sd_checkpoints_load_as_jax_converts_them(tmp_path, kind):
    jg = JSD(JSDConfig(**TINY_SD))
    template = _sd_template(jg, 1)
    src = _write_sd(kind, jg, tmp_path)
    jsrc = str(tmp_path / "one_file") if kind == "diffusers_bin" else src
    jparams = C.convert_sd(jsrc, jg, template)
    pg = StableDiffusionGuidance(SDConfig(**TINY_SD), "cpu")
    pg.init_params(torch.Generator().manual_seed(0))
    keep = None
    if kind == "ldm_ckpt_open_clip":
        keep = {"text": {k: v.clone() for k, v in
                         pg.text_encoder.state_dict().items()}}
    logs = []
    # the path --pretrained_root takes: no <tower>.npz, so convert
    pg.load_pretrained(src, torch.Generator().manual_seed(0), logs.append)
    if kind == "ldm_ckpt_open_clip":
        _check_towers(pg, jparams, ("unet", "vae"), keep)
        assert any("text tower: kept its weights" in m for m in logs)
        # JAX kept its template there too
        np.testing.assert_array_equal(
            np.asarray(jparams["text"]["final_ln"]["scale"]),
            template["text"]["final_ln"]["scale"])
    else:
        _check_towers(pg, jparams, ("unet", "vae", "text"))
        assert not logs
    if kind == "diffusers_bin":
        # JAX's own reader follows the index to the same tensors
        jsd = C.load_dir_state_dict(os.path.join(src, "unet"))
        psd = R.load_dir_state_dict(os.path.join(src, "unet"))
        assert sorted(jsd) == sorted(psd)
        for k in jsd:
            np.testing.assert_array_equal(psd[k].numpy(), jsd[k])


def _openai_visual(tv, prefix):
    """A transformers-layout vision tower state dict → the OpenAI CLIP
    visual tower's (``resblocks``, the fused ``in_proj``, ``proj`` as
    [hidden, out])."""
    top = {"vision_model.embeddings.class_embedding": "class_embedding",
           "vision_model.embeddings.position_embedding.weight":
               "positional_embedding",
           "vision_model.embeddings.patch_embedding.weight": "conv1.weight",
           "vision_model.pre_layrnorm.weight": "ln_pre.weight",
           "vision_model.pre_layrnorm.bias": "ln_pre.bias",
           "vision_model.post_layernorm.weight": "ln_post.weight",
           "vision_model.post_layernorm.bias": "ln_post.bias"}
    sub = {"self_attn.out_proj": "attn.out_proj", "layer_norm1": "ln_1",
           "layer_norm2": "ln_2", "mlp.fc1": "mlp.c_fc",
           "mlp.fc2": "mlp.c_proj"}
    out, qkv = {}, {}
    for k, v in tv.items():
        if k in top:
            out[prefix + top[k]] = v
        elif k == "visual_projection.weight":
            out[prefix + "proj"] = np.ascontiguousarray(v.T)
        else:
            rest = k[len("vision_model.encoder.layers."):]
            i, name = rest.split(".", 1)
            name, wb = name.rsplit(".", 1)
            pre = f"{prefix}transformer.resblocks.{i}."
            if name in ("self_attn.q_proj", "self_attn.k_proj",
                        "self_attn.v_proj"):
                qkv.setdefault((pre, wb), {})[name[10]] = v
            else:
                out[f"{pre}{sub[name]}.{wb}"] = v
    for (pre, wb), parts in qkv.items():
        out[f"{pre}attn.in_proj_{wb}"] = np.concatenate(
            [parts["q"], parts["k"], parts["v"]])
    return out


def test_zero123_checkpoint_loads_as_jax_converts_it(tmp_path):
    """A zero123 ``.ckpt``: the ldm UNet with EMA weights beside it (JAX
    takes the EMA's), the ldm VAE, the OpenAI ViT under
    ``cond_stage_model.model.visual.`` and ``cc_projection``, wrapped as
    Lightning saves it."""
    jg = jz.Zero123Guidance(jz.Zero123Config(tiny=True))
    z = jnp.zeros
    vis = jg.cfg.vision_config()

    def template(seed):
        rng = np.random.default_rng(seed)
        return jax.tree.map(np.asarray, {
            "unet": random_flax_params(jg.unet.init, z((1, 8, 8, 8)),
                                       z((1,)), z((1, 1, 32)), seed=seed),
            "vae": random_flax_params(jg.vae.init, z((1, 16, 16, 3)),
                                      jax.random.PRNGKey(1), seed=seed + 1),
            "vision": random_flax_params(
                jg.vision.init, z((1, vis.image_size, vis.image_size, 3)),
                seed=seed + 2),
            "cc_projection": {
                "kernel": rng.standard_normal((36, 32)).astype(np.float32),
                "bias": rng.standard_normal(32).astype(np.float32)}})

    src, rng = template(21), np.random.default_rng(4)
    unet = _state(src["unet"], C.unet_mapper_ldm(jg.unet.cfg), rng)
    sd = {**unet,
          **_state(src["vae"], C.vae_mapper(jg.vae.cfg, "ldm",
                                            "first_stage_model."), rng),
          **_openai_visual(_state(src["vision"], C.clip_vision_mapper(),
                                  rng), "cond_stage_model.model.visual."),
          "cc_projection.weight": rng.standard_normal((32, 36)).astype(
              np.float32),
          "cc_projection.bias": rng.standard_normal(32).astype(np.float32),
          "model_ema.decay": np.array(0.9999, np.float32),
          "model_ema.num_updates": np.array(105000, np.int64)}
    for k, v in unet.items():
        ek = "model_ema." + k[len("model."):].replace(".", "")
        sd[ek] = (v + rng.standard_normal(v.shape)).astype(np.float32)
    path = str(tmp_path / "zero123-xl.ckpt")
    _save_pt(path, sd, wrap={"global_step": 105000})
    jparams = C.convert_zero123(path, jg, template(1))
    pg = pz.Zero123Guidance(pz.Zero123Config(tiny=True), "cpu")
    logs = []
    pg.load_pretrained(path, torch.Generator().manual_seed(0), logs.append)
    _check_towers(pg, jparams, ("unet", "vae", "vision", "cc_projection"))
    assert any("EMA" in m for m in logs)
    # the EMA weights, not the raw ones
    k = next(k for k, v in unet.items() if v.ndim == 1)
    ek = "model_ema." + k[len("model."):].replace(".", "")
    got = pg.unet.state_dict()[R.ldm_to_diffusers_unet_key(2, 1)(k)]
    np.testing.assert_array_equal(got.numpy(), sd[ek])
    assert not np.array_equal(sd[ek], unet[k])


def test_a_tower_the_checkpoint_misses_raises(tmp_path):
    """JAX's strict conversion: a parameter without its key raises."""
    jg = JSD(JSDConfig(**TINY_SD))
    src = _write_sd("diffusers_safetensors", jg, tmp_path)
    path = os.path.join(src, "vae", "diffusion_pytorch_model.safetensors")
    sd = R.read_safetensors(path)
    del sd["decoder.conv_out.bias"]
    _save_st(os.path.join(src, "vae"), "diffusion_pytorch_model.safetensors",
             {k: v.numpy() for k, v in sd.items()})
    pg = StableDiffusionGuidance(SDConfig(**TINY_SD), "cpu")
    with pytest.raises(KeyError, match="decoder.conv_out.bias"):
        pg.load_pretrained(src, torch.Generator().manual_seed(0))
    with pytest.raises(KeyError):
        C.convert_sd(src, jg, _sd_template(jg, 1))


# ---------------------------------------------------------------------------
# full-width key coverage from the published key inventories
# ---------------------------------------------------------------------------

def _fixture(name):
    with open(os.path.join(FIX, name + ".json")) as f:
        return {k: torch.empty(v, device="meta")
                for k, v in json.load(f).items()}


def _covers(module, sd, name, prefix=""):
    """Every parameter of `module` filled from `sd` at a fitting shape →
    the keys read."""
    R.fill_tower(module, sd, name, prefix)
    return {prefix + k for k, _ in module.named_parameters()}


def _renamed(inv, key):
    """{new key: tensor} for the inventory's keys `key` maps, each key
    mapped to a distinct name."""
    out = R.rename(inv, key)
    assert len(out) == sum(key(k) is not None for k in inv)
    return out


def test_full_width_sd15_ldm_keys_map_onto_the_port():
    inv = _fixture("sd15_ldm_keys")
    with torch.device("meta"):
        unet = UNet2DCondition(UNetConfig.sd15())
        vae = AutoencoderKL(VAEConfig.sd())
    ucfg, vcfg = unet.cfg, vae.cfg
    ukey = R.ldm_to_diffusers_unet_key(len(ucfg.channel_mult),
                                       ucfg.num_res_blocks)
    vkey = R.ldm_to_diffusers_vae_key(len(vcfg.ch_mult))
    u, v = _renamed(inv, ukey), _renamed(inv, vkey)
    assert _covers(unet, u, "unet") == set(u)
    assert _covers(vae, v, "vae") == set(v)
    assert len(u) + len(v) == len(inv)


def test_full_width_zero123_keys_map_onto_the_port():
    inv = _fixture("zero123_ldm_keys")
    zc = pz.Zero123Config()
    with torch.device("meta"):
        unet = UNet2DCondition(zc.unet_config())
        vae = AutoencoderKL(zc.vae_config())
        vision = CLIPVisionEncoder(zc.vision_config())
        cc = Dense(772, 768)
    u = _renamed(inv, R.ldm_to_diffusers_unet_key(4, 2))
    v = _renamed(inv, R.ldm_to_diffusers_vae_key(4))
    assert _covers(unet, u, "unet") == set(u)
    assert _covers(vae, v, "vae") == set(v)
    prefix = "cond_stage_model.model.visual."
    vis = R.openai_clip_visual_to_transformers(inv, prefix)
    assert _covers(vision, vis, "vision") == set(vis)
    visual = [k for k in inv if k.startswith(prefix)]
    assert all(R.openai_clip_visual_to_transformers({k: inv[k]}, prefix)
               for k in visual)
    assert _covers(cc, inv, "cc_projection", "cc_projection.") == \
        {"cc_projection.weight", "cc_projection.bias"}
    assert len(u) + len(v) + len(visual) + 2 == len(inv)
    assert tuple(vision.visual_projection.weight.shape) == (768, 1024)


def test_full_width_sd21_text_keys_map_onto_the_port():
    inv = _fixture("clip_sd2_text_keys")
    with torch.device("meta"):
        text = CLIPTextEncoder(CLIPTextConfig.sd21())
    assert _covers(text, inv, "text", "text_model.") == set(inv)


def test_layout_rules():
    """conv [O, I, kh, kw] → [O, kh, kw, I]; a 1×1 conv → [O, I]; a linear
    as it is; anything else that does not fit raises."""
    w = torch.arange(2 * 3 * 4 * 5.).reshape(2, 3, 4, 5)
    assert torch.equal(R.fit_layout(w, torch.Size([2, 4, 5, 3]), "w"),
                       w.permute(0, 2, 3, 1))
    p = torch.arange(6.).reshape(2, 3, 1, 1)
    assert torch.equal(R.fit_layout(p, torch.Size([2, 3]), "p"), p[:, :, 0, 0])
    lin = torch.ones(3, 2)
    assert R.fit_layout(lin, torch.Size([3, 2]), "l") is lin
    with pytest.raises(ValueError, match="does not fit"):
        R.fit_layout(lin, torch.Size([2, 3]), "l")
    v = CLIPVisionConfig.vit_b16()
    assert (v.patch_size, v.hidden_size, v.projection_dim) == (16, 768, 512)
