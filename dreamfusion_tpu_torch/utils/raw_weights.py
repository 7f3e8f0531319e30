"""Published checkpoints read as they ship, converted onto the port's towers
(``dreamfusion_tpu/utils/convert.py``: ``load_torch_state_dict``,
``load_dir_state_dict``, the ldm → diffusers and OpenAI-CLIP → transformers
key maps, ``convert_sd``, ``convert_zero123``, ``convert_if``).

Sources: a diffusers directory (``unet/``, ``vae/``, ``text_encoder/``, each
a ``.safetensors``, ``.bin`` or ``.pt`` file or a shard index; DeepFloyd-IF's
``unet/`` and T5 ``text_encoder/``), a CompVis
(ldm) ``.ckpt`` of SD, and a zero123(-xl) ``.ckpt`` (the ldm UNet and VAE,
``cc_projection`` and the OpenAI ViT-L/14 image tower).  The port's towers
already carry the diffusers and transformers module names, so a
state dict in those names needs only the layouts: a conv weight ``[O, I,
kh, kw]`` becomes the K12 kernel's ``[O, kh, kw, I]``, a 1×1 conv
``[O, I, 1, 1]`` a linear ``[O, I]`` (SD 1.x's ``proj_in``, the shortcuts,
``quant_conv``; SD 2.x's ``proj_in`` is a linear already).  Other names go
through the maps first.  As in JAX, a tower parameter the checkpoint lacks
raises, a checkpoint key with no place in the tower is not read, and the
SD ldm ``.ckpt``'s text tower keeps its weights where the file holds no
transformers CLIP (SD 2.x's is open_clip): this is logged by tower name.

``.safetensors`` is read here (an 8-byte little-endian header length, a
JSON header, then the raw tensors); ``.ckpt``, ``.pt`` and ``.bin`` with
``torch.load`` through a restricted unpickler: tensors and plain
containers are rebuilt, any other class a checkpoint pickles (a Lightning
callback, an OmegaConf config) becomes an inert stub, so such a file loads
where that class is not installed, and nothing it names is imported.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import struct
import types
from typing import Callable, Dict, Optional

import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# reading the files
# ---------------------------------------------------------------------------

_SAFETENSORS_DTYPES = {"F64": torch.float64, "F32": torch.float32,
                       "F16": torch.float16, "BF16": torch.bfloat16,
                       "I64": torch.int64, "I32": torch.int32,
                       "I16": torch.int16, "I8": torch.int8,
                       "U8": torch.uint8, "BOOL": torch.bool}


def read_safetensors(path: str) -> StateDict:
    """A ``.safetensors`` file → {name: CPU tensor} in its stored dtype."""
    out: StateDict = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        base = 8 + n
        for name, info in header.items():
            if name == "__metadata__":
                continue
            dtype = _SAFETENSORS_DTYPES.get(info["dtype"])
            if dtype is None:
                raise ValueError(f"{path}: {name} has the unsupported dtype "
                                 f"{info['dtype']}")
            begin, end = info["data_offsets"]
            f.seek(base + begin)
            buf = bytearray(end - begin)
            f.readinto(buf)
            t = torch.frombuffer(buf, dtype=dtype) if buf else \
                torch.empty(0, dtype=dtype)
            out[name] = t.reshape(info["shape"])
    return out


class _Stub:
    """A class or function a checkpoint names beside its tensors: built
    from any arguments, its state dropped."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass

    def __setitem__(self, key, value):
        pass

    def append(self, value):
        pass

    def extend(self, values):
        pass


_BUILTINS = {"set", "frozenset", "dict", "list", "tuple", "slice",
             "complex", "bytearray", "bool", "int", "float", "str"}


def _allowed(module: str, name: str) -> bool:
    """Globals that rebuild tensors and plain containers."""
    if module in ("torch._utils", "torch._tensor"):
        return name.startswith("_rebuild")
    if module == "torch":
        obj = getattr(torch, name, None)
        return name.endswith("Storage") or name in ("Size", "device") or \
            isinstance(obj, (torch.dtype, torch.layout, torch.memory_format))
    return (module, name) in (("collections", "OrderedDict"),
                              ("_codecs", "encode")) or \
        (module in ("builtins", "__builtin__") and name in _BUILTINS)


class _RestrictedUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if _allowed(module, name):
            return super().find_class(module, name)
        return type(name, (_Stub,), {"__module__": f"stub.{module}"})


_RESTRICTED = types.ModuleType("restricted_pickle")
_RESTRICTED.Unpickler = _RestrictedUnpickler
_RESTRICTED.load = lambda f, **kw: _RestrictedUnpickler(f, **kw).load()
_RESTRICTED.__name__ = "restricted_pickle"


def load_pickled(path: str):
    """``torch.load`` of a ``.ckpt``, ``.pt`` or ``.bin`` on the CPU through
    the restricted unpickler."""
    return torch.load(path, map_location="cpu", pickle_module=_RESTRICTED,
                      weights_only=False)


def load_torch_state_dict(path: str) -> StateDict:
    """``.safetensors`` / ``.ckpt`` / ``.pt`` / ``.bin`` → {key: tensor},
    unwrapped from ``state_dict`` where the file nests it; entries that are
    not tensors are left out."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    raw = load_pickled(path)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    if not isinstance(raw, dict):
        raise ValueError(f"{path} holds no state dict")
    return {k: v for k, v in raw.items() if isinstance(v, torch.Tensor)}


def find_weights(d: str, names=("diffusion_pytorch_model", "model")) -> str:
    for n in names:
        for ext in (".safetensors", ".bin", ".pt"):
            p = os.path.join(d, n + ext)
            if os.path.exists(p):
                return p
    raise FileNotFoundError(f"no weights under {d}")


def load_dir_state_dict(d: str, names=("diffusion_pytorch_model", "model")
                        ) -> StateDict:
    """A diffusers or transformers model directory's weights, following a
    shard index (``<name>.<ext>.index.json``) where there is one."""
    for n in names:
        for ext in (".safetensors", ".bin"):
            idx = os.path.join(d, n + ext + ".index.json")
            if os.path.exists(idx):
                with open(idx) as f:
                    shards = sorted(set(json.load(f)["weight_map"].values()))
                out: StateDict = {}
                for s in shards:
                    out.update(load_torch_state_dict(os.path.join(d, s)))
                return out
    return load_torch_state_dict(find_weights(d, names))


# ---------------------------------------------------------------------------
# key maps
# ---------------------------------------------------------------------------

_LDM2DIFF_RES = {"in_layers.0": "norm1", "in_layers.2": "conv1",
                 "emb_layers.1": "time_emb_proj", "out_layers.0": "norm2",
                 "out_layers.3": "conv2", "skip_connection": "conv_shortcut"}
_LDM2DIFF_VAE_ATTN = {"norm": "group_norm", "q": "to_q", "k": "to_k",
                      "v": "to_v", "proj_out": "to_out.0"}


def _res_rename(rest: str) -> Optional[str]:
    """'in_layers.0.weight' → 'norm1.weight' (an ldm ResBlock's)."""
    name, _, wb = rest.rpartition(".")
    new = _LDM2DIFF_RES.get(name)
    return None if new is None else f"{new}.{wb}"


def ldm_to_diffusers_unet_key(levels: int, num_res_blocks: int,
                              prefix: str = "model.diffusion_model."
                              ) -> Callable[[str], Optional[str]]:
    """An ldm ``UNetModel`` checkpoint key → the diffusers (the port's) UNet
    key; None off the UNet.  ``input_blocks`` hold R resnets a level then a
    downsampler (not after the last level); ``output_blocks`` R + 1 entries
    a level, deepest first, the upsampler in a level's last entry."""
    R = num_res_blocks
    in_tab: Dict[int, tuple] = {}
    n = 1
    for lvl in range(levels):
        for blk in range(R):
            in_tab[n] = (lvl, blk)
            n += 1
        if lvl != levels - 1:
            in_tab[n] = (lvl, "down")
            n += 1
    simple = {"time_embed.0": "time_embedding.linear_1",
              "time_embed.2": "time_embedding.linear_2",
              "input_blocks.0.0": "conv_in", "out.0": "conv_norm_out",
              "out.2": "conv_out"}

    def key(k: str) -> Optional[str]:
        if not k.startswith(prefix):
            return None
        p = k[len(prefix):]
        head, _, wb = p.rpartition(".")
        if head in simple:
            return f"{simple[head]}.{wb}"
        m = re.match(r"input_blocks\.(\d+)\.(\d+)\.(.*)", p)
        if m:
            i, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            if i not in in_tab:
                return None
            lvl, blk = in_tab[i]
            if blk == "down":
                return f"down_blocks.{lvl}.downsamplers.0.conv.{wb}" \
                    if sub == 0 and rest.startswith("op.") else None
            if sub == 0:
                r = _res_rename(rest)
                return None if r is None else \
                    f"down_blocks.{lvl}.resnets.{blk}.{r}"
            # a SpatialTransformer's keys are diffusers' Transformer2DModel's
            return f"down_blocks.{lvl}.attentions.{blk}.{rest}" \
                if sub == 1 else None
        m = re.match(r"middle_block\.(\d)\.(.*)", p)
        if m:
            sub, rest = int(m.group(1)), m.group(2)
            if sub == 1:
                return f"mid_block.attentions.0.{rest}"
            r = _res_rename(rest)
            return None if r is None else \
                f"mid_block.resnets.{0 if sub == 0 else 1}.{r}"
        m = re.match(r"output_blocks\.(\d+)\.(\d+)\.(.*)", p)
        if m:
            i, sub, rest = int(m.group(1)), int(m.group(2)), m.group(3)
            j, blk = i // (R + 1), i % (R + 1)
            if sub == 0:
                r = _res_rename(rest)
                return None if r is None else \
                    f"up_blocks.{j}.resnets.{blk}.{r}"
            if rest.startswith("conv."):          # the upsampler, sub 1 or 2
                return f"up_blocks.{j}.upsamplers.0.conv.{wb}"
            return f"up_blocks.{j}.attentions.{blk}.{rest}" \
                if sub == 1 else None
        return None

    return key


def ldm_to_diffusers_vae_key(levels: int, prefix: str = "first_stage_model."
                             ) -> Callable[[str], Optional[str]]:
    """An ldm ``AutoencoderKL`` checkpoint key → the diffusers (the port's)
    VAE key; None off the VAE.  The mid-block attention's q, k, v and
    proj_out are 1×1 convs there, linears here (the layout rule squeezes
    them)."""

    def key(k: str) -> Optional[str]:
        if not k.startswith(prefix):
            return None
        p = k[len(prefix):]
        wb = p.rsplit(".", 1)[-1]
        if p.startswith(("quant_conv.", "post_quant_conv.")):
            return p
        side, _, p = p.partition(".")
        if side not in ("encoder", "decoder"):
            return None
        if p.startswith("norm_out."):
            return f"{side}.conv_norm_out.{wb}"
        if p.startswith(("conv_in.", "conv_out.")):
            return f"{side}.{p}"
        m = re.match(r"mid\.block_([12])\.(.*)", p)
        if m:
            rest = m.group(2)
            if rest.startswith("nin_shortcut."):
                rest = f"conv_shortcut.{wb}"
            return f"{side}.mid_block.resnets.{int(m.group(1)) - 1}.{rest}"
        m = re.match(r"mid\.attn_1\.(\w+)\.(weight|bias)", p)
        if m:
            new = _LDM2DIFF_VAE_ATTN.get(m.group(1))
            return None if new is None else \
                f"{side}.mid_block.attentions.0.{new}.{m.group(2)}"
        m = re.match(r"(down|up)\.(\d+)\.block\.(\d+)\.(.*)", p)
        if m:
            d, lvl, blk, rest = m.groups()
            if rest.startswith("nin_shortcut."):
                rest = f"conv_shortcut.{wb}"
            i = int(lvl) if d == "down" else levels - 1 - int(lvl)
            return f"{side}.{d}_blocks.{i}.resnets.{blk}.{rest}"
        m = re.match(r"(down|up)\.(\d+)\.(down|up)sample\.conv\.", p)
        if m:
            d, lvl = m.group(1), int(m.group(2))
            i = lvl if d == "down" else levels - 1 - lvl
            return f"{side}.{d}_blocks.{i}.{d}samplers.0.conv.{wb}"
        return None

    return key


_OPENAI_LAYER = {"attn.out_proj": "self_attn.out_proj", "ln_1": "layer_norm1",
                 "ln_2": "layer_norm2", "mlp.c_fc": "mlp.fc1",
                 "mlp.c_proj": "mlp.fc2"}
_OPENAI_TOP = {"class_embedding": "embeddings.class_embedding",
               "positional_embedding": "embeddings.position_embedding.weight",
               "conv1.weight": "embeddings.patch_embedding.weight",
               "ln_pre.weight": "pre_layrnorm.weight",
               "ln_pre.bias": "pre_layrnorm.bias",
               "ln_post.weight": "post_layernorm.weight",
               "ln_post.bias": "post_layernorm.bias"}


def openai_clip_visual_to_transformers(sd: StateDict,
                                       prefix: str = "visual.") -> StateDict:
    """An OpenAI-CLIP visual tower (``resblocks``, the fused ``in_proj``)
    → the port's vision tower keys (transformers' below ``vision_model.``,
    and ``visual_projection``): ``in_proj`` split into q, k and v, and
    ``proj`` ([hidden, out], ``x @ proj``) stored transposed."""
    out: StateDict = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        r = k[len(prefix):]
        if r in _OPENAI_TOP:
            out[_OPENAI_TOP[r]] = v
        elif r == "proj":
            out["visual_projection.weight"] = v.t()
        else:
            m = re.match(
                r"transformer\.resblocks\.(\d+)\.(.*)[._](weight|bias)", r)
            if not m:
                continue
            pre = f"encoder.layers.{m.group(1)}."
            name, wb = m.group(2), m.group(3)
            if name == "attn.in_proj":            # in_proj_weight, _bias
                for which, part in zip("qkv", v.chunk(3, dim=0)):
                    out[f"{pre}self_attn.{which}_proj.{wb}"] = part
            elif name in _OPENAI_LAYER:
                out[f"{pre}{_OPENAI_LAYER[name]}.{wb}"] = v
    return out


# ---------------------------------------------------------------------------
# filling the towers
# ---------------------------------------------------------------------------

def fit_layout(t: torch.Tensor, want: torch.Size, key: str) -> torch.Tensor:
    """A checkpoint tensor in torch's layout → the port parameter's shape:
    conv ``[O, I, kh, kw]`` → ``[O, kh, kw, I]``, a 1×1 conv → a linear
    ``[O, I]``; anything else as it is."""
    if t.dim() == 4 and len(want) == 4:
        t = t.permute(0, 2, 3, 1)
    elif t.dim() == 4 and len(want) == 2 and t.shape[2:] == (1, 1):
        t = t[:, :, 0, 0]
    if tuple(t.shape) != tuple(want):
        raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} (as "
                         f"converted) does not fit the tower's "
                         f"{tuple(want)}")
    return t


@torch.no_grad()
def fill_tower(module: nn.Module, sd: StateDict, name: str,
               prefix: str = "") -> int:
    """Copy ``sd[prefix + key]`` into every parameter of `module`, in its
    dtype and on its device, the layout fitted → the number copied.  A
    parameter the state dict lacks raises KeyError (JAX's strict
    ``_convert``)."""
    params = dict(module.named_parameters())
    missing = [k for k in params if prefix + k not in sd]
    if missing:
        raise KeyError(f"{name}: {len(missing)} parameters have no "
                       f"checkpoint key, e.g. "
                       f"{[prefix + k for k in missing[:5]]}")
    for k, p in params.items():
        p.copy_(fit_layout(sd[prefix + k], p.shape, prefix + k).to(p.dtype))
    return len(params)


def rename(sd: StateDict, key: Callable[[str], Optional[str]]) -> StateDict:
    """The entries of `sd` that `key` maps, under their new names."""
    out: StateDict = {}
    for k, v in sd.items():
        new = key(k)
        if new is not None:
            out[new] = v
    return out


def _ldm_towers(sd: StateDict, unet: nn.Module, vae: nn.Module) -> None:
    ucfg, vcfg = unet.cfg, vae.cfg
    fill_tower(unet, rename(sd, ldm_to_diffusers_unet_key(
        len(ucfg.channel_mult), ucfg.num_res_blocks)), "unet")
    fill_tower(vae, rename(sd, ldm_to_diffusers_vae_key(len(vcfg.ch_mult))),
               "vae")


def convert_sd(src: str, guidance, log=print) -> None:
    """A diffusers directory (``unet/``, ``vae/``, ``text_encoder/``) or a
    CompVis ``.ckpt`` / ``.safetensors`` of SD into `guidance`'s towers
    (``StableDiffusionGuidance``).  From a CompVis file the text tower is
    transformers CLIP under ``cond_stage_model.transformer.`` (SD 1.x); a
    file without it (SD 2.x's open_clip) leaves the text tower as it was,
    and says so."""
    if os.path.isdir(src):
        fill_tower(guidance.unet, load_dir_state_dict(
            os.path.join(src, "unet")), "unet")
        fill_tower(guidance.vae, load_dir_state_dict(
            os.path.join(src, "vae")), "vae")
        fill_tower(guidance.text_encoder, load_dir_state_dict(
            os.path.join(src, "text_encoder")), "text", "text_model.")
        return
    sd = load_torch_state_dict(src)
    _ldm_towers(sd, guidance.unet, guidance.vae)
    try:
        fill_tower(guidance.text_encoder, sd, "text",
                   "cond_stage_model.transformer.text_model.")
    except KeyError as e:
        log(f"[weights] text tower: kept its weights, {src} holds no "
            f"transformers CLIP text tower ({e.args[0]})")


def convert_zero123(src: str, guidance, log=print) -> None:
    """A zero123(-xl) ``.ckpt`` into `guidance`'s towers
    (``Zero123Guidance``): the EMA weights where the file has them
    (``model_ema.`` + the UNet key with its dots removed), the ldm UNet and
    VAE, the OpenAI ViT-L/14 under ``cond_stage_model.model.visual.`` and
    ``cc_projection``."""
    if os.path.isdir(src):
        raise FileNotFoundError(f"{src} holds no <tower>.npz, and a zero123 "
                                f"checkpoint to convert is one .ckpt file")
    sd = load_torch_state_dict(src)
    n_ema = 0
    for k in list(sd):
        if k.startswith("model.diffusion_model."):
            ek = "model_ema." + k[len("model."):].replace(".", "")
            if ek in sd:
                sd[k] = sd[ek]
                n_ema += 1
    if n_ema:
        log(f"[weights] zero123 UNet: the EMA weights ({n_ema} tensors)")
    _ldm_towers(sd, guidance.unet, guidance.vae)
    fill_tower(guidance.vision, openai_clip_visual_to_transformers(
        sd, "cond_stage_model.model.visual."), "vision")
    fill_tower(guidance.cc_projection, sd, "cc_projection", "cc_projection.")



def convert_if(src: str, guidance, log=print) -> None:
    """A diffusers DeepFloyd-IF directory into `guidance`'s towers
    (``IFGuidance``): ``unet/`` (its ``config.json``, where there is one,
    sets the UNet's dimensions) and, where there is one, the T5 encoder in
    ``text_encoder/`` (built here; ``encoder.embed_tokens.weight`` stands
    in for a missing ``shared.weight``).  Shard indexes are followed."""
    from ..models.if_unet import IFUNetConfig

    if not os.path.isdir(src):
        raise FileNotFoundError(f"{src} holds no unet.npz or t5.npz, and a "
                                f"DeepFloyd-IF checkpoint to convert is a "
                                f"diffusers directory")
    unet_dir = os.path.join(src, "unet")
    cfg_path = os.path.join(unet_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            guidance.rebuild_unet(IFUNetConfig.from_diffusers_config(
                json.load(f)))
    fill_tower(guidance.unet, load_dir_state_dict(unet_dir), "unet")
    t5_dir = os.path.join(src, "text_encoder")
    if os.path.isdir(t5_dir):
        sd = load_dir_state_dict(t5_dir)
        if "shared.weight" not in sd and "encoder.embed_tokens.weight" in sd:
            sd["shared.weight"] = sd["encoder.embed_tokens.weight"]
        guidance.t5 = guidance.build_t5()
        fill_tower(guidance.t5, sd, "t5")
        log(f"[weights] T5 encoder from {t5_dir}")
