"""Carry the JAX package's weights into the port.

Layouts: a Flax conv kernel ``[kh, kw, I, O]`` becomes the K12 kernel's
``[O, kh, kw, I]`` (input channels contiguous, one output channel's
K = kh·kw·I slice per row); a 1×1 conv, which the port computes as
``F.linear``, and an ``nn.Dense`` kernel ``[in, out]`` become an
``nn.Linear`` weight ``[out, in]``; GroupNorm and LayerNorm ``scale``
becomes ``weight``.  The guidance towers' module names are the diffusers
(UNet, VAE) and transformers (CLIP text and vision) checkpoint keys, so the
Flax paths map onto them as the JAX package's own converter maps those
checkpoints.  Zero-1-to-3's ``cc_projection`` (a Flax ``[772, 768]``
kernel) becomes an ``nn.Linear`` ``[768, 772]`` weight.  DeepFloyd-IF's
UNet (``if_unet``: its 1×1 shortcuts stay convs on K12, ``[O, 1, 1, I]``)
and T5 encoder (``t5``) follow the JAX package's ``if_unet_mapper`` and
``t5_mapper``.
"""

from __future__ import annotations

import re
from typing import (Any, Callable, Dict, Iterable, Iterator, Mapping, Optional,
                    Tuple)

import numpy as np
import torch


def _linear(kernel) -> torch.Tensor:
    return torch.from_numpy(np.array(kernel, dtype=np.float32).T.copy())


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX param pytree with numpy leaves → the port's state_dict(s).

    ``{'field': {'grid_table' or 'triplanes': ..., 'sigma_net': {...},
    'bg_net': {...}}}`` (``NeRFRenderer``) → the renderer's ``state_dict``,
    the hash table as it is ([T, C]), triplanes in their [3, R, R, C]
    layout, the vanilla field's ResMLP (``dense_0``, ``res_l``,
    ``dense_{L-1}``) by ``_res_mlp``.  The guidance towers ``{'unet',
    'vae', 'text'}`` (SD's),
    ``{'unet', 'vae', 'vision', 'cc_projection'}`` (zero123's) or
    ``{'vision', 'text', 'text_projection'}`` (CLIP guidance's) or
    ``{'unet', 't5'}`` (DeepFloyd-IF's, its UNet told apart by its
    ``add_embedding``) → ``{'unet':
    state_dict, 'vae': ..., ...}`` (the raw ``text_projection`` [in, out]
    as an ``nn.Linear`` weight [out, in]).  The DMTet stage's ``{'nerf':
    ..., 'geo': {'sdf', 'deform'}}`` → the ``DMTetModel`` state_dict (``nerf.*``,
    ``geo.sdf``, ``geo.deform``); a ``'tet_scale'`` beside them (the JAX
    state's, not a parameter) comes back under that key, for
    ``DMTetState.tet_scale``."""
    if "geo" in tree:
        out = {f"nerf.{k}": v for k, v in params_from_jax(tree["nerf"]).items()}
        for k in ("sdf", "deform"):
            out[f"geo.{k}"] = torch.from_numpy(
                np.array(tree["geo"][k], dtype=np.float32))
        if "tet_scale" in tree:
            out["tet_scale"] = torch.from_numpy(
                np.array(tree["tet_scale"], dtype=np.float32))
        return out
    if "field" not in tree:
        return _towers(tree)
    field = tree["field"]
    out: Dict[str, torch.Tensor] = {}
    if "grid_table" in field:
        out["field.grid_table"] = torch.from_numpy(
            np.array(field["grid_table"], dtype=np.float32))
    for s, plane in enumerate(field.get("triplanes", ())):
        out[f"field.triplanes.{s}"] = torch.from_numpy(
            np.array(plane, dtype=np.float32))
    for net in ("sigma_net", "bg_net"):
        mlp = field.get(net, {})
        if any(k.startswith("res_") for k in mlp):
            out.update(_res_mlp(mlp, f"field.{net}"))
            continue
        for l in range(len(mlp)):
            out.update(_dense(mlp[f"dense_{l}"], f"field.{net}.layers.{l}"))
    return out


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(dense: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """An ``nn.Dense``'s kernel (and bias, where it has one)."""
    out = {f"{prefix}.weight": _linear(dense["kernel"])}
    if "bias" in dense:
        out[f"{prefix}.bias"] = _f32(dense["bias"])
    return out


def _res_mlp(mlp: Mapping[str, Any], prefix: str) -> Dict[str, torch.Tensor]:
    """The vanilla field's ``ResMLP``: ``dense_0`` → ``first``, ``res_l``
    → ``blocks.{l-1}`` (``dense``, ``norm.scale``/``bias``, the bias-free
    ``skip`` where the widths differ), the last ``dense_{L-1}`` →
    ``last``."""
    L = len(mlp)
    out = _dense(mlp["dense_0"], f"{prefix}.first")
    out.update(_dense(mlp[f"dense_{L - 1}"], f"{prefix}.last"))
    for l in range(1, L - 1):
        res, p = mlp[f"res_{l}"], f"{prefix}.blocks.{l - 1}"
        out.update(_dense(res["dense"], f"{p}.dense"))
        out[f"{p}.norm.scale"] = _f32(res["norm"]["scale"])
        out[f"{p}.norm.bias"] = _f32(res["norm"]["bias"])
        if "skip" in res:
            out.update(_dense(res["skip"], f"{p}.skip"))
    return out


# ---------------------------------------------------------------------------
# guidance towers
# ---------------------------------------------------------------------------

def _flat(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _flat(v, path)
        else:
            yield path, v


def _leaf(path: str, leaf, keep_1x1: bool = False) -> torch.Tensor:
    """A Flax leaf in the port's layout; `keep_1x1`: a 1×1 conv stays a
    conv ``[O, 1, 1, I]`` (IF's shortcuts) instead of a linear."""
    a = np.array(leaf, dtype=np.float32)
    if path.endswith(("kernel", "text_projection")):
        if a.ndim == 4 and a.shape[:2] == (1, 1) and not keep_1x1:
            a = a[0, 0].T                         # 1×1 conv → [O, I]
        elif a.ndim == 4:
            a = a.transpose(3, 0, 1, 2)           # [kh,kw,I,O] → [O,kh,kw,I]
        else:
            a = a.T                               # Dense [in,out] → [out,in]
    return torch.from_numpy(np.ascontiguousarray(a))


def _wb(path: str) -> str:
    return "bias" if path.endswith("bias") else "weight"


_RES = {"GroupNorm32_0": "norm1", "GroupNorm32_1": "norm2",
        "conv1": "conv1", "conv2": "conv2", "time_emb_proj": "time_emb_proj",
        "shortcut": "conv_shortcut"}


def _spatial_transformer(rest: str) -> str:
    top = rest.split("/")[0]
    if top in ("GroupNorm32_0", "proj_in", "proj_out"):
        name = "norm" if top == "GroupNorm32_0" else top
        return f"{name}.{_wb(rest)}"
    m = re.match(r"block_(\d+)/(\w+)/(.*)", rest)
    k, sub, tail = m.group(1), m.group(2), m.group(3)
    pre = f"transformer_blocks.{k}."
    if sub == "ff_geglu":
        return f"{pre}ff.net.0.proj.{_wb(tail)}"
    if sub == "ff_out":
        return f"{pre}ff.net.2.{_wb(tail)}"
    if sub.startswith("norm"):
        return f"{pre}{sub}.{_wb(tail)}"
    which = tail.split("/")[0]                  # to_q / to_k / to_v / to_out
    which = "to_out.0" if which == "to_out" else which
    return f"{pre}{sub}.{which}.{_wb(tail)}"


def unet_key(path: str, levels: int) -> Optional[str]:
    """Flax ``UNet2DCondition`` path → the port's (diffusers) key."""
    wb = _wb(path)
    top = path.split("/")[0]
    simple = {"time_dense_0": "time_embedding.linear_1",
              "time_dense_1": "time_embedding.linear_2",
              "conv_in": "conv_in", "conv_out": "conv_out",
              "GroupNorm32_0": "conv_norm_out"}
    if top in simple:
        return f"{simple[top]}.{wb}"
    m = re.match(r"(down|up)_(\d+)_(res|attn)_(\d+)/(.*)", path)
    if m:
        d, lvl, kind, blk, rest = m.groups()
        i = int(lvl) if d == "down" else levels - 1 - int(lvl)
        if kind == "res":
            return f"{d}_blocks.{i}.resnets.{blk}." \
                f"{_RES[rest.split('/')[0]]}.{wb}"
        return f"{d}_blocks.{i}.attentions.{blk}." + \
            _spatial_transformer(rest)
    m = re.match(r"down_(\d+)_downsample/", path)
    if m:
        return f"down_blocks.{m.group(1)}.downsamplers.0.conv.{wb}"
    m = re.match(r"up_(\d+)_upsample/", path)
    if m:
        return f"up_blocks.{levels - 1 - int(m.group(1))}.upsamplers.0." \
            f"conv.{wb}"
    m = re.match(r"mid_res_(\d)/(\w+)", path)
    if m:
        return f"mid_block.resnets.{m.group(1)}.{_RES[m.group(2)]}.{wb}"
    m = re.match(r"mid_attn/(.*)", path)
    if m:
        return "mid_block.attentions.0." + _spatial_transformer(m.group(1))
    return None


_VAE_ATTN = {"GroupNorm32_0": "group_norm", "q": "to_q", "k": "to_k",
             "v": "to_v", "proj_out": "to_out.0"}


def vae_key(path: str, levels: int) -> Optional[str]:
    """Flax ``AutoencoderKL`` path → the port's (diffusers) key."""
    side, _, p = path.partition("/")
    wb = _wb(p)
    top = p.split("/")[0]
    if top in ("quant_conv", "post_quant_conv"):
        return f"{top}.{wb}"
    if top in ("conv_in", "conv_out"):
        return f"{side}.{top}.{wb}"
    if top == "GroupNorm32_0":
        return f"{side}.conv_norm_out.{wb}"
    m = re.match(r"mid_res_(\d)/(\w+)", p)
    if m:
        return f"{side}.mid_block.resnets.{m.group(1)}." \
            f"{_RES[m.group(2)]}.{wb}"
    m = re.match(r"mid_attn/(\w+)", p)
    if m:
        return f"{side}.mid_block.attentions.0.{_VAE_ATTN[m.group(1)]}.{wb}"
    m = re.match(r"(down|up)_(\d+)_res_(\d+)/(\w+)", p)
    if m:
        d, lvl, blk, sub = m.groups()
        i = int(lvl) if d == "down" else levels - 1 - int(lvl)
        return f"{side}.{d}_blocks.{i}.resnets.{blk}.{_RES[sub]}.{wb}"
    m = re.match(r"(down|up)_(\d+)_(down|up)sample/", p)
    if m:
        d, lvl = m.group(1), int(m.group(2))
        i = lvl if d == "down" else levels - 1 - lvl
        return f"{side}.{d}_blocks.{i}.{d}samplers.0.conv.{wb}"
    return None


_CLIP = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
         "v": "self_attn.v_proj", "attn_out": "self_attn.out_proj",
         "ln1": "layer_norm1", "ln2": "layer_norm2", "fc1": "mlp.fc1",
         "fc2": "mlp.fc2"}


def clip_text_key(path: str) -> Optional[str]:
    """Flax ``CLIPTextEncoder`` path → the port's (transformers) key."""
    if path == "token_embedding/embedding":
        return "embeddings.token_embedding.weight"
    if path == "position_embedding":
        return "embeddings.position_embedding.weight"
    if path.startswith("final_ln/"):
        return f"final_layer_norm.{_wb(path)}"
    m = re.match(r"layer_(\d+)/(\w+)/", path)
    if m:
        return f"encoder.layers.{m.group(1)}.{_CLIP[m.group(2)]}." \
            f"{_wb(path)}"
    return None


def clip_vision_key(path: str) -> Optional[str]:
    """Flax ``CLIPVisionEncoder`` path → the port's (transformers
    ``CLIPVisionModelWithProjection``) key, the JAX package's
    ``clip_vision_mapper`` without the ``vision_model.`` prefix."""
    simple = {"class_embedding": "embeddings.class_embedding",
              "position_embedding": "embeddings.position_embedding.weight"}
    if path in simple:
        return simple[path]
    top = path.split("/")[0]
    named = {"patch_embed": "embeddings.patch_embedding",
             "pre_ln": "pre_layrnorm", "post_ln": "post_layernorm",
             "visual_projection": "visual_projection"}
    if top in named:
        return f"{named[top]}.{_wb(path)}"
    m = re.match(r"layer_(\d+)/(\w+)/", path)
    if m:
        return f"encoder.layers.{m.group(1)}.{_CLIP[m.group(2)]}." \
            f"{_wb(path)}"
    return None


def clip_key(path: str) -> Optional[str]:
    """CLIP guidance's params (``vision``, ``text`` and the raw
    ``text_projection`` [in, out], JAX's ``CLIPGuidance.init_params``) →
    the port's ``guidance/clip.py::CLIPTowers`` key."""
    if path == "text_projection":
        return "text_projection.weight"
    tower, _, rest = path.partition("/")
    key = {"vision": clip_vision_key, "text": clip_text_key}.get(tower)
    sub = key(rest) if key else None
    return None if sub is None else f"{tower}.{sub}"


def if_unet_key(path: str, levels: int) -> Optional[str]:
    """Flax ``IFUNet`` path → the port's (diffusers IF) key, JAX's
    ``if_unet_mapper``."""
    wb = _wb(path)
    top, _, rest = path.partition("/")
    simple = {"time_dense_0": "time_embedding.linear_1",
              "time_dense_1": "time_embedding.linear_2",
              "encoder_hid_proj": "encoder_hid_proj", "conv_in": "conv_in",
              "conv_out": "conv_out", "norm_out": "conv_norm_out"}
    if top in simple:
        return f"{simple[top]}.{wb}"
    if top == "add_embedding":
        if rest == "pool/positional_embedding":
            return "add_embedding.pool.positional_embedding"
        sub = rest.split("/")
        if sub[0] == "pool" and sub[1] in ("q_proj", "k_proj", "v_proj"):
            return f"add_embedding.pool.{sub[1]}.{wb}"
        if sub[0] in ("norm1", "norm2", "proj"):
            return f"add_embedding.{sub[0]}.{wb}"
        return None
    # a block's layer: the Flax name, but the attention's to_out.0
    sub = rest.split("/")[0]
    sub = f"{sub}.0" if sub == "to_out" else sub
    m = re.match(r"(down|up)_(\d+)_(res|attn)_(\d+)$", top)
    if m:
        d, lvl, kind, blk = m.groups()
        i = int(lvl) if d == "down" else levels - 1 - int(lvl)
        name = "resnets" if kind == "res" else "attentions"
        return f"{d}_blocks.{i}.{name}.{blk}.{sub}.{wb}"
    m = re.match(r"down_(\d+)_down$", top)
    if m:
        return f"down_blocks.{m.group(1)}.downsamplers.0.{sub}.{wb}"
    m = re.match(r"up_(\d+)_up$", top)
    if m:
        return f"up_blocks.{levels - 1 - int(m.group(1))}.upsamplers.0." \
            f"{sub}.{wb}"
    m = re.match(r"mid_res_(\d)$", top)
    if m:
        return f"mid_block.resnets.{m.group(1)}.{sub}.{wb}"
    if top == "mid_attn":
        return f"mid_block.attentions.0.{sub}.{wb}"
    return None


def t5_key(path: str) -> Optional[str]:
    """Flax ``T5Encoder`` path → the port's (transformers
    ``T5EncoderModel``) key, JAX's ``t5_mapper``."""
    if path == "shared/embedding":
        return "shared.weight"
    if path == "final_ln/weight":
        return "encoder.final_layer_norm.weight"
    m = re.match(r"block_(\d+)/(.*)", path)
    if not m:
        return None
    pre, rest = f"encoder.block.{m.group(1)}.", m.group(2)
    if rest == "attn/relative_attention_bias":
        return pre + "layer.0.SelfAttention.relative_attention_bias.weight"
    a = re.match(r"attn/(q|k|v|o)/kernel$", rest)
    if a:
        return pre + f"layer.0.SelfAttention.{a.group(1)}.weight"
    if rest == "ln_attn/weight":
        return pre + "layer.0.layer_norm.weight"
    f = re.match(r"(wi_0|wi_1|wo)/kernel$", rest)
    if f:
        return pre + f"layer.1.DenseReluDense.{f.group(1)}.weight"
    if rest == "ln_ff/weight":
        return pre + "layer.1.layer_norm.weight"
    return None


def cc_projection_key(path: str) -> Optional[str]:
    """zero123's ``cc_projection`` {kernel, bias} → an ``nn.Linear``'s."""
    return {"kernel": "weight", "bias": "bias"}.get(path)


def _tower(tree, key: Callable[[str], Optional[str]], keep_1x1: bool = False
           ) -> Dict[str, torch.Tensor]:
    out = {}
    for path, leaf in _flat(tree):
        k = key(path)
        if k is None:
            raise KeyError(f"no port key for Flax parameter {path}")
        out[k] = _leaf(path, leaf, keep_1x1)
    return out


def _levels(tree) -> int:
    """Resolution levels of a UNet or VAE encoder tree (its top-level
    names, or its Flax paths)."""
    return 1 + max(int(m.group(1)) for k in tree
                   for m in [re.match(r"down_(\d+)_res_", k)] if m)


def tower_levels(name: str, paths: Iterable[str]) -> int:
    """Resolution levels of guidance tower `name` from its Flax paths: the
    UNet's, or the VAE encoder's; 0 for the other towers."""
    if name == "vae":
        return _levels(p[len("encoder/"):] for p in paths
                       if p.startswith("encoder/"))
    return _levels(paths) if name in ("unet", "if_unet") else 0


def tower_key(name: str, levels: int) -> Callable[[str], Optional[str]]:
    """The Flax path → port key map of guidance tower `name`; `levels`:
    the UNet's or the VAE encoder's resolution levels (unused by the
    others)."""
    return {"unet": lambda p: unet_key(p, levels),
            "if_unet": lambda p: if_unet_key(p, levels), "t5": t5_key,
            "vae": lambda p: vae_key(p, levels),
            "text": clip_text_key, "vision": clip_vision_key,
            "cc_projection": cc_projection_key, "clip": clip_key}[name]


def _towers(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    out = {}
    if "text_projection" in params:
        out["text_projection"] = {"weight": _leaf(
            "text_projection", params["text_projection"])}
    for name in ("unet", "vae", "text", "vision", "cc_projection", "t5"):
        if name in params:
            tree = params[name]
            # DeepFloyd-IF's UNet: the one with the pooled text embedding
            kind = "if_unet" if name == "unet" and "add_embedding" in tree \
                else name
            L = _levels(tree["encoder"] if name == "vae" else tree) \
                if name in ("unet", "vae") else 0
            out[name] = _tower(tree, tower_key(kind, L), kind == "if_unet")
    return out
