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
``t5_mapper``.  The DPT (``models/dpt.py``) takes the omnidata checkpoint's
keys (JAX's ``dpt_mapper``); its 1×1 kernels stay ``[O, 1, 1, I]``.
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
    if "refinenet1" in tree.get("params", tree):
        return dpt_from_jax(tree)
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


_DPT = "pretrained.model."


def dpt_key(path: str) -> Optional[str]:
    """A Flax path of JAX's ``DPTDepthModel`` → the port's key, which is
    the omnidata checkpoint's (JAX ``dpt_mapper``)."""
    wb = "weight" if path.endswith(("kernel", "scale")) else "bias"
    if path.startswith("vit/"):
        p = path[4:]
        if p in ("cls_token", "pos_embed"):
            return _DPT + p
        simple = {"stem_conv": "patch_embed.backbone.stem.conv.weight",
                  "stem_norm": f"patch_embed.backbone.stem.norm.{wb}",
                  "patch_proj": f"patch_embed.proj.{wb}",
                  "norm": f"norm.{wb}"}
        top = p.split("/")[0]
        if top in simple:
            return _DPT + simple[top]
        m = re.match(r"stage(\d+)_block(\d+)/(\w+)/", p)
        if m:
            s, b, sub = m.groups()
            sub = {"downsample_conv": "downsample.conv",
                   "downsample_norm": "downsample.norm"}.get(sub, sub)
            return (_DPT + f"patch_embed.backbone.stages.{s}.blocks.{b}."
                    f"{sub}.{wb}")
        m = re.match(r"block(\d+)/(\w+)/", p)
        if m:
            i, sub = m.groups()
            sub = {"qkv": "attn.qkv", "proj": "attn.proj",
                   "fc1": "mlp.fc1", "fc2": "mlp.fc2"}.get(sub, sub)
            return _DPT + f"blocks.{i}.{sub}.{wb}"
        return None
    m = re.match(r"readout(\d)/project/", path)
    if m:
        return f"pretrained.act_postprocess{m.group(1)}.0.project.0.{wb}"
    post = {"post3_conv": "act_postprocess3.3",
            "post4_conv": "act_postprocess4.3",
            "post4_down": "act_postprocess4.4"}.get(path.split("/")[0])
    if post:
        return f"pretrained.{post}.{wb}"
    m = re.match(r"layer(\d)_rn/", path)
    if m:
        return f"scratch.layer{m.group(1)}_rn.weight"
    m = re.match(r"refinenet(\d)/(?:rcu(\d)/conv(\d)|out_conv)/", path)
    if m:
        i, rcu, conv = m.groups()
        sub = f"resConfUnit{rcu}.conv{conv}" if rcu else "out_conv"
        return f"scratch.refinenet{i}.{sub}.{wb}"
    m = re.match(r"head_conv(\d)/", path)
    if m:
        return f"scratch.output_conv.{2 * int(m.group(1)) - 2}.{wb}"
    return None


def dpt_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``DPTDepthModel`` params (``{'params': ...}`` or the tree
    inside) → the port's ``DPTDepthModel`` state_dict: every conv kernel
    ``[O, kh, kw, I]``, 1×1s included, every Dense an ``nn.Linear``
    weight."""
    return _tower(tree.get("params", tree), dpt_key, keep_1x1=True)


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
            "cc_projection": cc_projection_key, "clip": clip_key,
            "dpt": lambda p: dpt_key(p[7:] if p.startswith("params/")
                                     else p)}[name]


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


# ---------------------------------------------------------------------------
# the other way: the port's modules → JAX's ``<tower>.npz``
# ---------------------------------------------------------------------------

def _dpt_flax_path(key: str) -> str:
    """The inverse of ``dpt_key``: a port DPT key → its Flax path."""
    leaf = key.rsplit(".", 1)[1]
    if key.startswith(_DPT):
        p = key[len(_DPT):]
        if p in ("cls_token", "pos_embed"):
            return f"vit/{p}"
        simple = {"patch_embed.backbone.stem.conv": "stem_conv",
                  "patch_embed.backbone.stem.norm": "stem_norm",
                  "patch_embed.proj": "patch_proj", "norm": "norm"}
        mod = p.rsplit(".", 1)[0]
        norm = "norm" in mod.rsplit(".", 1)[-1]
        wb = "bias" if leaf == "bias" else ("scale" if norm else "kernel")
        if mod in simple:
            return f"vit/{simple[mod]}/{wb}"
        m = re.match(r"patch_embed\.backbone\.stages\.(\d+)\.blocks\.(\d+)\."
                     r"(.+)$", mod)
        if m:
            s, b, sub = m.groups()
            sub = sub.replace("downsample.", "downsample_")
            return f"vit/stage{s}_block{b}/{sub}/{wb}"
        m = re.match(r"blocks\.(\d+)\.(?:attn|mlp)?\.?(\w+)$", mod)
        if m:
            return f"vit/block{m.group(1)}/{m.group(2)}/{wb}"
    wb = "bias" if leaf == "bias" else "kernel"
    m = re.match(r"pretrained\.act_postprocess(\d)\.(\d)\.", key)
    if m:
        i, j = m.groups()
        if j == "0":
            return f"readout{i}/project/{wb}"
        return f"post{i}_{'down' if j == '4' else 'conv'}/{wb}"
    m = re.match(r"scratch\.(layer\d_rn)\.", key)
    if m:
        return f"{m.group(1)}/kernel"
    m = re.match(r"scratch\.refinenet(\d)\.(?:resConfUnit(\d)\.conv(\d)|"
                 r"out_conv)\.", key)
    if m:
        i, rcu, conv = m.groups()
        sub = f"rcu{rcu}/conv{conv}" if rcu else "out_conv"
        return f"refinenet{i}/{sub}/{wb}"
    m = re.match(r"scratch\.output_conv\.(\d)\.", key)
    if m:
        return f"head_conv{int(m.group(1)) // 2 + 1}/{wb}"
    raise KeyError(f"no Flax path for DPT key {key}")


def _flax_leaf(t: torch.Tensor) -> np.ndarray:
    """A port tensor in the Flax layout: conv ``[O, kh, kw, I]`` →
    ``[kh, kw, I, O]``, ``nn.Linear`` ``[out, in]`` → ``[in, out]``."""
    a = t.detach().float().cpu().numpy()
    if a.ndim == 4:
        return a.transpose(1, 2, 3, 0)
    return a.T if a.ndim == 2 else a


_RES_INV = {"norm1": "GroupNorm32_0/GroupNorm_0",
            "norm2": "GroupNorm32_1/GroupNorm_0", "conv1": "conv1",
            "conv2": "conv2", "time_emb_proj": "time_emb_proj",
            "conv_shortcut": "shortcut"}
_VAE_ATTN_INV = {"group_norm": "GroupNorm32_0/GroupNorm_0", "to_q": "q",
                 "to_k": "k", "to_v": "v", "to_out.0": "proj_out"}
_CLIP_INV = {v: k for k, v in _CLIP.items()}
# Flax modules that are 1×1 convs ([1, 1, I, O]) where the port keeps an
# ``nn.Linear``-shaped weight
_FLAX_1X1 = {"unet": ("proj_in", "proj_out", "shortcut"),
             "vae": ("shortcut", "q", "k", "v", "proj_out", "quant_conv",
                     "post_quant_conv")}


def _level(d: str, i: str, levels: int) -> int:
    return int(i) if d == "down" else levels - 1 - int(i)


def _st_path(rest: str) -> str:
    """The inverse of ``_spatial_transformer``."""
    if rest in ("norm", "proj_in", "proj_out"):
        return {"norm": "GroupNorm32_0/GroupNorm_0"}.get(rest, rest)
    m = re.match(r"transformer_blocks\.(\d+)\.(.+)$", rest)
    k, sub = m.groups()
    sub = {"ff.net.0.proj": "ff_geglu/proj", "ff.net.2": "ff_out"}.get(
        sub, sub.replace(".to_out.0", ".to_out").replace(".", "/"))
    return f"block_{k}/{sub}"


def _unet_module(mod: str, levels: int) -> str:
    simple = {"time_embedding.linear_1": "time_dense_0",
              "time_embedding.linear_2": "time_dense_1",
              "conv_in": "conv_in", "conv_out": "conv_out",
              "conv_norm_out": "GroupNorm32_0/GroupNorm_0"}
    if mod in simple:
        return simple[mod]
    m = re.match(r"(down|up)_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\."
                 r"(.+)$", mod)
    if m:
        d, i, kind, b, rest = m.groups()
        top = f"{d}_{_level(d, i, levels)}_" \
            f"{'res' if kind == 'resnets' else 'attn'}_{b}"
        return f"{top}/{_RES_INV[rest] if kind == 'resnets' else _st_path(rest)}"
    m = re.match(r"(down|up)_blocks\.(\d+)\.(down|up)samplers\.0\.conv$", mod)
    if m:
        d, i = m.group(1), m.group(2)
        return f"{d}_{_level(d, i, levels)}_{d}sample"
    m = re.match(r"mid_block\.resnets\.(\d+)\.(.+)$", mod)
    if m:
        return f"mid_res_{m.group(1)}/{_RES_INV[m.group(2)]}"
    return "mid_attn/" + _st_path(mod[len("mid_block.attentions.0."):])


def _vae_module(mod: str, levels: int) -> str:
    if mod in ("quant_conv", "post_quant_conv"):
        return ("encoder/" if mod == "quant_conv" else "decoder/") + mod
    side, _, p = mod.partition(".")
    if p in ("conv_in", "conv_out"):
        return f"{side}/{p}"
    if p == "conv_norm_out":
        return f"{side}/GroupNorm32_0/GroupNorm_0"
    m = re.match(r"mid_block\.resnets\.(\d+)\.(\w+)$", p)
    if m:
        return f"{side}/mid_res_{m.group(1)}/{_RES_INV[m.group(2)]}"
    m = re.match(r"mid_block\.attentions\.0\.(.+)$", p)
    if m:
        return f"{side}/mid_attn/{_VAE_ATTN_INV[m.group(1)]}"
    m = re.match(r"(down|up)_blocks\.(\d+)\.resnets\.(\d+)\.(\w+)$", p)
    if m:
        d, i, b, sub = m.groups()
        return f"{side}/{d}_{_level(d, i, levels)}_res_{b}/{_RES_INV[sub]}"
    m = re.match(r"(down|up)_blocks\.(\d+)\.(down|up)samplers\.0\.conv$", p)
    d, i = m.group(1), m.group(2)
    return f"{side}/{d}_{_level(d, i, levels)}_{d}sample"


def _clip_text_module(mod: str) -> str:
    simple = {"embeddings.token_embedding": "token_embedding",
              "final_layer_norm": "final_ln"}
    if mod in simple:
        return simple[mod]
    m = re.match(r"encoder\.layers\.(\d+)\.(.+)$", mod)
    return f"layer_{m.group(1)}/{_CLIP_INV[m.group(2)]}"


def _clip_vision_module(mod: str) -> str:
    simple = {"embeddings.patch_embedding": "patch_embed",
              "pre_layrnorm": "pre_ln", "post_layernorm": "post_ln",
              "visual_projection": "visual_projection"}
    if mod in simple:
        return simple[mod]
    m = re.match(r"encoder\.layers\.(\d+)\.(.+)$", mod)
    return f"layer_{m.group(1)}/{_CLIP_INV[m.group(2)]}"


def _if_sub(sub: str) -> str:
    if sub in ("norm1", "norm2", "group_norm", "norm_cross"):
        return f"{sub}/gn"
    return "to_out" if sub == "to_out.0" else sub


def _if_unet_module(mod: str, levels: int) -> str:
    simple = {"time_embedding.linear_1": "time_dense_0",
              "time_embedding.linear_2": "time_dense_1",
              "encoder_hid_proj": "encoder_hid_proj", "conv_in": "conv_in",
              "conv_out": "conv_out", "conv_norm_out": "norm_out/gn"}
    if mod in simple:
        return simple[mod]
    if mod.startswith("add_embedding."):
        return "add_embedding/" + mod[len("add_embedding."):].replace(
            ".", "/")
    m = re.match(r"(down|up)_blocks\.(\d+)\.(resnets|attentions)\.(\d+)\."
                 r"(.+)$", mod)
    if m:
        d, i, kind, b, sub = m.groups()
        return f"{d}_{_level(d, i, levels)}_" \
            f"{'res' if kind == 'resnets' else 'attn'}_{b}/{_if_sub(sub)}"
    m = re.match(r"(down|up)_blocks\.(\d+)\.(down|up)samplers\.0\.(.+)$", mod)
    if m:
        d, i, _, sub = m.groups()
        return f"{d}_{_level(d, i, levels)}_{d}/{_if_sub(sub)}"
    m = re.match(r"mid_block\.resnets\.(\d+)\.(.+)$", mod)
    if m:
        return f"mid_res_{m.group(1)}/{_if_sub(m.group(2))}"
    return "mid_attn/" + _if_sub(mod[len("mid_block.attentions.0."):])


def _t5_path(key: str) -> str:
    if key == "shared.weight":
        return "shared/embedding"
    if key == "encoder.final_layer_norm.weight":
        return "final_ln/weight"
    m = re.match(r"encoder\.block\.(\d+)\.layer\.(\d)\.(.+)\.weight$", key)
    i, layer, sub = m.groups()
    sub = {"SelfAttention.relative_attention_bias":
           "attn/relative_attention_bias", "layer_norm":
           "ln_attn/weight" if layer == "0" else "ln_ff/weight"}.get(sub)\
        or ("attn/" + sub.split(".")[1] + "/kernel" if layer == "0" else
            sub.split(".")[1] + "/kernel")
    return f"block_{i}/{sub}"


_MODULES = {"unet": _unet_module, "vae": _vae_module,
            "if_unet": _if_unet_module,
            "text": lambda m, L: _clip_text_module(m),
            "vision": lambda m, L: _clip_vision_module(m)}
_RAW = ("embeddings.class_embedding", "embeddings.position_embedding.weight",
        "add_embedding.pool.positional_embedding")


def flax_path(tower: str, key: str, levels: int = 0) -> str:
    """The inverse of ``tower_key(tower, levels)``: a port key → its Flax
    path."""
    if tower == "t5":
        return _t5_path(key)
    if tower == "cc_projection":
        return {"weight": "kernel", "bias": "bias"}[key]
    if tower == "clip":
        if key == "text_projection.weight":
            return "text_projection"
        sub, _, rest = key.partition(".")
        return f"{sub}/{flax_path(sub, rest)}"
    if key in _RAW:
        return {"embeddings.class_embedding": "class_embedding",
                "embeddings.position_embedding.weight": "position_embedding",
                "add_embedding.pool.positional_embedding":
                "add_embedding/pool/positional_embedding"}[key]
    mod, leaf = key.rsplit(".", 1)
    if mod == "embeddings.token_embedding":
        return "token_embedding/embedding"
    path = _MODULES[tower](mod, levels)
    last = path.rsplit("/", 1)[-1]
    norm = last in ("GroupNorm_0", "gn", "final_ln", "pre_ln", "post_ln") or \
        re.fullmatch(r"(ln|norm)\d", last) is not None
    leaf = "bias" if leaf == "bias" else ("scale" if norm else "kernel")
    return f"{path}/{leaf}"


def tower_to_flax(tower: str, state: Mapping[str, torch.Tensor],
                  levels: int = 0) -> Dict[str, np.ndarray]:
    """A port tower's state → the flat dict JAX's ``save_params_npz``
    writes for it: Flax paths and layouts (conv ``[kh, kw, I, O]``, 1×1
    convs the port keeps as a matrix back to ``[1, 1, I, O]``, Dense
    ``[in, out]``)."""
    one_by_one = _FLAX_1X1.get(tower, ())
    out = {}
    for key, t in state.items():
        path = flax_path(tower, key, levels)
        a = t.detach().float().cpu().numpy()
        if path.endswith(("kernel", "text_projection")):
            mod = path.rsplit("/", 2)[-2] if "/" in path else ""
            if a.ndim == 2 and mod in one_by_one:
                a = a.T[None, None]
            else:
                a = _flax_leaf(t)
        out[path] = np.ascontiguousarray(a)
    return out


def dpt_to_flax(module) -> Dict[str, np.ndarray]:
    """The port DPT's state → JAX ``save_params_npz``'s flat dict
    (``params/vit/...``)."""
    out = {}
    for k, v in module.state_dict().items():
        path = _dpt_flax_path(k)
        a = _flax_leaf(v) if path.endswith("kernel") else \
            v.detach().float().cpu().numpy()
        out[f"params/{path}"] = a
    return out


def convert_dpt(src: str, model) -> None:
    """``src``: omnidata_dpt_{depth,normal}_v2 ``.ckpt``/``.pt`` → the
    port's ``DPTDepthModel`` (the ``state_dict`` and Lightning ``model.``
    wrappers dropped, as JAX's ``convert_dpt``; the checkpoint's dead
    ``scratch.refinenet4.resConfUnit1`` left unread)."""
    from .raw_weights import fill_tower, load_torch_state_dict
    sd = load_torch_state_dict(src)
    if any(k.startswith("model.") for k in sd):
        sd = {k[6:]: v for k, v in sd.items() if k.startswith("model.")}
    fill_tower(model, sd, "dpt")



def towers_to_flax(kind: str, src: str, sd_version: str = "2.1"
                   ) -> Dict[str, Dict[str, np.ndarray]]:
    """A raw checkpoint of `kind` (sd, zero123, clip, if) through the
    port's raw converters (``utils/raw_weights.py``) into its towers on
    the CPU → {file name: the flat dict JAX's ``save_params_npz`` writes},
    the files JAX's converter CLI writes: ``unet``, ``vae``, ``text`` (SD);
    ``unet``, ``vae``, ``vision``, ``cc_projection`` (zero123); ``clip``;
    ``unet`` and, with a T5 encoder, ``t5`` (IF)."""
    from .raw_weights import (convert_if, convert_sd, convert_zero123,
                              fit_layout)
    if kind == "sd":
        from ..guidance.sd import SDConfig, StableDiffusionGuidance
        g = StableDiffusionGuidance(SDConfig(sd_version=sd_version), "cpu")
        convert_sd(src, g)
        towers = {"unet": g.unet, "vae": g.vae, "text": g.text_encoder}
    elif kind == "zero123":
        from ..guidance.zero123 import Zero123Config, Zero123Guidance
        g = Zero123Guidance(Zero123Config(), "cpu")
        convert_zero123(src, g)
        towers = {"unet": g.unet, "vae": g.vae, "vision": g.vision,
                  "cc_projection": g.cc_projection}
    elif kind == "if":
        from ..guidance.deepfloyd import IFConfig, IFGuidance
        g = IFGuidance(IFConfig(), "cpu")
        convert_if(src, g)
        towers = {"unet": g.unet}
        if g.t5 is not None:
            towers["t5"] = g.t5
    elif kind == "clip":
        from ..guidance.clip import CLIPConfig, CLIPGuidance
        from .raw_weights import load_torch_state_dict
        g = CLIPGuidance(CLIPConfig(), "cpu")
        sd = load_torch_state_dict(src)
        state = {}
        for k in g.towers.state_dict():
            tower, _, rest = k.partition(".")
            raw = {"vision": "vision_model.", "text": "text_model."}.get(
                tower, "") + rest
            if rest.startswith("visual_projection."):
                raw = rest
            if tower == "text_projection":
                raw = k
            if raw in sd:
                state[k] = fit_layout(sd[raw], g.towers.state_dict()[k].shape,
                                      raw)
        # JAX's converter reads what the file has (strict=False)
        g.towers.load_state_dict(state, strict=False)
        return {"clip": tower_to_flax("clip", g.towers.state_dict())}
    else:
        raise ValueError(f"unknown kind {kind}")
    out = {}
    for name, module in towers.items():
        tower = "if_unet" if kind == "if" and name == "unet" else name
        sd = module.state_dict()
        out[name] = tower_to_flax(tower, sd, _port_levels(tower, sd))
    return out


def _port_levels(tower: str, state) -> int:
    """Resolution levels of a port UNet or VAE from its keys (the down
    blocks'; the VAE encoder's)."""
    pre = "encoder.down_blocks." if tower == "vae" else "down_blocks."
    if tower not in ("unet", "if_unet", "vae"):
        return 0
    return 1 + max(int(k[len(pre):].split(".")[0]) for k in state
                   if k.startswith(pre))

def main(argv=None):
    """``python -m dreamfusion_tpu_torch.utils.convert --kind … --src …
    --out dir``: a raw checkpoint → ``dir/<tower>.npz`` in JAX's
    ``save_params_npz`` layout (Flax paths and layouts), which both
    packages' ``--pretrained_root`` read."""
    import argparse
    import os
    ap = argparse.ArgumentParser("convert")
    ap.add_argument("--kind", choices=["sd", "zero123", "clip", "if", "dpt"],
                    required=True)
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True, help="output dir for npz files")
    ap.add_argument("--sd_version", default="2.1")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.kind == "dpt":
        from ..models.dpt import DPTConfig, DPTDepthModel
        normal = "normal" in os.path.basename(args.src)
        model = DPTDepthModel(DPTConfig.normal() if normal
                              else DPTConfig.depth())
        convert_dpt(args.src, model)
        name = "dpt_normal" if normal else "dpt_depth"
        np.savez(os.path.join(args.out, f"{name}.npz"), **dpt_to_flax(model))
    else:
        for name, flat in towers_to_flax(args.kind, args.src,
                                         args.sd_version).items():
            np.savez(os.path.join(args.out, f"{name}.npz"), **flat)
    print(f"converted {args.kind} weights from {args.src} → {args.out}")


if __name__ == "__main__":
    main()
