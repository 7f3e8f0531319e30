"""Carry the JAX package's weights into the port.

Layouts: a Flax conv kernel ``[kh, kw, I, O]`` becomes the K12 kernel's
``[O, kh, kw, I]`` (input channels contiguous, one output channel's
K = kh·kw·I slice per row); a 1×1 conv, which the port computes as
``F.linear``, and an ``nn.Dense`` kernel ``[in, out]`` become an
``nn.Linear`` weight ``[out, in]``; GroupNorm and LayerNorm ``scale``
becomes ``weight``.  The guidance towers' module names are the diffusers
(UNet, VAE) and transformers (CLIP text) checkpoint keys, so the Flax paths
map onto them as the JAX package's own converter maps those checkpoints.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch


def _linear(kernel) -> torch.Tensor:
    return torch.from_numpy(np.array(kernel, dtype=np.float32).T.copy())


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX param pytree with numpy leaves → the port's state_dict(s).

    ``{'field': {'triplanes': [...], 'sigma_net': {...}, 'bg_net': {...}}}``
    (``NeRFRenderer``) → the renderer's ``state_dict``, triplanes in their
    [3, R, R, C] layout.  ``{'unet', 'vae', 'text'}`` (the guidance towers
    of ``StableDiffusionGuidance.init_params``) → ``{'unet': state_dict,
    'vae': ..., 'text': ...}``.  The DMTet stage's ``{'nerf': ..., 'geo':
    {'sdf', 'deform'}}`` → the ``DMTetModel`` state_dict (``nerf.*``,
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
    for s, plane in enumerate(field["triplanes"]):
        out[f"field.triplanes.{s}"] = torch.from_numpy(
            np.array(plane, dtype=np.float32))
    for net in ("sigma_net", "bg_net"):
        for l in range(len(field.get(net, {}))):
            dense = field[net][f"dense_{l}"]
            out[f"field.{net}.layers.{l}.weight"] = _linear(dense["kernel"])
            out[f"field.{net}.layers.{l}.bias"] = torch.from_numpy(
                np.array(dense["bias"], dtype=np.float32))
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


def _leaf(path: str, leaf) -> torch.Tensor:
    a = np.array(leaf, dtype=np.float32)
    if path.endswith("kernel"):
        if a.ndim == 4 and a.shape[:2] == (1, 1):
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


def _tower(tree, key: Callable[[str], Optional[str]]
           ) -> Dict[str, torch.Tensor]:
    out = {}
    for path, leaf in _flat(tree):
        k = key(path)
        if k is None:
            raise KeyError(f"no port key for Flax parameter {path}")
        out[k] = _leaf(path, leaf)
    return out


def _levels(tree) -> int:
    """Resolution levels of a UNet or VAE encoder tree."""
    return 1 + max(int(m.group(1)) for k in tree
                   for m in [re.match(r"down_(\d+)_res_", k)] if m)


def _towers(params: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    out = {}
    if "unet" in params:
        L = _levels(params["unet"])
        out["unet"] = _tower(params["unet"], lambda p: unet_key(p, L))
    if "vae" in params:
        L = _levels(params["vae"]["encoder"])
        out["vae"] = _tower(params["vae"], lambda p: vae_key(p, L))
    if "text" in params:
        out["text"] = _tower(params["text"], clip_text_key)
    return out
