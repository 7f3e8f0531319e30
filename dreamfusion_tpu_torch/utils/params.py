"""Converted weights on disk (``dreamfusion_tpu/utils/params.py``:
``save_params_npz``, ``load_params_npz``, ``maybe_load_params``).

A tower's file ``root/<tower>.npz`` (DeepFloyd-IF's: ``unet.npz`` and
``t5.npz``, ``guidance/deepfloyd.py``) holds its Flax parameter pytree
flattened to ``/``-joined keys (``down_0_res_0/conv1/kernel``), in the Flax
layouts.  It is read with numpy, the keys carried onto the port's module
by ``utils/convert.py`` (the layouts too), and copied into the module's
parameters in their dtype and on their device.  As in JAX, a key the file
lacks keeps the module's value, and a shape that does not fit raises.  A
root without such files is a raw checkpoint, converted on the fly
(``utils/raw_weights.py``).
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from .convert import _leaf, tower_key, tower_levels


def load_params_npz(path: str, module: nn.Module, tower: str) -> int:
    """Copy `path`'s arrays into `module`, the guidance tower `tower`
    (``unet``, ``vae``, ``text``, ``vision``, ``cc_projection``,
    DeepFloyd-IF's ``if_unet`` and ``t5``, or the ``dpt``) → the number of
    tensors read.  A key with no place in the module is left
    unread, as JAX's reader looks up only the template's keys."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    key = tower_key(tower, tower_levels(tower, arrays))
    state = module.state_dict()
    n = 0
    for path_key, arr in arrays.items():
        name = key(path_key)
        if name is None or name not in state:
            continue
        value = _leaf(path_key, arr, tower in ("if_unet", "dpt"))
        dst = state[name]
        if tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"{path}: {path_key}: npz shape {arr.shape} "
                             f"does not fit the tower's {name} "
                             f"{tuple(dst.shape)}")
        with torch.no_grad():
            dst.copy_(value.to(dst.dtype))
        n += 1
    return n


def load_pretrained_towers(root: str, towers: Dict[str, nn.Module],
                           convert: Callable[[str], None]) -> None:
    """JAX's rule: a root holding any ``<tower>.npz`` reads each of
    `towers` whose file is there (the others keep their weights: JAX's
    ``maybe_load_params``); any other root, a raw diffusers directory or a
    ``.ckpt`` file, is converted on the fly by ``convert(root)``
    (``utils/raw_weights.py``)."""
    paths = {name: os.path.join(root, f"{name}.npz") for name in towers}
    if not (os.path.isdir(root) and
            any(os.path.exists(p) for p in paths.values())):
        convert(root)
        return
    for name, module in towers.items():
        if os.path.exists(paths[name]):
            load_params_npz(paths[name], module, name)
