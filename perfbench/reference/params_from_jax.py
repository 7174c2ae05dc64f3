"""Load the JAX package's parameter trees into the reference's modules.

A checkpoint `params.npz` stores one array per leaf under its
`jax.tree_util.keystr` path, e.g. `['unet']['DownBlock_0']['DoubleConv_0']
['conv1_kernel']`, possibly downcast to float16. The port's modules carry
the flax module names, so a path names its torch parameter once the leaf
is renamed and its layout mapped:

- conv kernels, HWIO -> OIHW (`kernel` of `nn.Conv`, `conv1_kernel` and
  `conv2_kernel` of DoubleConv);
- Dense kernels, (in, out) -> Linear weights (out, in);
- attention DenseGeneral q/k/v kernels (C, heads, Dh) -> (heads*Dh, C) with
  biases (heads, Dh) -> (heads*Dh,); the out kernel (heads, Dh, C) ->
  (C, heads*Dh).

GroupNorm's `scale` and `bias` keep their names and layout. Every array
is cast to float32. Loading is strict: a leaf left over, a parameter
missing or a shape that differs raises.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from . import resolve_device
from .models import Encoder, ResNet18GN, UNetFiLM

_KEY = re.compile(r"\['([^']*)'\]")


def parse_keystr(key: str) -> tuple:
    """"['unet']['Conv_0']['kernel']" -> ("unet", "Conv_0", "kernel")."""
    parts = tuple(_KEY.findall(key))
    if "".join(f"['{p}']" for p in parts) != key:
        raise ValueError(f"not a keystr path of dict keys: {key!r}")
    return parts


def load_npz(path: str) -> Dict[str, dict]:
    """npz of keystr leaves -> nested dict of float32 numpy arrays."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = parse_keystr(key)
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = np.asarray(data[key], dtype=np.float32)
    return tree


def _flatten(tree: dict, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, dtype=np.float32)
    return out


def _torch_leaf(path: tuple, arr: np.ndarray):
    """(torch parameter name, array in torch layout) for one flax leaf."""
    *mods, leaf = path
    parent = mods[-1] if mods else ""
    if leaf == "kernel":
        if arr.ndim == 4:                                   # nn.Conv, HWIO
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 3 and parent in ("query", "key", "value"):
            arr = arr.reshape(arr.shape[0], -1).T           # (C, H, Dh)
        elif arr.ndim == 3 and parent == "out":
            arr = arr.reshape(-1, arr.shape[-1]).T          # (H, Dh, C)
        elif arr.ndim == 2:                                 # Dense
            arr = arr.T
        else:
            raise ValueError(f"unexpected kernel {path} of shape {arr.shape}")
        leaf = "weight"
    elif leaf in ("conv1_kernel", "conv2_kernel"):
        arr = arr.transpose(3, 2, 0, 1)
    elif leaf == "bias" and arr.ndim == 2:                  # q/k/v (H, Dh)
        arr = arr.reshape(-1)
    return ".".join([*mods, leaf]), np.ascontiguousarray(arr)


def load_into(module: torch.nn.Module, tree: dict) -> torch.nn.Module:
    """Copy a flax parameter tree into `module`, strictly."""
    state = {}
    for path, arr in _flatten(tree).items():
        name, arr = _torch_leaf(path, arr)
        state[name] = torch.from_numpy(arr)
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    bad = sorted(n for n in set(own) & set(state)
                 if tuple(own[n].shape) != tuple(state[n].shape))
    if missing or extra or bad:
        raise ValueError(
            f"parameter tree does not fit {type(module).__name__}: "
            f"missing {missing}, left over {extra}, shapes differ {bad}")
    module.load_state_dict(state, strict=True)
    return module


def unet_from_jax(tree: dict, device="cuda"):
    """The UNetFiLM shaped by, and loaded from, the tree under
    `['unet']`; any other net raises."""
    dev = resolve_device(device)
    if "DownBlock_0" not in tree or "SelfAttention_0" not in tree:
        raise ValueError("the reference holds UNetFiLM with attention only")
    dc0 = tree["DoubleConv_0"]
    pa = tree["DownBlock_0"]["_PostAffine_0"]
    unet = UNetFiLM(
        cond_dim=pa["film_dense"]["kernel"].shape[0],
        out_channels=tree["Conv_0"]["kernel"].shape[-1],
        time_dim=pa["time_dense"]["kernel"].shape[0],
        width=dc0["conv2_kernel"].shape[-1],
        in_channels=dc0["conv1_kernel"].shape[2])
    return load_into(unet, tree).to(dev).eval()


def encoder_from_jax(tree: dict, device="cuda"):
    """The vision encoder shaped by, and loaded from, the tree under
    `['encoder']`: a ResNet18GN for a tree with `BasicBlock_0`, the conv-AE
    Encoder otherwise."""
    dev = resolve_device(device)
    if "BasicBlock_0" in tree:
        n_blocks = sum(k.startswith("BasicBlock_") for k in tree)
        if n_blocks != 8:
            raise ValueError(f"a ResNet-18 tree has 8 BasicBlocks, not "
                             f"{n_blocks}")
        enc = ResNet18GN(channels=tree["Conv_0"]["kernel"].shape[2])
    else:
        enc = Encoder(latent_dim=tree["Dense_0"]["kernel"].shape[-1],
                      channels=tree["Conv_0"]["kernel"].shape[2])
    return load_into(enc, tree).to(dev).eval()


def params_from_jax(tree: dict, device="cuda") -> Dict[str, torch.nn.Module]:
    """{'unet': ..., 'encoder': ...} from a whole policy tree; raises on a
    top-level entry other than those two."""
    extra = sorted(set(tree) - {"unet", "encoder"})
    if extra:
        raise ValueError(f"unexpected top-level parameter trees: {extra}")
    params = {"unet": unet_from_jax(tree["unet"], device)}
    if "encoder" in tree:
        params["encoder"] = encoder_from_jax(tree["encoder"], device)
    return params

