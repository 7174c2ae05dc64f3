"""Load the JAX package's parameter trees into the port's modules.

A checkpoint `params.npz` stores one array per leaf under its
`jax.tree_util.keystr` path, e.g. `['unet']['DownBlock_0']['DoubleConv_0']
['conv1_kernel']`, possibly downcast to float16. The port's modules carry
the flax module names, so a path names its torch parameter once the leaf
is renamed and its layout mapped:

- conv kernels, HWIO -> OIHW (`kernel` of `nn.Conv`, `conv1_kernel` and
  `conv2_kernel` of DoubleConv);
- transposed-conv kernels (`kernel` of a module named `ConvTranspose_*`),
  HWIO flipped in both spatial axes -> (in, out, kh, kw), the weight of
  `torch.nn.functional.conv_transpose2d` (`models.layers.ConvTranspose`);
- Dense kernels, (in, out) -> Linear weights (out, in);
- attention DenseGeneral q/k/v kernels (C, heads, Dh) -> (heads*Dh, C) with
  biases (heads, Dh) -> (heads*Dh,); the out kernel (heads, Dh, C) ->
  (C, heads*Dh).

GroupNorm's `scale` and `bias` keep their names and layout. Every array
is cast to float32. Loading is strict: a leaf left over, a parameter
missing or a shape that differs raises. `params_to_jax` is the inverse:
the port's modules (or any tensors laid out like their parameters, such
as Adam's moments) as keystr leaves in the flax layout.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from . import resolve_device
from .models import Encoder, ResNet18GN, UNetFiLM, UNetSimple
from .models.layers import ConvTranspose, _MHA

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
        if arr.ndim == 4 and parent.startswith("ConvTranspose_"):
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)     # flipped HWIO
        elif arr.ndim == 4:                                 # nn.Conv, HWIO
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
    """The U-Net shaped by, and loaded from, the tree under `['unet']`: a
    UNetSimple for a tree with `_CondConcat_0` or without `DownBlock_0`, a
    UNetFiLM otherwise."""
    dev = resolve_device(device)
    dc0 = tree["DoubleConv_0"]
    shape = dict(out_channels=tree["Conv_0"]["kernel"].shape[-1],
                 width=dc0["conv2_kernel"].shape[-1],
                 in_channels=dc0["conv1_kernel"].shape[2])
    if "_CondConcat_0" in tree or "DownBlock_0" not in tree:
        cc = tree.get("_CondConcat_0")
        unet = UNetSimple(
            cond_dim=None if cc is None else cc["Dense_0"]["kernel"].shape[0],
            time_dim=tree["Dense_0"]["kernel"].shape[0], **shape)
    else:
        pa = tree["DownBlock_0"]["_PostAffine_0"]
        unet = UNetFiLM(
            cond_dim=pa["film_dense"]["kernel"].shape[0],
            time_dim=pa["time_dense"]["kernel"].shape[0],
            with_attention="SelfAttention_0" in tree, **shape)
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


def _jax_leaf(mod: torch.nn.Module, parent, leaf: str, arr: np.ndarray):
    """(flax leaf name, array in flax layout) for parameter `leaf` of
    module `mod`, whose parent module is `parent`: `_torch_leaf`
    inverted."""
    heads = parent.num_heads if isinstance(parent, _MHA) else None
    if leaf == "weight" and isinstance(mod, ConvTranspose):
        return "kernel", arr.transpose(2, 3, 0, 1)[::-1, ::-1]
    if leaf in ("conv1_kernel", "conv2_kernel"):
        return leaf, arr.transpose(2, 3, 1, 0)
    if leaf == "weight":
        if arr.ndim == 4:                                   # OIHW -> HWIO
            return "kernel", arr.transpose(2, 3, 1, 0)
        if heads is not None and mod is not parent.out:     # q/k/v
            return "kernel", arr.T.reshape(arr.shape[1], heads, -1)
        if heads is not None:                               # out
            return "kernel", arr.T.reshape(heads, -1, arr.shape[0])
        return "kernel", arr.T
    if leaf == "bias" and heads is not None and mod is not parent.out:
        return leaf, arr.reshape(heads, -1)
    return leaf, arr


def params_to_jax(params: Dict[str, torch.nn.Module],
                  values=None) -> Dict[str, np.ndarray]:
    """{keystr: float32 array in flax layout} for every parameter of the
    policy modules ({'unet': ..., 'encoder': ...}), under the names
    `jax.tree_util.keystr` gives the JAX package's tree. `values` maps a
    parameter to a tensor of its shape to emit in its place (an optimizer
    moment, say); by default the parameter itself."""
    out = {}
    for top, module in params.items():
        parents = {}
        for path, mod in module.named_modules():
            for child_name, child in mod.named_children():
                parents[child] = mod
            for leaf, p in mod.named_parameters(recurse=False):
                t = p if values is None else values[p]
                # a copy: a CPU tensor's numpy() is a view, and the caller
                # may update the tensor in place while the snapshot is kept
                arr = np.array(t.detach().float().cpu())
                name, arr = _jax_leaf(mod, parents.get(mod), leaf, arr)
                keys = [top, *(path.split(".") if path else []), name]
                out["".join(f"['{k}']" for k in keys)] = \
                    np.ascontiguousarray(arr)
    return out
