"""Kernel K2: nearest-texel palette bytes for every pixel of every env.

Counterpart of `state_policy_diffusionmodel_tpu/render/pallas_sampler.py`
(`sample_banked`, body `_kernel`). For env b and pixel p of the flat
(72, 128) image plane the texel map is

    px = (c*rx[p] + s*ry[p]) + pos_x,   py = ((-s)*rx[p] + c*ry[p]) + pos_y,
    fx = (px + PLAYFIELD) * scale,      fy = (py + PLAYFIELD) * scale,

in float32, in that order, and the result is tex_bank[track_ids[b],
floor(fx), floor(fy)] where 0 <= fx, fy < T, else 0. The TPU kernel DMAs a
texel window and gathers with one-hot matmuls because the TPU has no
per-lane gather; Hopper has one, so `csrc/sample_banked.cu` gathers
directly, on a grid `sample_banked_plan` sizes to the card.

- `sample_banked` launches the CUDA kernel for CUDA tensors (and counts
  the launch in `sample_banked.launches`) and takes the plain version for
  CPU tensors; there is no fallback.
- `sample_banked_ref` is the plain version: the same map, then a direct
  gather.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..track.generator import PLAYFIELD

ROWS, LANES = 72, 128


def texel_scale(tex_size: int) -> float:
    """World -> texel scale, as the JAX code forms it (a Python double that
    enters the float32 arithmetic rounded to float32)."""
    return tex_size / (2.0 * PLAYFIELD)


def texel_coords(cos_a, sin_a, pos, rx, ry, tex_size: int):
    """(fx, fy), each (B, 72, 128) float32: the kernel's texel map."""
    c = cos_a[:, None, None]
    s = sin_a[:, None, None]
    px = (c * rx + s * ry) + pos[:, 0, None, None]
    py = ((-s) * rx + c * ry) + pos[:, 1, None, None]
    scale = texel_scale(tex_size)
    return (px + PLAYFIELD) * scale, (py + PLAYFIELD) * scale


def sample_banked_ref(tex_bank: torch.Tensor, track_ids: torch.Tensor,
                      cos_a: torch.Tensor, sin_a: torch.Tensor,
                      pos: torch.Tensor, rx: torch.Tensor,
                      ry: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: (B, 72, 128) int32 packed palette bytes."""
    T = tex_bank.shape[-1]
    fx, fy = texel_coords(cos_a, sin_a, pos, rx, ry, T)
    infield = (fx >= 0) & (fx < T) & (fy >= 0) & (fy < T)
    fi = torch.floor(fx).to(torch.int64).clamp(0, T - 1)
    fj = torch.floor(fy).to(torch.int64).clamp(0, T - 1)
    vals = tex_bank[track_ids.to(torch.int64)[:, None, None], fi, fj]
    return torch.where(infield, vals.to(torch.int32),
                       torch.zeros((), dtype=torch.int32,
                                   device=tex_bank.device))


THREADS, PIXELS_A_THREAD = 256, 4
# CTAs across one env's 9,216 pixels: 1,024 each (8 screen rows)
STRIPS = ROWS * LANES // (THREADS * PIXELS_A_THREAD)
_CTAS_A_SM = 8          # 2,048 threads an SM in CTAs of 256


@functools.lru_cache(maxsize=None)
def sample_banked_plan(B: int, n_sm: int) -> int:
    """K2's grid for B envs on a card of `n_sm` SMs: `groups` x STRIPS CTAs,
    CTA (strip, g) rendering its strip of envs g, g + groups, ...; as many
    as the SMs hold at once (8 of 256 threads each), at most one a strip of
    an env. Cached: the wrapper asks on every call."""
    return max(1, min(B, n_sm * _CTAS_A_SM // STRIPS))


def _sampler_lib() -> ctypes.CDLL:
    from ..kernels import build

    lib = build.library("sample_banked")
    if not getattr(lib, "_spdm_typed", False):
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sample_banked_launch.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,   # tex .. out
            i32, i32, i32,                            # B, U, T
            f32, f32, i32, ptr]                       # playfield, scale,
        lib.sample_banked_launch.restype = i32        # groups, stream
        lib._spdm_typed = True
    return lib


def sample_banked_cuda(tex_bank, track_ids, cos_a, sin_a, pos, rx, ry):
    """Launch the CUDA kernel on the bank's device and current stream under
    `sample_banked_plan`; raises on any input it does not take (rx and ry
    must be 16-byte aligned, as `raster.pixel_planes` gives them) and on a
    refused launch. Track ids outside [0, U) read nothing and give 0."""
    dev = tex_bank.device
    args = dict(tex_bank=tex_bank, track_ids=track_ids, cos_a=cos_a,
                sin_a=sin_a, pos=pos, rx=rx, ry=ry)
    if not tex_bank.is_cuda or any(t.device != dev for t in args.values()):
        raise ValueError("sample_banked_cuda: all inputs must be on one CUDA "
                         "device, got " + ", ".join(
                             f"{k} {t.device}" for k, t in args.items()))
    want = dict(tex_bank=torch.uint8, track_ids=torch.int32,
                cos_a=torch.float32, sin_a=torch.float32, pos=torch.float32,
                rx=torch.float32, ry=torch.float32)
    bad = {k: args[k].dtype for k in want if args[k].dtype != want[k]}
    if bad:
        raise TypeError(f"sample_banked_cuda: dtypes {bad}, want uint8 bank, "
                        "int32 ids and float32 camera scalars and planes")
    B = track_ids.shape[0] if track_ids.dim() == 1 else -1
    U, T = tex_bank.shape[0], tex_bank.shape[-1]
    shapes_ok = (tex_bank.dim() == 3 and tex_bank.shape[1] == T and B > 0
                 and tuple(cos_a.shape) == (B,)
                 and tuple(sin_a.shape) == (B,) and tuple(pos.shape) == (B, 2)
                 and tuple(rx.shape) == (ROWS, LANES)
                 and tuple(ry.shape) == (ROWS, LANES))
    if not shapes_ok:
        raise ValueError("sample_banked_cuda: shapes " + ", ".join(
            f"{k} {tuple(t.shape)}" for k, t in args.items()))
    if not all(t.is_contiguous() for t in args.values()):
        raise ValueError("sample_banked_cuda: inputs must be contiguous")
    if rx.data_ptr() % 16 or ry.data_ptr() % 16:
        raise ValueError("sample_banked_cuda: rx and ry must be 16-byte "
                         "aligned")
    from ..models.cuda_ops import _n_sm

    out = _sample_banked_launch(args, sample_banked_plan(B, _n_sm(dev)))
    _DISPATCH.launches += 1
    return out


def _sample_banked_launch(args: dict, groups: int) -> torch.Tensor:
    """K2 on `groups` x STRIPS CTAs, on inputs `sample_banked_cuda` has
    checked."""
    tex_bank, track_ids = args["tex_bank"], args["track_ids"]
    dev = tex_bank.device
    B, U, T = track_ids.shape[0], tex_bank.shape[0], tex_bank.shape[-1]
    out = torch.empty((B, ROWS, LANES), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _sampler_lib().sample_banked_launch(
            *(args[k].data_ptr() for k in ("tex_bank", "track_ids", "cos_a",
                                           "sin_a", "pos", "rx", "ry")),
            out.data_ptr(), B, U, T, PLAYFIELD, texel_scale(T), groups,
            stream)
    if rc != 0:
        raise RuntimeError(f"sample_banked kernel launch failed: CUDA error "
                           f"{rc} at B={B}, U={U}, T={T}, groups {groups}")
    return out


def sample_banked(tex_bank: torch.Tensor, track_ids: torch.Tensor,
                  cos_a: torch.Tensor, sin_a: torch.Tensor, pos: torch.Tensor,
                  rx: torch.Tensor, ry: torch.Tensor) -> torch.Tensor:
    """Batched nearest-texel fetch from a bank of track textures.

    tex_bank (U, T, T) uint8 packed palette (base * 8 + lane); track_ids
    (B,) int32; cos_a, sin_a (B,) camera rotation; pos (B, 2) camera scroll;
    rx, ry (72, 128) camera-frame pixel planes. Returns (B, 72, 128) int32,
    0 off the field."""
    if tex_bank.is_cuda:
        return sample_banked_cuda(tex_bank, track_ids, cos_a, sin_a, pos,
                                  rx, ry)
    if tex_bank.device.type == "cpu":
        return sample_banked_ref(tex_bank, track_ids, cos_a, sin_a, pos,
                                 rx, ry)
    raise ValueError(f"sample_banked: unsupported device {tex_bank.device}")


sample_banked.launches = 0
# the counter's owner, also while a caller has `sample_banked` patched over
_DISPATCH = sample_banked
