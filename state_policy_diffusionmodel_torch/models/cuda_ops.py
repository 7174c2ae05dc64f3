"""Hot ops of the denoiser as hand-written CUDA kernels, each beside its
plain PyTorch version.

Counterpart of `state_policy_diffusionmodel_tpu/models/pallas_ops.py`.

- `attention_core` (TPU kernel `_attn_pallas`) runs the CUDA kernel in
  `csrc/attention_core.cu` for CUDA tensors with T >= 16 and Dh >= 8, the
  shape rule of the TPU dispatch `_attn_impl`; smaller shapes (the U-Net's
  4x1 bottleneck) and CPU tensors take `attention_core_ref`.
- The conv path follows the JAX package's selector, read once at import
  into `CONV_PATH`: `SPDM_CONV_PATH` = `xla9` (the default), `xla` or
  `pallas`, and `SPDM_PALLAS_CONV=1` as an alias of `pallas`. On `xla9`
  and `xla` every conv block runs the plain PyTorch formulation
  (`conv3x3_ref`, `double_conv_ref`: cuDNN on the card). On `pallas`, CUDA
  tensors that meet the TPU dispatch's shape rule (Cin >= 8 and
  B*H*W >= 1024) take the hand-written kernels that stand in for the
  Pallas ones: `conv3x3_cuda` (K3, `csrc/conv3x3.cu`), `gn_act_cuda` (K4,
  `csrc/gn_act.cu`) and `double_conv_cuda` (K5, two of each).

Each kernel wrapper counts its launches: `conv3x3_cuda.launches`,
`gn_act_cuda.launches`, `double_conv_cuda.launches` (K5's calls) and
`attention_core.launches` (K1's, on its dispatcher), each also while a
caller has the module's dispatcher patched over. A wrapper given a CUDA
tensor launches its kernel or raises; it never falls back to the plain
version.

Tensors are NHWC at these functions, as in the JAX package. Conv weights
are OIHW (`(Cout, Cin, 3, 3)`), the layout `F.conv2d` takes and the one the
K3 kernel reads.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

GN_EPS = 1e-6  # flax GroupNorm / LayerNorm default

# the JAX package's conv-path selector (pallas_ops.py:45-56)
CONV_PATH = os.environ.get("SPDM_CONV_PATH", "xla9")
if os.environ.get("SPDM_PALLAS_CONV", "0") == "1":
    CONV_PATH = "pallas"

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _typed_lib(name: str, argtypes: dict,
               restypes: Optional[dict] = None) -> ctypes.CDLL:
    """The built library `name` with each function's argtypes set (pointers
    and the stream as c_void_p) and its return type (an int CUDA error code
    unless `restypes` says otherwise)."""
    from ..kernels import build

    lib = build.library(name)
    if not getattr(lib, "_spdm_typed", False):
        for fn, types in argtypes.items():
            f = getattr(lib, fn)
            f.argtypes = types
            f.restype = (restypes or {}).get(fn, ctypes.c_int)
        lib._spdm_typed = True
    return lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, tensors, strided=()) -> None:
    """One CUDA device and one kernel dtype (float32 or bfloat16) for every
    tensor; all contiguous but those in `strided`."""
    ts = list(tensors) + list(strided)
    x = ts[0]
    if not (x.is_cuda and all(t.device == x.device for t in ts)):
        raise ValueError(f"{name}: tensors must be on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if x.dtype not in _KERNEL_DTYPES or any(t.dtype != x.dtype for t in ts):
        raise TypeError(f"{name}: tensors must share dtype float32 or "
                        f"bfloat16, got {[t.dtype for t in ts]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")


def _rc(name: str, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"at {what}")


# ---------------------------------------------------------------------------
# K3: 3x3 same-padding conv
# ---------------------------------------------------------------------------

def conv3x3_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: 3x3 same-padding conv, NHWC in and out, f32
    accumulation; w is OIHW.

    The permutes are views: an NHWC tensor seen as NCHW is channels-last,
    which cuDNN takes as it is."""
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


def _conv_lib() -> ctypes.CDLL:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    return _typed_lib("conv3x3", {
        f"conv3x3_{d}": [p, p, p, i32, i32, i32, i32, i32, p]
        for d in _KERNEL_DTYPES.values()})


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch K3 on x's device and current stream: x (B, H, W, Cin), w
    (Cout, Cin, 3, 3), one dtype (float32 or bfloat16), both contiguous.
    Raises on anything else and on a refused launch."""
    _check_cuda("conv3x3_cuda", (x, w))
    if (x.dim() != 4 or w.dim() != 4
            or tuple(w.shape[1:]) != (x.shape[3], 3, 3)):
        raise ValueError(f"conv3x3_cuda: x {tuple(x.shape)} (NHWC) and w "
                         f"{tuple(w.shape)} (OIHW) do not match")
    B, H, W, Cin = x.shape
    Cout = w.shape[0]
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(_conv_lib(), f"conv3x3_{_KERNEL_DTYPES[x.dtype]}")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), B, H, W, Cin, Cout,
            _stream(x))
    _rc("conv3x3", rc, f"x {tuple(x.shape)}, Cout {Cout}, {x.dtype}")
    conv3x3_cuda.launches += 1
    return out


conv3x3_cuda.launches = 0


def takes_conv_kernel(x: torch.Tensor, cin: int) -> bool:
    """The TPU dispatch's rule (pallas_ops.py:182,545) on a CUDA tensor."""
    B, H, W, _ = x.shape
    return (x.is_cuda and CONV_PATH == "pallas" and cin >= 8
            and B * H * W >= 1024)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 same-padding conv, NHWC; w is OIHW. K3 on the `pallas` conv path
    for CUDA tensors with Cin >= 8 and B*H*W >= 1024, else the plain
    version."""
    if takes_conv_kernel(x, x.shape[3]):
        return conv3x3_cuda(x, w)
    return conv3x3_ref(x, w)


# ---------------------------------------------------------------------------
# K4: GroupNorm(1) [+ GELU] [+ per-(batch, channel) affine] [+ residual GELU]
# ---------------------------------------------------------------------------

def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU in the form `pallas_ops._gelu_exact` writes it."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gn_f32(h32: torch.Tensor, gamma: torch.Tensor,
           beta: torch.Tensor) -> torch.Tensor:
    """GroupNorm(num_groups=1) on (B, HW, C) f32 with eps 1e-6 and the fast
    variance E[x^2] - m^2 clamped at 0 (`pallas_ops._gn_f32`)."""
    m = h32.mean(dim=(1, 2), keepdim=True)
    v = ((h32 * h32).mean(dim=(1, 2), keepdim=True) - m * m).clamp_min(0.0)
    return ((h32 - m) * torch.rsqrt(v + GN_EPS) * gamma.float()
            + beta.float())


def gn_act_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               ps: Optional[torch.Tensor] = None,
               pb: Optional[torch.Tensor] = None,
               x_res: Optional[torch.Tensor] = None,
               gelu: bool = False) -> torch.Tensor:
    """Plain version of K4 (`pallas_ops._gn_act_pallas`): GroupNorm(1) of
    NHWC x per batch element in f32, then GELU, then ps*y + pb with ps, pb
    (B, C), then GELU(y + x_res), each optional; written in x's dtype."""
    B, H, W, C = x.shape
    y = gn_f32(x.float().reshape(B, H * W, C), gamma, beta)
    if gelu:
        y = gelu_exact(y)
    if ps is not None:
        y = y * ps.float()[:, None, :] + pb.float()[:, None, :]
    if x_res is not None:
        y = gelu_exact(y + x_res.float().reshape(B, H * W, C))
    return y.to(x.dtype).reshape(B, H, W, C)


def _gn_lib() -> ctypes.CDLL:
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    return _typed_lib("gn_act", {
        f"gn_act_{d}": [p, p, p, p, i64, p, i64, p, p, i32, i32, i32, i32, p]
        for d in _KERNEL_DTYPES.values()})


def gn_act_cuda(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                ps: Optional[torch.Tensor] = None,
                pb: Optional[torch.Tensor] = None,
                x_res: Optional[torch.Tensor] = None,
                gelu: bool = False) -> torch.Tensor:
    """Launch K4 on x's device and current stream. x and x_res (B, H, W, C)
    and gamma, beta (C,) contiguous; ps and pb (B, C), both or neither, with
    unit channel stride (a row stride is taken as it is). One dtype, float32
    or bfloat16. Raises on anything else and on a refused launch."""
    if (ps is None) != (pb is None):
        raise ValueError("gn_act_cuda: ps and pb go together")
    post = [] if ps is None else [ps, pb]
    _check_cuda("gn_act_cuda",
                [x, gamma, beta] + ([] if x_res is None else [x_res]), post)
    if x.dim() != 4:
        raise ValueError(f"gn_act_cuda: x {tuple(x.shape)} is not NHWC")
    B, H, W, C = x.shape
    if (tuple(gamma.shape) != (C,) or tuple(beta.shape) != (C,)
            or any(tuple(t.shape) != (B, C) or t.stride(1) != 1
                   for t in post)
            or (x_res is not None and x_res.shape != x.shape)):
        raise ValueError(
            f"gn_act_cuda: shapes x {tuple(x.shape)}, gamma "
            f"{tuple(gamma.shape)}, beta {tuple(beta.shape)}, ps/pb "
            f"{[tuple(t.shape) for t in post]} (unit channel stride), x_res "
            f"{None if x_res is None else tuple(x_res.shape)}")
    out = torch.empty_like(x)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        rc = getattr(_gn_lib(), f"gn_act_{_KERNEL_DTYPES[x.dtype]}")(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
            ptr(ps), 0 if ps is None else ps.stride(0),
            ptr(pb), 0 if pb is None else pb.stride(0),
            ptr(x_res), out.data_ptr(), B, H * W, C, int(gelu), _stream(x))
    _rc("gn_act", rc, f"x {tuple(x.shape)}, {x.dtype}")
    gn_act_cuda.launches += 1
    return out


gn_act_cuda.launches = 0


# ---------------------------------------------------------------------------
# K5: DoubleConv = conv -> GN -> GELU -> conv -> GN -> affine [-> res GELU]
# ---------------------------------------------------------------------------

def double_conv_ref(x, w1, w2, g1, b1, g2, b2, ps, pb,
                    residual: bool = False):
    """Plain version of K5, `pallas_ops._double_conv_xla`: conv -> GN ->
    GELU -> conv -> GN -> ps*y+pb [-> GELU(y + x)], NHWC, rounded to x's
    dtype after each conv and each norm. ps/pb are (B, Cout)."""
    h = gn_act_ref(conv3x3_ref(x, w1), g1, b1, gelu=True)
    return gn_act_ref(conv3x3_ref(h, w2), g2, b2, ps, pb,
                      x if residual else None)


def double_conv_cuda(x, w1, w2, g1, b1, g2, b2, ps, pb,
                     residual: bool = False):
    """K5 as the TPU's `_dc_tpu` composes it: K3, K4 (GELU), K3, K4
    (affine[, residual]), four launches on x's stream; raises as the two
    wrappers do."""
    h = gn_act_cuda(conv3x3_cuda(x, w1), g1, b1, gelu=True)
    out = gn_act_cuda(conv3x3_cuda(h, w2), g2, b2, ps, pb,
                      x if residual else None)
    double_conv_cuda.launches += 1
    return out


double_conv_cuda.launches = 0


def double_conv(x, w1, w2, g1, b1, g2, b2, ps, pb, residual: bool = False):
    """The U-Net's conv block, NHWC; w1/w2 OIHW, ps/pb (B, Cout). K5 on the
    `pallas` conv path for CUDA tensors with min(Cin, Cmid) >= 8 and
    B*H*W >= 1024 (`pallas_ops.double_conv`), else the plain version."""
    if takes_conv_kernel(x, min(x.shape[3], w1.shape[0])):
        return double_conv_cuda(x, w1, w2, g1, b1, g2, b2, ps, pb, residual)
    return double_conv_ref(x, w1, w2, g1, b1, g2, b2, ps, pb, residual)


# ---------------------------------------------------------------------------
# multi-head attention core: softmax(q k^T / sqrt(Dh)) v
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sqrt_dh(Dh: int, dtype: torch.dtype) -> float:
    """sqrt(Dh) computed in f32 and rounded to the working dtype (exactly
    representable in that dtype, so dividing by it rounds once)."""
    return float(torch.sqrt(torch.tensor(float(Dh))).to(dtype))


def attention_core_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int = 1) -> torch.Tensor:
    """Plain version of the kernel, `pallas_ops._attn_xla`: q divided by
    sqrt(Dh) in q's dtype, f32 scores and softmax, probabilities rounded to
    v's dtype, f32 accumulation. (B, T, heads*Dh) in and out."""
    B, T, C = q.shape
    Dh = C // num_heads
    qh = q.reshape(B, T, num_heads, Dh) / _sqrt_dh(Dh, q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", qh.float(),
                     k.reshape(B, T, num_heads, Dh).float())
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                       v.reshape(B, T, num_heads, Dh).float())
    return out.to(q.dtype).reshape(B, T, C)


_SMEM_LIMIT = 48 * 1024   # what a block gets without an opt-in attribute


def _attention_lib() -> ctypes.CDLL:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    types = {f"attention_core_{d}": [p, p, p, p, i32, i32, i32, i32,
                                     ctypes.c_float, p]
             for d in _KERNEL_DTYPES.values()}
    types["attention_core_smem_bytes"] = [i32, i32]
    return _typed_lib("attention_core", types,
                      {"attention_core_smem_bytes": ctypes.c_size_t})


def attention_core_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """Launch the CUDA kernel on q's device and current stream; raises on
    any input it does not take and on a refused launch."""
    B, T, C = q.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("attention_core_cuda: q, k, v must be on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError("attention_core_cuda: q, k, v must share dtype "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.shape != q.shape or v.shape != q.shape or C % num_heads:
        raise ValueError(f"attention_core_cuda: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} with "
                         f"{num_heads} heads")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention_core_cuda: q, k, v must be contiguous")
    Dh = C // num_heads
    lib = _attention_lib()
    if T > 256 or lib.attention_core_smem_bytes(T, Dh) > _SMEM_LIMIT:
        raise ValueError(f"attention_core_cuda: T={T}, Dh={Dh} exceeds the "
                         "kernel's limits (T <= 256, 48 KB shared memory)")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, f"attention_core_{_KERNEL_DTYPES[q.dtype]}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, num_heads, Dh, _sqrt_dh(Dh, q.dtype), stream)
    if rc != 0:
        raise RuntimeError(f"attention_core kernel launch failed: CUDA error "
                           f"{rc} at B={B}, T={T}, C={C}, {q.dtype}")
    _DISPATCH.launches += 1
    return out


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int = 1) -> torch.Tensor:
    """Per-head softmax(q k^T / sqrt(Dh)) v over packed (B, T, heads*Dh)
    tensors (head h in feature columns [h*Dh, (h+1)*Dh)).

    CUDA tensors with T >= 16 and Dh >= 8 go to the CUDA kernel, which
    counts its launches in `attention_core.launches`; other shapes and CPU
    tensors take the plain version."""
    B, T, C = q.shape
    if q.is_cuda and T >= 16 and C // num_heads >= 8:
        return attention_core_cuda(q, k, v, num_heads)
    if q.is_cuda or q.device.type == "cpu":
        return attention_core_ref(q, k, v, num_heads)
    raise ValueError(f"attention_core: unsupported device {q.device}")


attention_core.launches = 0
# the counter's owner, also while a caller has the module's
# `attention_core` name patched over
_DISPATCH = attention_core
