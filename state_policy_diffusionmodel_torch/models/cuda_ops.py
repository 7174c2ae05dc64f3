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

- Training takes the JAX package's backward selector too, read once at
  import into `CONV_BWD`: `SPDM_CONV_BWD=pallas` keeps the plain conv
  forward and computes the conv weight gradient with the hand-written K6
  (`conv_dw_cuda`, `csrc/conv_dw.cu`; plain version `conv_dw_ref`) for
  CUDA tensors with min(Cin, Cout) >= 8 and B*H*W >= 1024 (`select_conv`
  -> `conv3x3_t`, the counterparts of `_select_conv` and `_conv3x3_t`).
- K3 and K6 launch per-shape plans computed here (`conv3x3_plan`,
  `conv_dw_plan`: tile, split-K parts or pixel chunks), passed to the C
  launchers as integers; each launcher picks its shared-memory ring itself
  (`conv3x3_ring`, `conv_dw_ring` report the depth).

Gradients. A kernel writes into a fresh tensor through ctypes, so its
result has no autograd history. Every kernel on a differentiable path runs
inside a `torch.autograd.Function` whose backward copies the JAX package's
VJP in plain PyTorch: `AttentionCore` (`_attn_bwd`, on both devices, as
JAX's `attention_core` is a custom VJP on the CPU too), `Conv3x3Kernel`
(`_conv3x3_bwd`), `Conv3x3T` (`_conv3x3_t_bwd`, whose weight gradient is
K6) and `DoubleConvKernel` (`_dc_bwd`: the plain DoubleConv recomputed and
differentiated). Each takes its forward (or, for `Conv3x3T`, its weight
gradient) as an argument: the kernel for CUDA tensors, the plain version
on the CPU, so the CPU tests run the very backward the card runs. The raw
`*_cuda` wrappers raise when grad mode is on and an input requires grad: a
kernel reached outside its Function fails loudly instead of cutting the
gradient.

Each kernel wrapper counts its launches: `conv3x3_cuda.launches`,
`gn_act_cuda.launches`, `double_conv_cuda.launches` (K5's calls),
`conv_dw_cuda.launches` (K6's) and `attention_core.launches` (K1's, on its
dispatcher), each also while a caller has the module's dispatcher patched
over. A wrapper given a CUDA tensor launches its kernel or raises; it never
falls back to the plain version.

Tensors are NHWC at these functions, as in the JAX package. Conv weights
are OIHW (`(Cout, Cin, 3, 3)`), the layout `F.conv2d` takes and the one the
K3 kernel reads.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
# the training-backward selector (pallas_ops.py:57-62): "pallas" = K6
CONV_BWD = os.environ.get("SPDM_CONV_BWD", "")

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


def _refuse_grad(name: str, tensors) -> None:
    """Raise where a raw kernel would cut the gradient: grad mode on and an
    input that requires grad. The differentiable paths reach the kernels
    inside their autograd Functions, where grad mode is off."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad; the kernel's result would "
            "carry no gradient. Call the differentiable dispatcher, or run "
            "under torch.no_grad()")


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


def _n_sm(device: torch.device) -> int:
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """K3's launch plan for one shape (`csrc/conv3x3.cu`).

    The output is tiled as `m_tiles` blocks of `bm` pixels by `n_tiles` of
    `bn` channels; K = taps x Cin is walked in `slices` channel slices of
    `ck` channels, each with all `taps` taps; `splits` parts of `per_split`
    slices each run as separate blocks that write f32 partial sums
    (`ws_elems`), added in order by a second pass. The weights are
    repacked into `wt_elems` elements ([tap][cin_pad][cout_pad], bf16 on
    the tensor cores, f32 otherwise)."""
    mma: bool
    bm: int
    bn: int
    ck: int
    taps: int
    slices: int
    splits: int
    per_split: int
    m_tiles: int
    n_tiles: int
    cin_pad: int
    cout_pad: int
    wt_elems: int
    ws_elems: int

    @property
    def blocks(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits


def takes_conv_mma(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """K3's tensor-core rule: bf16, whole 16-channel K slices, 8-channel
    fragments (every r5blend shape). Other shapes take the CUDA cores."""
    return dtype == torch.bfloat16 and cin % 16 == 0 and cout % 8 == 0


# The split rule, from tools/sweep_conv_plans.py on an H100: a split-K part
# keeps at least 4 slices (2 where W == 1) on the tensor cores and 4 on the
# CUDA cores, and the grid grows by splitting while it stays within the
# blocks an SM runs at once: two of the tensor cores' 128 x 64 tile, one of
# the 256-pixel tiles (136-205 KB of ring), and on the CUDA cores one and a
# half (a second partial sum costs more than a second block gains there).
_CONV_MIN_SLICES = {(True, 9): 4, (True, 3): 2, (False, 9): 4, (False, 3): 4}
# The tensor cores' tile: 256 pixels where there are 4,096 or more (one
# block an SM, 64-pixel warp tiles), else 128 (the 4x1 level: more blocks);
# 128 channels for a conv this large (M*Cin*Cout, 19 GFLOP at 9 taps):
# 64 x 64 warp tiles, a third more math per shared load.
_CONV_WIDE_M = 4096
_CONV_BIG = 1 << 30


@functools.lru_cache(maxsize=None)
def conv3x3_plan(B: int, H: int, W: int, cin: int, cout: int,
                 dtype: torch.dtype, n_sm: int = 132,
                 aligned: bool = True) -> ConvPlan:
    """K3's plan for x (B, H, W, cin) -> (B, H, W, cout) in `dtype` on a card
    of `n_sm` SMs. Tensor cores where `takes_conv_mma` (and x is 16-byte
    aligned): 256 x 64 tiles (128 x 64 at 1,024 pixels), 256 x 128 for the
    largest convs. CUDA cores otherwise: 256 x 64 tiles. Where the tiles
    leave SMs idle, the slices split into a power of two of parts (see
    `_CONV_MIN_SLICES`). Cached: the wrapper asks for a plan on every
    call."""
    M = B * H * W
    mma = aligned and takes_conv_mma(dtype, cin, cout)
    taps = 3 if W == 1 else 9
    if mma:
        big = cout >= 128 and M * cin * cout >= _CONV_BIG
        bm = 256 if M >= _CONV_WIDE_M else 128
        bn = 128 if big and bm == 256 else 64
        room = n_sm if bm == 256 else 2 * n_sm
    else:
        bm, bn = 256, 64
        room = 3 * n_sm // 2
    tiles = -(-M // bm) * -(-cout // bn)
    most = max(1, -(-cin // _conv_ck(mma, taps))
               // _CONV_MIN_SLICES[(mma, taps)])
    splits = 1
    while 2 * splits <= most and tiles * 2 * splits <= room:
        splits *= 2
    return _conv3x3_plan_for(B, H, W, cin, cout, mma, bm, bn, splits)


def _conv_ck(mma: bool, taps: int) -> int:
    """Input channels a K slice: 16 x 9 taps or 32 x 3 taps on the tensor
    cores, 4 on the CUDA cores."""
    return (16 if taps == 9 else 32) if mma else 4


def _conv3x3_plan_for(B: int, H: int, W: int, cin: int, cout: int,
                      mma: bool, bm: int, bn: int, splits: int) -> ConvPlan:
    """The plan of a given route, tile and split (at most one part a slice;
    parts of equal slices). Where W == 1 only the three dj = 1 taps are
    computed. `conv3x3_plan` makes its choices through this;
    tools/sweep_conv_plans.py times other choices."""
    M = B * H * W
    taps = 3 if W == 1 else 9
    ck = _conv_ck(mma, taps)
    m_tiles, n_tiles = -(-M // bm), -(-cout // bn)
    slices = -(-cin // ck)
    per_split = -(-slices // min(splits, slices))
    splits = -(-slices // per_split)
    cin_pad, cout_pad = slices * ck, n_tiles * bn
    return ConvPlan(mma=mma, bm=bm, bn=bn, ck=ck, taps=taps, slices=slices,
                    splits=splits, per_split=per_split, m_tiles=m_tiles,
                    n_tiles=n_tiles, cin_pad=cin_pad, cout_pad=cout_pad,
                    wt_elems=9 * cin_pad * cout_pad,
                    ws_elems=splits * M * cout if splits > 1 else 0)


def _conv_lib() -> ctypes.CDLL:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    types = {f"conv3x3_{d}": [p, p, p, p, p] + [i32] * 11 + [p]
             for d in _KERNEL_DTYPES.values()}
    types["conv3x3_ring"] = [i32] * 5
    return _typed_lib("conv3x3", types)


def conv3x3_ring(plan: ConvPlan, W: int) -> int:
    """The shared-memory ring depth K3's launcher takes for `plan` at image
    width W (0: it refuses the launch); on the card's build."""
    return _conv_lib().conv3x3_ring(int(plan.mma), W, plan.bm, plan.bn,
                                    plan.taps)


def conv3x3_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch K3 on x's device and current stream: x (B, H, W, Cin), w
    (Cout, Cin, 3, 3), one dtype (float32 or bfloat16), both contiguous.
    The plan is `conv3x3_plan`'s; the repacked weights and the split-K
    partial sums go to workspaces allocated here. Raises on anything else,
    on a refused launch and, with grad mode on, on an input that requires
    grad."""
    _refuse_grad("conv3x3_cuda", (x, w))
    _check_cuda("conv3x3_cuda", (x, w))
    if (x.dim() != 4 or w.dim() != 4
            or tuple(w.shape[1:]) != (x.shape[3], 3, 3)):
        raise ValueError(f"conv3x3_cuda: x {tuple(x.shape)} (NHWC) and w "
                         f"{tuple(w.shape)} (OIHW) do not match")
    B, H, W, Cin = x.shape
    plan = conv3x3_plan(B, H, W, Cin, w.shape[0], x.dtype, _n_sm(x.device),
                        aligned=x.data_ptr() % 16 == 0)
    out = _conv3x3_launch(x, w, plan)
    conv3x3_cuda.launches += 1
    return out


def _conv3x3_launch(x: torch.Tensor, w: torch.Tensor,
                    plan: ConvPlan) -> torch.Tensor:
    """K3 under `plan`, on inputs `conv3x3_cuda` has checked."""
    B, H, W, Cin = x.shape
    Cout = w.shape[0]
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    wt = torch.empty(plan.wt_elems, device=x.device,
                     dtype=x.dtype if plan.mma else torch.float32)
    ws = (torch.empty(plan.ws_elems, dtype=torch.float32, device=x.device)
          if plan.ws_elems else None)
    with torch.cuda.device(x.device):
        rc = getattr(_conv_lib(), f"conv3x3_{_KERNEL_DTYPES[x.dtype]}")(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), wt.data_ptr(),
            None if ws is None else ws.data_ptr(), B, H, W, Cin, Cout,
            int(plan.mma), plan.bm, plan.bn, plan.taps, plan.splits,
            plan.per_split, _stream(x))
    _rc("conv3x3", rc, f"x {tuple(x.shape)}, Cout {Cout}, {x.dtype}, {plan}")
    return out


conv3x3_cuda.launches = 0


def takes_conv_kernel(x: torch.Tensor, cin: int) -> bool:
    """The TPU dispatch's rule (pallas_ops.py:182,545) on a CUDA tensor."""
    B, H, W, _ = x.shape
    return (x.is_cuda and CONV_PATH == "pallas" and cin >= 8
            and B * H * W >= 1024)


def flip_kernel(w: torch.Tensor) -> torch.Tensor:
    """The kernel of dx: w_flip[ci, co, i, j] = w[co, ci, 2-i, 2-j], OIHW
    (`_conv3x3_bwd`'s flipped, transposed w9)."""
    return w.flip((2, 3)).transpose(0, 1).contiguous()


class Conv3x3Kernel(torch.autograd.Function):
    """`_conv3x3_p`: forward `fwd(x, w)` (K3 for CUDA tensors), backward
    `_conv3x3_bwd`: dx = conv3x3(g, w_flip) through the dispatcher (K3
    again on the conv-kernel path), dw = conv_dw_ref in f32, each cast to
    its input's dtype."""

    @staticmethod
    def forward(ctx, fwd, x, w):
        ctx.save_for_backward(x, w)
        return fwd(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dx = conv3x3(g, flip_kernel(w)).to(x.dtype)
        if ctx.needs_input_grad[2]:
            dw = conv_dw_ref(x, g).to(w.dtype)
        return None, dx, dw


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3x3 same-padding conv, NHWC; w is OIHW. K3 (in `Conv3x3Kernel`) on
    the `pallas` conv path for CUDA tensors with Cin >= 8 and
    B*H*W >= 1024, else `select_conv` (`pallas_ops.conv3x3`)."""
    if takes_conv_kernel(x, x.shape[3]):
        return Conv3x3Kernel.apply(conv3x3_cuda, x, w)
    return select_conv(x, w)


# ---------------------------------------------------------------------------
# K6: conv weight gradient, dw[co, ci, i, j] = sum xpad[b, h+i, w+j, ci]
#     * g[b, h, w, co]
# ---------------------------------------------------------------------------

def conv_dw_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of K6 (`_conv_dw_pallas`): the 3x3 conv's weight
    gradient at NHWC activation x and cotangent g, as nine f32 products of
    the shifted zero-padded x with g (`_conv3x3_bwd`'s dots), OIHW
    (Cout, Cin, 3, 3) in f32."""
    B, H, W, Cin = x.shape
    Cout = g.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    g2 = g.float().reshape(-1, Cout).t()
    taps = [g2 @ xp[:, i:i + H, j:j + W, :].reshape(-1, Cin)
            for i in range(3) for j in range(3)]
    return torch.stack(taps, dim=-1).reshape(Cout, Cin, 3, 3)


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """K6's launch plan for one shape (`csrc/conv_dw.cu`): blocks of 64
    output channels x 32 input channels x the taps (9, or 3 where W == 1 on
    the tensor cores), one per chunk of `chunk_pixels` pixels (a whole
    number of `step`-pixel K steps, the last chunk possibly short); the
    chunks' f32 partial sums take `ws_elems` ([chunk][Cout][9][Cin]) and a
    second pass adds them in chunk order."""
    mma: bool
    taps: int
    step: int
    chunks: int
    chunk_pixels: int
    tiles: int
    ws_elems: int

    @property
    def blocks(self) -> int:
        return self.tiles * self.chunks


_DW_TILE_CI, _DW_TILE_CO = 32, 64
# pixels a K step, by route, and the fewest steps a chunk keeps
_DW_STEP = {True: 64, False: 32}
_DW_MIN_STEPS = 4
_DW_MMA_MAX_PIXELS = 4096


def takes_dw_mma(dtype: torch.dtype, cin: int, cout: int) -> bool:
    """K6's tensor-core rule: bf16 with 8-channel rows of x and g (every
    r5blend shape). Other shapes take the CUDA cores."""
    return dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0


@functools.lru_cache(maxsize=None)
def conv_dw_plan(B: int, H: int, W: int, cin: int, cout: int,
                 dtype: torch.dtype, n_sm: int = 132,
                 aligned: bool = True) -> DwPlan:
    """K6's plan: the B*H*W pixels split into chunks so that the grid of
    (Cin/32) x (Cout/64) channel tiles x chunks holds about two blocks per
    SM, each chunk a whole number of K steps (64 pixels on the tensor
    cores, 32 on the CUDA cores) and at least four of them, at most 4,096
    pixels on the tensor cores. The count rounds down: a grid just past one
    wave of two blocks per SM leaves a thin second wave that costs up to
    half again. Cached, as `conv3x3_plan`."""
    P = B * H * W
    mma = aligned and takes_dw_mma(dtype, cin, cout)
    tiles = -(-cin // _DW_TILE_CI) * -(-cout // _DW_TILE_CO)
    steps = -(-P // _DW_STEP[mma])
    chunks = max(1, min(2 * n_sm // tiles, steps // _DW_MIN_STEPS))
    if mma:
        # the tensor cores' f32 sums lose bits over a long K: 3.6e-5 of the
        # largest |dw| at 32,768 pixels a chunk, 2e-6 at 2,048 (H100)
        chunks = max(chunks, -(-P // _DW_MMA_MAX_PIXELS))
    return _conv_dw_plan_for(B, H, W, cin, cout, mma, chunks)


def _conv_dw_plan_for(B: int, H: int, W: int, cin: int, cout: int,
                      mma: bool, chunks: int) -> DwPlan:
    """The plan of a given route and chunk count (at most one chunk a K
    step; chunks of equal steps, the last possibly short). `conv_dw_plan`
    makes its choice through this; tools/sweep_conv_plans.py times other
    counts."""
    P = B * H * W
    step = _DW_STEP[mma]
    steps = -(-P // step)
    per = -(-steps // max(1, min(chunks, steps))) * step
    chunks = -(-P // per)
    return DwPlan(mma=mma, taps=3 if mma and W == 1 else 9, step=step,
                  chunks=chunks, chunk_pixels=per,
                  tiles=-(-cin // _DW_TILE_CI) * -(-cout // _DW_TILE_CO),
                  ws_elems=chunks * cout * 9 * cin)


def _dw_lib() -> ctypes.CDLL:
    p, i32 = ctypes.c_void_p, ctypes.c_int
    types = {f"conv_dw_{d}": [p, p, p, p] + [i32] * 9 + [p]
             for d in _KERNEL_DTYPES.values()}
    types["conv_dw_ring"] = [i32] * 3
    return _typed_lib("conv_dw", types)


def conv_dw_ring(plan: DwPlan, H: int, W: int) -> int:
    """The shared-memory ring depth K6's launcher takes for `plan` on an
    H x W image (0: it refuses the launch); on the card's build."""
    return _dw_lib().conv_dw_ring(int(plan.mma), H, W)


def conv_dw_cuda(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Launch K6 on x's device and current stream: x (B, H, W, Cin) and g
    (B, H, W, Cout), one dtype (float32 or bfloat16), both contiguous;
    returns dw (Cout, Cin, 3, 3) in float32. The plan is `conv_dw_plan`'s;
    the chunks' partial sums go to a workspace allocated here. Raises on
    anything else, on a refused launch and, with grad mode on, on an input
    that requires grad."""
    _refuse_grad("conv_dw_cuda", (x, g))
    _check_cuda("conv_dw_cuda", (x, g))
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError(f"conv_dw_cuda: x {tuple(x.shape)} and g "
                         f"{tuple(g.shape)} are not NHWC of one B, H, W")
    B, H, W, Cin = x.shape
    plan = conv_dw_plan(B, H, W, Cin, g.shape[3], x.dtype, _n_sm(x.device),
                        aligned=x.data_ptr() % 16 == 0
                        and g.data_ptr() % 16 == 0)
    out = _conv_dw_launch(x, g, plan)
    conv_dw_cuda.launches += 1
    return out


def _conv_dw_launch(x: torch.Tensor, g: torch.Tensor,
                    plan: DwPlan) -> torch.Tensor:
    """K6 under `plan`, on inputs `conv_dw_cuda` has checked."""
    B, H, W, Cin = x.shape
    Cout = g.shape[3]
    out = torch.empty((Cout, Cin, 3, 3), dtype=torch.float32,
                      device=x.device)
    ws = torch.empty(plan.ws_elems, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = getattr(_dw_lib(), f"conv_dw_{_KERNEL_DTYPES[x.dtype]}")(
            x.data_ptr(), g.data_ptr(), out.data_ptr(), ws.data_ptr(),
            B, H, W, Cin, Cout, int(plan.mma), plan.taps, plan.chunks,
            plan.chunk_pixels, _stream(x))
    _rc("conv_dw", rc, f"x {tuple(x.shape)}, Cout {Cout}, {x.dtype}, {plan}")
    return out


conv_dw_cuda.launches = 0


class Conv3x3T(torch.autograd.Function):
    """`_conv3x3_t`: the plain conv forward; backward dx = the plain conv
    of g with w_flip, dw = `dw_fn(x, g)` (K6 for CUDA tensors) in f32, each
    cast to its input's dtype (`_conv3x3_t_bwd`)."""

    @staticmethod
    def forward(ctx, dw_fn, x, w):
        ctx.dw_fn = dw_fn
        ctx.save_for_backward(x, w)
        return conv3x3_ref(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dx = conv3x3_ref(g, flip_kernel(w)).to(x.dtype)
        if ctx.needs_input_grad[2]:
            dw = ctx.dw_fn(x.contiguous(), g).to(w.dtype)
        return None, dx, dw


def conv3x3_t(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The training conv of `SPDM_CONV_BWD=pallas` on CUDA tensors: plain
    forward, K6 weight gradient."""
    return Conv3x3T.apply(conv_dw_cuda, x, w)


def takes_dw_kernel(x: torch.Tensor, cin: int, cout: int) -> bool:
    """`_select_conv`'s rule for K6 on a CUDA tensor."""
    B, H, W, _ = x.shape
    return (x.is_cuda and CONV_BWD == "pallas" and min(cin, cout) >= 8
            and B * H * W >= 1024)


def select_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable conv (`_select_conv`): `conv3x3_t` (K6 weight
    gradient) under `SPDM_CONV_BWD=pallas` on its shape rule, else the
    plain conv (PyTorch autograd)."""
    if takes_dw_kernel(x, x.shape[3], w.shape[0]):
        return conv3x3_t(x, w)
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
    or bfloat16. Raises on anything else, on a refused launch and, with
    grad mode on, on an input that requires grad."""
    _refuse_grad("gn_act_cuda", (x, gamma, beta, ps, pb, x_res))
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
    dtype after each conv and each norm. ps/pb are (B, Cout). The convs go
    through `select_conv`, as `_double_conv_xla`'s do, so K6 computes their
    weight gradients under `SPDM_CONV_BWD=pallas`."""
    h = gn_act_ref(select_conv(x, w1), g1, b1, gelu=True)
    return gn_act_ref(select_conv(h, w2), g2, b2, ps, pb,
                      x if residual else None)


def double_conv_cuda(x, w1, w2, g1, b1, g2, b2, ps, pb,
                     residual: bool = False):
    """K5 as the TPU's `_dc_tpu` composes it: K3, K4 (GELU), K3, K4
    (affine[, residual]), four launches on x's stream; raises as the two
    wrappers do, before any launch."""
    _refuse_grad("double_conv_cuda", (x, w1, w2, g1, b1, g2, b2, ps, pb))
    h = gn_act_cuda(conv3x3_cuda(x, w1), g1, b1, gelu=True)
    out = gn_act_cuda(conv3x3_cuda(h, w2), g2, b2, ps, pb,
                      x if residual else None)
    double_conv_cuda.launches += 1
    return out


double_conv_cuda.launches = 0


class DoubleConvKernel(torch.autograd.Function):
    """`_dc_p`: forward `fwd(...)` (K5 for CUDA tensors); backward `_dc_bwd`,
    the plain composition `double_conv_ref` recomputed under grad and
    differentiated, so its convs take `select_conv` (K6 on
    `SPDM_CONV_BWD=pallas`)."""

    @staticmethod
    def forward(ctx, fwd, residual, x, w1, w2, g1, b1, g2, b2, ps, pb):
        ctx.residual = residual
        ctx.save_for_backward(x, w1, w2, g1, b1, g2, b2, ps, pb)
        return fwd(x, w1, w2, g1, b1, g2, b2, ps, pb, residual)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[2:]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                out = double_conv_ref(*inputs, ctx.residual)
            grads = iter(torch.autograd.grad(out, wanted, g))
        return (None, None, *(next(grads) if n else None for n in need))


def double_conv(x, w1, w2, g1, b1, g2, b2, ps, pb, residual: bool = False):
    """The U-Net's conv block, NHWC; w1/w2 OIHW, ps/pb (B, Cout). K5 (in
    `DoubleConvKernel`) on the `pallas` conv path for CUDA tensors with
    min(Cin, Cmid) >= 8 and B*H*W >= 1024 (`pallas_ops.double_conv`), else
    the plain version."""
    if takes_conv_kernel(x, min(x.shape[3], w1.shape[0])):
        return DoubleConvKernel.apply(double_conv_cuda, residual, x, w1, w2,
                                      g1, b1, g2, b2, ps, pb)
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
    any input it does not take, on a refused launch and, with grad mode
    on, on an input that requires grad."""
    _refuse_grad("attention_core_cuda", (q, k, v))
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


def attention_core_bwd(q, k, v, g, num_heads: int):
    """`_attn_bwd` in plain PyTorch: P recomputed in f32 from q*scale and k,
    then dv, dp, ds = P (dp - sum(dp P)), dq and dk, each cast to its
    input's dtype."""
    B, T, C = q.shape
    Dh = C // num_heads
    f32 = lambda t: t.reshape(B, T, num_heads, Dh).float()
    scale = float(1.0 / torch.sqrt(torch.tensor(float(Dh))))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", f32(q) * scale,
                                   f32(k)), dim=-1)
    gf = f32(g)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, f32(v))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, f32(k)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, f32(q)) * scale
    pack = lambda t, like: t.reshape(B, T, C).to(like.dtype)
    return pack(dq, q), pack(dk, k), pack(dv, v)


class AttentionCore(torch.autograd.Function):
    """JAX's `attention_core` custom VJP: forward `fwd(q, k, v, heads)` (K1
    for CUDA tensors on its shape rule), backward `attention_core_bwd`."""

    @staticmethod
    def forward(ctx, fwd, num_heads, q, k, v):
        ctx.num_heads = num_heads
        ctx.save_for_backward(q, k, v)
        return fwd(q, k, v, num_heads)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (None, None,
                *attention_core_bwd(q, k, v, g.contiguous(), ctx.num_heads))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   num_heads: int = 1) -> torch.Tensor:
    """Per-head softmax(q k^T / sqrt(Dh)) v over packed (B, T, heads*Dh)
    tensors (head h in feature columns [h*Dh, (h+1)*Dh)), differentiable
    through `AttentionCore`.

    CUDA tensors with T >= 16 and Dh >= 8 go to the CUDA kernel, which
    counts its launches in `attention_core.launches`; other shapes and CPU
    tensors take the plain version."""
    B, T, C = q.shape
    if q.is_cuda and T >= 16 and C // num_heads >= 8:
        fwd = attention_core_cuda
    elif q.is_cuda or q.device.type == "cpu":
        fwd = attention_core_ref
    else:
        raise ValueError(f"attention_core: unsupported device {q.device}")
    return AttentionCore.apply(fwd, num_heads, q, k, v)


attention_core.launches = 0
# the counter's owner, also while a caller has the module's
# `attention_core` name patched over
_DISPATCH = attention_core
