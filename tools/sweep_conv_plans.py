"""Time the port's conv kernels under alternative launch plans, on a GPU.

    python3 tools/sweep_conv_plans.py [--what k3 k6] [--ab pdl mask_table]
                                      [--out FILE]

K3 (`cuda_ops.conv3x3_cuda`): at each of the 17 distinct conv shapes of one
r5blend U-Net forward (B=256), fp32 and bf16, every tile the kernels take
(tensor cores: 128 x 64, 256 x 64 and 256 x 128; CUDA cores: 256 x 64)
with 1, 2, 4, 8 and 16 split-K parts. K6
(`cuda_ops.conv_dw_cuda`): at the 17 shapes of a training step, every
chunk count from 1 to 192 that gives a distinct plan. Plans are made by
the module's `_conv3x3_plan_for` / `_conv_dw_plan_for` and launched
through `_conv3x3_launch` / `_conv_dw_launch`, the wrappers' own launch
(the wrappers' counts do not move). Each plan's result is held against the
plain version at chip_smoke.py's limits (fp32 1e-5, bf16 2^-7 of the
largest output; K6 prints each error beside its time) before it is timed
as a CUDA-graph replay (chip_smoke.graph_ms).
One line a shape: each plan as tile/splits (blocks) or chunks (blocks) and
its microseconds, the fastest, and the plan `conv3x3_plan` /
`conv_dw_plan` picks. --ab builds the conv sources a second time with one
design choice undone (pdl: K3's kernels launched without programmatic
dependent launch; mask_table: K6's tensor-core kernel computing each tap
mask instead of reading its table) and times the per-forward (K3) and
per-step (K6) sums at the default plans, both builds alternately (A B B A),
in one process. The card's name and power limit come first; --out writes
every timing as JSON. TF32 is off.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke as cs  # noqa: E402
from state_policy_diffusionmodel_torch.kernels import build  # noqa: E402
from state_policy_diffusionmodel_torch.models import cuda_ops  # noqa: E402

TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# --ab: the source, the line as built, and the line that undoes the choice
AB = {"pdl": ("conv_tile.cuh", "cfg.numAttrs = 1;", "cfg.numAttrs = 0;"),
      "mask_table": ("conv_dw.cu", "constexpr int kMaskTable = 4096;",
                     "constexpr int kMaskTable = 0;")}


def rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def sweep_k3(dev, gen):
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        tiles = ((128, 64), (256, 64), (256, 128)) \
            if dtype == torch.bfloat16 else ((256, 64),)
        for H, W, cin, cout in dict.fromkeys(cs.conv_calls()):
            x = torch.randn((256, H, W, cin), generator=gen,
                            device=dev).to(dtype)
            w = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
                 * (2 / (9 * cin)) ** .5).to(dtype)
            want = cuda_ops.conv3x3_ref(x, w)
            mma = cuda_ops.takes_conv_mma(dtype, cin, cout)
            line = []
            for bm, bn in tiles:
                for sp in (1, 2, 4, 8, 16):
                    p = cuda_ops._conv3x3_plan_for(256, H, W, cin, cout, mma,
                                                   bm, bn, sp)
                    if p.splits != sp:
                        continue
                    err = rel(cuda_ops._conv3x3_launch(x, w, p), want)
                    if not err <= TOL[dtype]:
                        raise RuntimeError(f"{bm}x{bn}/{sp}: error {err}")
                    ms = cs.graph_ms(
                        lambda: cuda_ops._conv3x3_launch(x, w, p), 20)
                    line.append(dict(bm=bm, bn=bn, splits=sp,
                                     blocks=p.blocks, us=ms * 1e3))
            best = min(line, key=lambda r: r["us"])
            pick = cuda_ops.conv3x3_plan(256, H, W, cin, cout, dtype, 132)
            print(f"K3 {str(dtype)[6:]:8s} {H}x{W} {cin}->{cout}: " + "  ".join(
                f"{r['bm']}x{r['bn']}/{r['splits']}({r['blocks']}) "
                f"{r['us']:.1f}" for r in line)
                + f"  | fastest {best['bm']}x{best['bn']}/{best['splits']} "
                f"{best['us']:.1f} us; picked {pick.bm}x{pick.bn}/"
                f"{pick.splits}", flush=True)
            rows.append(dict(dtype=str(dtype), shape=(H, W, cin, cout),
                             plans=line, picked=(pick.bm, pick.bn,
                                                 pick.splits)))
    return rows


def sweep_k6(dev, gen, chunk_counts=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48,
                                     64, 96, 128, 192),
             dtypes=(torch.float32, torch.bfloat16)):
    rows = []
    for dtype in dtypes:
        for H, W, cin, cout in dict.fromkeys(cs.TRAIN_CONVS):
            x = torch.randn((256, H, W, cin), generator=gen,
                            device=dev).to(dtype)
            g = torch.randn((256, H, W, cout), generator=gen,
                            device=dev).to(dtype)
            want = cuda_ops.conv_dw_ref(x, g)
            mma = cuda_ops.takes_dw_mma(dtype, cin, cout)
            line, seen = [], set()
            for ch in chunk_counts:
                p = cuda_ops._conv_dw_plan_for(256, H, W, cin, cout, mma, ch)
                if p.chunks in seen:
                    continue
                seen.add(p.chunks)
                err = rel(cuda_ops._conv_dw_launch(x, g, p), want)
                if not err <= cs.K6_TOL[dtype]:
                    raise RuntimeError(f"{p.chunks} chunks: {err}")
                ms = cs.graph_ms(lambda: cuda_ops._conv_dw_launch(x, g, p),
                                 10)
                line.append(dict(chunks=p.chunks, blocks=p.blocks,
                                 us=ms * 1e3, err=err))
            best = min(line, key=lambda r: r["us"])
            pick = cuda_ops.conv_dw_plan(256, H, W, cin, cout, dtype, 132)
            print(f"K6 {str(dtype)[6:]:8s} {H}x{W} {cin}->{cout}: " + "  ".join(
                f"{r['chunks']}({r['blocks']}) {r['us']:.1f} "
                f"[{r['err']:.1e}]" for r in line) + f"  | fastest "
                f"{best['chunks']} {best['us']:.1f} us; picked "
                f"{pick.chunks}", flush=True)
            rows.append(dict(dtype=str(dtype), shape=(H, W, cin, cout),
                             plans=line, picked=pick.chunks))
    return rows


def sums(dev, gen):
    """Per-forward K3 and per-step K6 sums at the default plans, graph-timed
    milliseconds, by type."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        k3 = k6 = 0.0
        for H, W, cin, cout in dict.fromkeys(cs.TRAIN_CONVS):
            x = torch.randn((256, H, W, cin), generator=gen,
                            device=dev).to(dtype)
            w = torch.randn((cout, cin, 3, 3), generator=gen,
                            device=dev).to(dtype)
            g = torch.randn((256, H, W, cout), generator=gen,
                            device=dev).to(dtype)
            shape = (H, W, cin, cout)
            k3 += cs.conv_calls().count(shape) * cs.graph_ms(
                lambda: cuda_ops.conv3x3_cuda(x, w), 20)
            k6 += cs.TRAIN_CONVS.count(shape) * cs.graph_ms(
                lambda: cuda_ops.conv_dw_cuda(x, g), 10)
        out[str(dtype)[6:]] = dict(k3_ms=k3, k6_ms=k6)
    return out


def ab(name, dev, gen):
    """The default build against one with design choice `name` undone,
    timed A B B A."""
    src, line, undone = AB[name]
    orig = build.CSRC_DIR
    alt = Path(tempfile.mkdtemp())
    for f in orig.iterdir():
        shutil.copy(f, alt / f.name)
    text = (alt / src).read_text()
    if line not in text:
        raise RuntimeError(f"--ab {name}: {line!r} not in {src}")
    (alt / src).write_text(text.replace(line, undone))

    def use(csrc):
        build.CSRC_DIR = csrc
        for lib in ("conv3x3", "conv_dw"):
            build._built.pop(lib, None)
            build._libs.pop(lib, None)

    rows = []
    try:
        for label, csrc in (("as built", orig), (f"{name} undone", alt),
                            (f"{name} undone", alt), ("as built", orig)):
            use(csrc)
            rows.append((label, sums(dev, gen)))
            print(f"ab {name}: {label}: {json.dumps(rows[-1][1])}",
                  flush=True)
    finally:
        use(orig)
        shutil.rmtree(alt, ignore_errors=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--what", nargs="*", choices=["k3", "k6"],
                    default=["k3", "k6"])
    ap.add_argument("--ab", nargs="*", choices=sorted(AB), default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_conv_plans: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.nvidia_smi_line(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    if "k3" in args.what:
        out["k3"] = sweep_k3(dev, gen)
    if "k6" in args.what:
        out["k6"] = sweep_k6(dev, gen)
    for name in args.ab:
        out[f"ab_{name}"] = ab(name, dev, gen)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
