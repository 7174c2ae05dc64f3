"""A/B timings of K4 (gn_act) and K2 (sample_banked) design choices on one
card, inside one process (a kernel's time moves up to ~8% between the
card's machines, so versions are compared only within a run).

    python -m state_policy_diffusionmodel_torch.kernels.ab [--out FILE]

K4, at the 10 shapes of one r5blend U-Net forward (B=256) in fp32 and
bf16, in the two variants the forward calls (`gelu` after the first conv
of a block, `post`, the FiLM affine, after the second): the plan
`gn_act_plan` takes, and that plan with one choice changed at a time: the
most values a thread before more threads (`values_first`); half and twice
the values a thread a pass;
16-byte packs where the plan takes 8-byte ones (`wide_packs`, bf16's
smallest slice); one-value packs (no wide loads, channels computed per
value). Then
`csrc/gn_act.cu` built again with one design choice changed (SOURCE_AB):
`pack_sums`, a thread adding each pack's values and squares in f32 before
adding the pack sums in double (not every value in double); `f32_sums`,
all of a thread's sums in f32; `pdl`, launched behind the kernel before it by programmatic
dependent launch (waiting before its first read, letting the next kernel
launch at its end). Each build gives one forward's 30 calls summed, alone
(K4 after K4) and behind the K3 conv that feeds each call on the path,
the builds in the order A, B, B, A; and its largest error against the
plain version, and of its GroupNorm against one computed in float64 on a
slice whose mean is 16 of its standard deviations (where the fast
variance cancels). K2, at B=1024 and 256 envs on the 16-track bank's roads
at headings 0, 45 and 90 degrees: the kernel on the grid
`sample_banked_plan` sizes to the card, and on one CTA a strip of every
env (no loop over envs). Each timing is the mean of two CUDA-graph
replays taken in the order A, B, ..., B, A. Prints one line a case and,
last, one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import build
from ..models import cuda_ops
from ..render import cuda_sampler, raster
from ..track import load_or_build_bank

B_ENVS = 256
# (H, W, C) of the 10 distinct K4 shapes of one forward, and how many of its
# 30 calls take each
GN_CALLS = {(16, 4, 64): 4, (16, 4, 128): 2, (8, 2, 128): 4, (8, 2, 256): 2,
            (4, 1, 256): 6, (4, 1, 512): 4, (8, 2, 512): 2, (16, 4, 256): 2,
            (32, 8, 128): 2, (32, 8, 64): 2}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}

_SUMS = """#pragma unroll
      for (int j = 0; j < E; ++j) {
        const double v = f[j];
        sd += v;
        qd = fma(v, v, qd);
      }
"""
_LAUNCH = """  gn_act_kernel<T, PACK, NV><<<(unsigned)grid, threads, 0, s>>>(a);
  return cudaSuccess;
"""
_FIRST_READ = "  double sd = 0.0, qd = 0.0;   // this thread's sums\n"
_KERNEL_END = """  }
}

template <typename T, int PACK, int NV>
cudaError_t launch_nv("""
# gn_act.cu's lines as built, and what replaces them, by design choice
SOURCE_AB = {
    "pack_sums": [(_SUMS, """      float sp = 0.f, qp = 0.f;   // the pack's sums
#pragma unroll
      for (int j = 0; j < E; ++j) {
        sp = __fadd_rn(sp, f[j]);
        qp = __fmaf_rn(f[j], f[j], qp);
      }
      sd += (double)sp;
      qd += (double)qp;
""")],
    "f32_sums": [(_FIRST_READ, "  float sd = 0.f, qd = 0.f;\n"),
                 (_SUMS, """#pragma unroll
      for (int j = 0; j < E; ++j) {
        sd = __fadd_rn(sd, f[j]);
        qd = __fmaf_rn(f[j], f[j], qd);
      }
""")],
    "pdl": [(_LAUNCH, """  return conv_tile::launch_after(
      gn_act_kernel<T, PACK, NV>, dim3((unsigned)grid), threads, 0, s, a);
"""),
            (_FIRST_READ, "  conv_tile::griddep_wait();\n" + _FIRST_READ),
            (_KERNEL_END, _KERNEL_END.replace(
                "  }\n}\n",
                "  }\n  conv_tile::griddep_launch_dependents();\n}\n", 1))],
}


def graph_ms(fn, iters: int = 100) -> float:
    """Mean device ms of fn(): `iters` calls captured in one CUDA graph,
    replayed between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(fns: dict) -> dict:
    """Each named fn's graph time, taken in the order a, b, ..., b, a and
    averaged over its two readings."""
    names = list(fns)
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(graph_ms(fns[n]))
    return {n: sum(v) / 2 for n, v in ms.items()}


def gn_variants(plan: cuda_ops.GnPlan, B, HW, C, dtype) -> dict:
    """The default plan with one choice changed at a time (left out where
    the change gives the default plan)."""
    f = lambda pack, nv: cuda_ops._gn_act_plan_for(B, HW, C, pack, nv)
    wide = 16 // dtype.itemsize
    out = {"default": plan,
           "values_first": f(plan.pack, min(8, cuda_ops._GN_VALUES
                                            // plan.pack)),
           "half_values": f(plan.pack, max(1, plan.nv // 2)),
           "double_values": f(plan.pack, min(8, plan.nv * 2)),
           "wide_packs": f(wide, max(1, plan.nv * plan.pack // wide)),
           "one_value_packs": f(1, 8)}
    return {k: v for k, v in out.items() if k == "default" or v != plan}


def gn_cases(device) -> list[dict]:
    """K4's inputs at each shape, type and variant of the forward, with the
    conv weight (C -> C) that feeds the call on the path."""
    gen = torch.Generator(device=device).manual_seed(8765)
    r = lambda *s: torch.randn(s, generator=gen, device=device)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for H, W, C in GN_CALLS:
            x, g, b = ((2 * r(B_ENVS, H, W, C) + 0.5).to(dtype),
                       (1 + 0.3 * r(C)).to(dtype), (0.2 * r(C)).to(dtype))
            ps, pb = (1 + 0.2 * r(B_ENVS, C)).to(dtype), \
                (0.3 * r(B_ENVS, C)).to(dtype)
            w = (r(C, C, 3, 3) * (2.0 / (9 * C)) ** 0.5).to(dtype)
            for variant, a in (("gelu", (x, g, b, None, None, None, True)),
                               ("post", (x, g, b, ps, pb))):
                cases.append(dict(dtype=dtype, H=H, W=W, C=C, variant=variant,
                                  args=a, w=w, out=torch.empty_like(x)))
    return cases


def ab_gn_plans(cases) -> list[dict]:
    rows = []
    for case in cases:
        dtype, H, W, C = (case[k] for k in ("dtype", "H", "W", "C"))
        a, out = case["args"], case["out"]
        plan = cuda_ops.gn_act_plan(B_ENVS, H * W, C, dtype)
        plans = gn_variants(plan, B_ENVS, H * W, C, dtype)
        fns = {}
        want = cuda_ops.gn_act_ref(*a).float()
        for name, p in plans.items():
            cuda_ops._gn_act_launch(out, p, *a)
            err = ((out.float() - want).abs().max()
                   / want.abs().max()).item()
            assert err <= TOL[dtype], (name, p, err)
            fns[name] = lambda p=p: cuda_ops._gn_act_launch(out, p, *a)
        ms = in_turns(fns)
        row = dict(kernel="K4", dtype=str(dtype)[6:], H=H, W=W, C=C,
                   variant=case["variant"], ms=ms,
                   plans={k: dataclasses.asdict(p) for k, p in plans.items()})
        rows.append(row)
        print(f"K4 {row['dtype']:8s} {H}x{W}x{C} {row['variant']:4s}: "
              + "  ".join(f"{k} {v:.4f}" for k, v in ms.items()),
              flush=True)
    for dtype in ("float32", "bfloat16"):
        mine = [r for r in rows if r["dtype"] == dtype]
        names = dict.fromkeys(n for r in mine for n in r["ms"])
        sums = {n: sum(GN_CALLS[r["H"], r["W"], r["C"]] // 2
                       * r["ms"].get(n, r["ms"]["default"]) for r in mine)
                for n in names}
        print(f"K4 {dtype} one forward (30 calls: 15 gelu, 15 post; where a "
              "choice does not apply, the default's): " + "  ".join(
                  f"{k} {v:.4f}" for k, v in sums.items()), flush=True)
    return rows


def _use_csrc(csrc: Path) -> None:
    build.CSRC_DIR = csrc
    build._built.pop("gn_act", None)
    build._libs.pop("gn_act", None)


def gn_build_sums(cases, device) -> dict:
    """The current gn_act build at the default plans: one forward's 30
    calls summed by type, alone and each behind its K3 conv; the largest
    error against the plain version; the largest error of GroupNorm against
    float64 on a slice whose mean is 16 of its standard deviations."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        alone = after_k3 = err = 0.0
        for case in (c for c in cases if c["dtype"] == dtype):
            a, w, o = case["args"], case["w"], case["out"]
            plan = cuda_ops.gn_act_plan(B_ENVS, case["H"] * case["W"],
                                        case["C"], dtype)
            n = GN_CALLS[case["H"], case["W"], case["C"]] // 2
            alone += n * graph_ms(
                lambda: cuda_ops._gn_act_launch(o, plan, *a))
            after_k3 += n * graph_ms(lambda: cuda_ops._gn_act_launch(
                o, plan, cuda_ops.conv3x3_cuda(a[0], w), *a[1:]))
            cuda_ops._gn_act_launch(o, plan, *a)
            want = cuda_ops.gn_act_ref(*a).float()
            err = max(err, ((o.float() - want).abs().max()
                            / want.abs().max()).item())
        gen = torch.Generator(device=device).manual_seed(3)
        x = (16 + torch.randn((4, 32, 8, 128), generator=gen,
                              device=device)).to(dtype)
        g, b = torch.ones(128, device=device, dtype=dtype), \
            torch.zeros(128, device=device, dtype=dtype)
        xd = x.double().reshape(4, -1)
        m = xd.mean(dim=1, keepdim=True)
        exact = (xd - m) / torch.sqrt(((xd - m) ** 2).mean(
            dim=1, keepdim=True) + cuda_ops.GN_EPS)
        got = cuda_ops.gn_act_cuda(x, g, b).double().reshape(4, -1)
        out[str(dtype)[6:]] = dict(
            alone_ms=alone, after_k3_ms=after_k3, max_rel_err=err,
            cancel_err=(got - exact).abs().max().item())
    return out


def ab_gn_sources(cases, device) -> dict:
    """Each SOURCE_AB change against the build as it is, A B B A."""
    orig = build.CSRC_DIR
    rows = {}
    for name, edits in SOURCE_AB.items():
        alt = Path(tempfile.mkdtemp())
        for f in orig.iterdir():
            if f.is_file():
                shutil.copy(f, alt / f.name)
        text = (alt / "gn_act.cu").read_text()
        for line, new in edits:
            if text.count(line) != 1:
                raise RuntimeError(f"{name}: {line!r} not once in gn_act.cu")
            text = text.replace(line, new)
        (alt / "gn_act.cu").write_text(text)
        turns = []
        try:
            for label, csrc in (("as built", orig), (name, alt), (name, alt),
                                ("as built", orig)):
                _use_csrc(csrc)
                turns.append((label, gn_build_sums(cases, device)))
                print(f"K4 build {label}: {json.dumps(turns[-1][1])}",
                      flush=True)
        finally:
            _use_csrc(orig)
            shutil.rmtree(alt, ignore_errors=True)
        rows[name] = turns
        for dtype in ("float32", "bfloat16"):
            mean = {lab: {k: sum(t[1][dtype][k] for t in turns if t[0] == lab)
                          / 2 for k in ("alone_ms", "after_k3_ms")}
                    for lab in ("as built", name)}
            print(f"K4 {dtype} one forward, as built against {name} (mean of "
                  f"two): alone {mean['as built']['alone_ms']:.4f} / "
                  f"{mean[name]['alone_ms']:.4f} ms, behind K3 "
                  f"{mean['as built']['after_k3_ms']:.4f} / "
                  f"{mean[name]['after_k3_ms']:.4f} ms", flush=True)
    return rows


def heading_poses(bank, B, degrees, seed):
    """B envs on the bank's roads (track b % U), camera at `degrees`."""
    gen = torch.Generator().manual_seed(seed)
    U = bank.seg_b.shape[0]
    ids = torch.arange(B) % U
    pick = torch.randint(0, 200, (B,), generator=gen)
    pos = bank.seg_b.cpu()[ids, pick]
    ang = torch.full((B,), math.radians(degrees))
    dev = bank.tex.device
    return (ids.to(torch.int32).to(dev), torch.cos(ang).to(dev),
            torch.sin(ang).to(dev), pos.contiguous().to(dev))


def ab_k2(device) -> list[dict]:
    bank = load_or_build_bank(16, bake=True, device=device)
    _, _, rx, ry = raster.pixel_planes(device)
    names = ("tex_bank", "track_ids", "cos_a", "sin_a", "pos", "rx", "ry")
    n_sm = cuda_ops._n_sm(device)
    rows = []
    for B in (1024, 256):
        for deg in (0, 45, 90):
            args = dict(zip(names, (bank.tex, *heading_poses(bank, B, deg, B),
                                    rx, ry)))
            want = cuda_sampler.sample_banked_ref(*args.values())
            # the grid sized to the card, and one CTA a strip of every env
            groups = {"default": cuda_sampler.sample_banked_plan(B, n_sm),
                      "one_env_a_cta": B}
            fns = {}
            for name, g in groups.items():
                got = cuda_sampler._sample_banked_launch(args, g)
                assert torch.equal(got, want), (name, B, deg)
                fns[name] = (lambda g=g: cuda_sampler._sample_banked_launch(
                    args, g))
            ms = in_turns(fns)
            rows.append(dict(kernel="K2", B=B, degrees=deg, ms=ms))
            print(f"K2 B={B} heading {deg:2d}: " + "  ".join(
                f"{k} {v:.4f}" for k, v in ms.items()), flush=True)
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    cases = gn_cases(device)
    result = dict(card=smi, k4=ab_gn_plans(cases),
                  k4_sources=ab_gn_sources(cases, device), k2=ab_k2(device))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
