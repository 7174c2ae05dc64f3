"""What one run of a cell does.

1. Finds the cell by name: its entry in `BENCHMARK.json`, its traffic's
   parameters in `workloads/<cell>.json`, its configuration's file, the
   readers of the metrics it reports in `metrics/<metric>.py`.
2. Refuses to run without a card (or with fewer than the cell asks for),
   and without the port beside the benchmark.
3. Sets the program's environment: its kernel caches inside the checkout
   at fixed paths, the configuration's conv path, no JAX through other
   libraries.
4. The cell's generator (`generators/<generator>.py`, named by the
   workload file) builds the program's objects from the seed and warms up
   every shape the traffic uses: that is set-up, `setup_s` from process
   start.
5. The window: `--seconds` of the traffic, timed on the host and by CUDA
   events at every call into the port. With `--trace 1` its first units
   run under `torch.profiler`.
6. The peak memory is read, the program's state freed, and the plain
   reference (`reference/`) recomputes what the window produced, on a
   sample drawn from the seed; each number compared is printed beside its
   limit (`workloads/<cell>.json`, "limits").
7. The metrics' readers turn the run's record into numbers, and one JSON
   line is printed last.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PORT = "state_policy_diffusionmodel_torch"
# top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "state_policy_diffusionmodel_tpu")
CACHE_DIR = os.path.join(ROOT, ".perfbench_cache")


class Refused(Exception):
    """The run cannot measure what the cell asks for; nothing is printed
    on standard output."""


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise Refused(f"no BENCHMARK.json in {root}")
    return load_json(path)


def find_cell(man: dict, name: str, root: str = ROOT):
    """(the cell's manifest entry, its workload file, its configuration)."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json "
                      f"(it has {sorted(cells)})")
    entry = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    conf = load_json(os.path.join(root, configs[entry["config"]]["file"]))
    traffic = load_json(workload_path(name, root))
    return entry, traffic, conf


def workload_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "perfbench", "workloads", f"{name}.json")


def metric_path(name: str, root: str = ROOT) -> str:
    return os.path.join(root, "perfbench", "metrics", f"{name}.py")


def applies(metric: dict, cell: str, end_to_end: List[str]) -> bool:
    """Whether a metric of the manifest is reported in `cell`, whose
    end-to-end metrics are `end_to_end` (None while those are decided)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return end_to_end is None or metric.get("moves") in end_to_end


def cell_metrics(man: dict, cell: str):
    """(end-to-end entries, per-layer entries) that `cell` reports."""
    e2e = [m for m in man["end_to_end"] if applies(m, cell, None)]
    names = [m["name"] for m in e2e]
    layer = [m for m in man["per_layer"] if applies(m, cell, names)]
    return e2e, layer


def load_module(path: str, prefix: str):
    """Import the file at `path` under a name of its own."""
    name = prefix + re.sub(r"[^A-Za-z0-9_]", "_",
                           os.path.splitext(os.path.basename(path))[0])
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: str = ROOT):
    path = metric_path(name, root)
    if not os.path.exists(path):
        raise Refused(f"metric {name!r} has no reader at {path}")
    return load_module(path, "perfbench_metric_")


def generator(traffic: dict):
    return importlib.import_module(
        f"perfbench.generators.{traffic['generator']}")


# ---------------------------------------------------------------------------
# the run's record, which the metrics' readers read
# ---------------------------------------------------------------------------

class Run:
    """Everything a run measured. Generators fill it; readers read it."""

    def __init__(self, cell: str, entry: dict, traffic: dict, config: dict,
                 seed: int, seconds: float, trace: bool, device):
        self.cell, self.entry = cell, entry
        self.traffic, self.config = traffic, config
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.setup_s: Optional[float] = None
        # the window: host seconds of whole units, the units and the work
        # a unit stands for (envs a frame, samples a step)
        self.window_s: Optional[float] = None
        self.units = 0
        self.unit_items = 1
        # CUDA-event times (ms) of each unit and of its parts, in order;
        # `traced_units` of them ran under the profiler (and one more
        # holds the profiler's stop)
        self.spans: Dict[str, List[float]] = {}
        self.marks: Dict[str, List[bool]] = {}
        self.traced_units = 0
        self.profile = None          # trace.Profile of the traced units
        self.precision: Dict[str, str] = {}
        self.peaks: Dict[str, float] = {}
        self.flops = None            # flops.Counts of one unit's work
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.info: Dict[str, object] = {}

    def untraced(self, name: str):
        """The spans `name` of the units the profiler did not touch."""
        skip = self.traced_units + 1 if self.traced_units else 0
        return self.spans.get(name, [])[skip:]

    def untraced_marks(self, name: str):
        skip = self.traced_units + 1 if self.traced_units else 0
        return self.marks.get(name, [])[skip:]


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi gave nothing (rc {out.returncode})"


def tf32_flags() -> Dict[str, bool]:
    import torch

    return {"cudnn.allow_tf32": bool(torch.backends.cudnn.allow_tf32),
            "cuda.matmul.allow_tf32":
                bool(torch.backends.cuda.matmul.allow_tf32)}


def precision_of_flags() -> Dict[str, str]:
    """The unit each kind of operation runs on, as the backend's flags
    leave it: cuDNN convolutions and cuBLAS matmuls in TF32 or fp32."""
    f = tf32_flags()
    return {"conv": "tf32" if f["cudnn.allow_tf32"] else "fp32",
            "matmul": "tf32" if f["cuda.matmul.allow_tf32"] else "fp32"}


def program_environment(config: dict) -> None:
    """Kernel caches at fixed paths inside the checkout; the conv path the
    configuration states; no JAX through other libraries."""
    os.environ["USE_FLAX"] = "0"
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR,
                                                      "torch_extensions")
    for key in [k for k in os.environ if k.startswith("SPDM_")]:
        del os.environ[key]
    os.environ.update({k: str(v) for k, v in
                       config.get("program_env", {}).items()})


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def parse_args(argv):
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return ap.parse_args(argv)


def main(argv, process_start: float, device: str = "cuda",
         variant: Optional[dict] = None) -> int:
    """Run the cell; print the result line; return the exit code.

    `device` and `variant` are for the benchmark's own tests: "cpu" skips
    the look for a card (the port's kernels take their plain versions on
    CPU tensors), and a variant changes the traffic's sizes ("sizes") or
    runs the program's lower-precision path ("control": true)."""
    args = parse_args(argv)
    try:
        result = run(args, process_start, device, variant or {})
    except Refused as e:
        print(f"perfbench: refused: {e}", file=sys.stderr, flush=True)
        return 2
    found = forbidden_loaded()
    if found:
        print(f"perfbench: loaded after the window: {', '.join(found)}",
              file=sys.stderr, flush=True)
        return 3
    checks = result["checks"]
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def run(args, process_start: float, device: str, variant: dict) -> dict:
    man = manifest()
    entry, traffic, config = find_cell(man, args.workload)
    traffic = dict(traffic, **variant.get("sizes", {}))
    e2e, layer = cell_metrics(man, args.workload)
    wanted = layer if args.trace else e2e
    readers = {m["name"]: reader(m["name"]) for m in wanted}
    program_environment(config)
    try:
        importlib.import_module(PORT)
    except ImportError as e:
        raise Refused(f"the program ({PORT}) does not import: {e}")
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < entry["chips"]:
            raise Refused(f"{entry['chips']} cards asked for, "
                          f"{torch.cuda.device_count()} present")
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    rec = Run(args.workload, entry, traffic, config, args.seed,
              args.seconds, bool(args.trace), dev)
    rec.precision = precision_of_flags()
    stated = config.get("precision", {})
    if stated and {k: stated[k] for k in rec.precision} != rec.precision:
        raise Refused(f"the backend runs {rec.precision}, the configuration "
                      f"states {stated}")
    gen = generator(traffic).Generator(
        rec, control=bool(variant.get("control")))
    gen.setup()
    # what set-up left behind is not traversed by collections in the
    # window
    gc.collect()
    gc.freeze()
    rec.setup_s = time.monotonic() - process_start
    gen.window()
    gc.unfreeze()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    gen.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks = gen.check()
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())

    if rec.trace:
        from . import flops as F

        rec.peaks = load_json(os.path.join(HERE, "peaks.json")).get(
            device_kind(dev), {})
        rec.flops = F.unit_counts(config, traffic)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out_dev = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": device_kind(dev), "count": 1,
               "memory_peak_bytes": rec.memory_peak_bytes}
    if rec.trace and rec.profile is not None:
        out_dev["busy_s"] = rec.profile.busy_s
        out_dev["window_s"] = rec.profile.window_s
    print(f"card: {card_line() if dev.type == 'cuda' else 'none (cpu)'}")
    print(f"tf32 flags: {json.dumps(tf32_flags())}")
    print(f"samples: {json.dumps(rec.info)}")
    print(f"window: {rec.units} units of {rec.unit_items} in "
          f"{rec.window_s!r} s; setup {rec.setup_s!r} s")
    result = {"correct": bool(correct), "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics, "device": out_dev}
    if rec.trace and rec.profile is not None:
        result["breakdown"] = rec.profile.breakdown()
    result["checks"] = checks
    return result


def device_kind(dev) -> str:
    import torch

    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
