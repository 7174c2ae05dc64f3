"""What the harness and the reference load, each in a fresh process."""

import json
import os
import subprocess
import sys

from perfbench import harness

FORBIDDEN = ["jax", "jaxlib", "flax", "state_policy_diffusionmodel_tpu"]
PROBE = """
import glob, json, os, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(imports: str):
    code = PROBE.format(root=harness.ROOT, imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = loaded(
        "from perfbench import harness, trace, readers, flops\n"
        "from perfbench.generators import drive, train\n"
        "import state_policy_diffusionmodel_torch.train\n"
        "import state_policy_diffusionmodel_torch.envs.vector\n"
        "import state_policy_diffusionmodel_torch.diffusion\n"
        "import state_policy_diffusionmodel_torch.data.dataset\n"
        "for p in glob.glob(os.path.join({r!r}, 'perfbench/metrics/*.py')):\n"
        "    harness.load_module(p, 'm_')\n"
        "trace.roofline_ops()\n".replace("{r!r}", repr(harness.ROOT)))
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "state_policy_diffusionmodel_torch" in top


def test_reference_loads_nothing_of_the_port():
    top = loaded(
        "import perfbench.reference.envs.car_racing\n"
        "import perfbench.reference.diffusion\n"
        "import perfbench.reference.checkpoints\n"
        "import perfbench.reference.train\n"
        "import perfbench.reference.data\n"
        "import perfbench.reference.track\n")
    assert not top & set(FORBIDDEN + ["state_policy_diffusionmodel_torch"])


def test_reference_sources_name_nothing_of_the_port():
    base = os.path.join(harness.ROOT, "perfbench", "reference")
    for dirpath, _, files in os.walk(base):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    for line in f:
                        s = line.strip()
                        if s.startswith(("import ", "from ")):
                            assert "state_policy" not in s, (name, s)
                            top = s.split()[1].split(".")[0]
                            assert top not in FORBIDDEN, (name, s)
