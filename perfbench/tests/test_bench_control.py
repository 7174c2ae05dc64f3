"""On the card, at each cell's own sizes: the control (the program's own
lower-precision path, amp: bf16 in place of the configuration's fp32 and
TF32) and, for the training cells, half of the batch left out, each on
three seeds, have to come out not correct. Each run's numbers are printed
(`READING` lines, `pytest -s`): they are the upper readings the limits
are set below.

    python -m pytest perfbench/tests/test_bench_control.py -o addopts="" -s
"""

import json
import time

import pytest

from perfbench import harness
from state_policy_diffusionmodel_torch.diffusion import policy as P

SEEDS = (1618033988, 2236067977, 3141592653)
# a window long enough for the drive cell's checked frames (the first 60)
SECONDS = {"r5blend.drive": "12", "r4rn.train": "4"}


def run(capsys, cell, seed, control):
    rc = harness.main(["--workload", cell, "--seed", str(seed),
                       "--seconds", SECONDS[cell], "--trace", "0"],
                      time.monotonic(), "cuda", {"control": control})
    lines = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(lines[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["r5blend.drive", "r4rn.train"])
def test_control_is_not_correct(capsys, cell, seed):
    res = run(capsys, cell, seed, True)
    with capsys.disabled():
        print("READING", cell, "control", seed, json.dumps(res["checks"]))
    assert not res["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["r4rn.train"])
def test_half_batch_is_not_correct(capsys, monkeypatch, cell, seed):
    real = P.DiffusionPolicy.loss

    def loss(self, params, batch, generator=None, t=None, noise=None):
        h = next(iter(batch.values())).shape[0] // 2
        return real(self, params, {k: v[:h] for k, v in batch.items()},
                    generator, t=t[:h], noise=noise[:h])

    monkeypatch.setattr(P.DiffusionPolicy, "loss", loss)
    res = run(capsys, cell, seed, False)
    with capsys.disabled():
        print("READING", cell, "half_batch", seed, json.dumps(res["checks"]))
    assert not res["correct"]
