"""The port's bench flags that follow the JAX bench, on CPU: --smoke,
--epoch, random-init weights without --run_dir, --interp-actions,
--profile-dir and the SPDM_BENCH_DEADLINE watchdog.

--interp-actions is compared with the JAX bench's formula (bench.py's
closed loop: frac = ((k - warmup) % step_size) / step_size, action =
(1 - frac) * queue[0] + frac * queue[1], in float32) applied to the port's
own action queue: exactly equal.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from state_policy_diffusionmodel_torch import bench
from state_policy_diffusionmodel_torch import diffusion as td
from state_policy_diffusionmodel_torch.params_from_jax import params_to_jax

from test_torch_cli_sample import write_episodes, write_run
from test_torch_policy import torch_threads

REPO = pathlib.Path(__file__).resolve().parents[1]

_torch_threads = torch_threads(2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    saved = write_run(root / "run", write_episodes(root / "ds.zarr"),
                      epochs=(3, 5), ema=False)
    return root, saved


def _same(a, b):
    la, lb = params_to_jax(a), params_to_jax(b)
    return la.keys() == lb.keys() and all(np.array_equal(la[k], lb[k])
                                          for k in la)


def test_epoch_picks_that_checkpoint(tiny):
    root, saved = tiny
    dev = torch.device("cpu")
    _, newest, stats = bench.load_policy(str(root / "run"), False, False, dev)
    _, third, _ = bench.load_policy(str(root / "run"), False, False, dev,
                                    epoch=3)
    assert _same(newest, saved[5]) and _same(third, saved[3])
    assert not _same(third, saved[5]) and stats is not None
    with pytest.raises(FileNotFoundError, match="epoch 4"):
        bench.load_policy(str(root / "run"), False, False, dev, epoch=4)


def test_random_init_is_deterministic_for_a_seed():
    """Without --run_dir: init_params from a generator seeded 0, the same
    weights on every call, and the JAX bench's configuration."""
    dev = torch.device("cpu")
    pol, a, stats = bench.load_policy(None, False, False, dev)
    _, b, _ = bench.load_policy(None, False, False, dev)
    assert stats is None and _same(a, b)
    cfg = pol.config
    assert (cfg.model, cfg.vision_encoder, cfg.obs_horizon, cfg.pred_horizon,
            cfg.step_size, cfg.model_width) == ("UNet_Film", "autoencoder",
                                                10, 30, 5, None)
    policy = td.DiffusionPolicy(cfg, dev)
    assert _same(a, policy.init_params(torch.Generator().manual_seed(0)))
    assert not _same(a, policy.init_params(torch.Generator().manual_seed(1)))


@pytest.mark.parametrize("warmup", [0, 4])
def test_interp_actions_equal_jax_interpolation(tiny, warmup):
    root, _ = tiny
    policy, params, stats = bench.load_policy(str(root / "run"), False, True,
                                              torch.device("cpu"))
    cfg = policy.config
    B, n = 3, 12
    rng = np.random.default_rng(warmup)
    fn = td.make_ring_policy(policy, stats, num_inference_steps=2,
                             warmup=warmup, interp_actions=True)
    carry = td.init_ring_carry(policy, B)
    for k in range(n):
        obs = torch.from_numpy(rng.integers(0, 256, (B, 96, 96, 3),
                                            dtype=np.uint8))
        pos = torch.from_numpy(rng.normal(size=(B, 2)).astype(np.float32))
        vel = torch.from_numpy(rng.normal(size=(B, 2)).astype(np.float32))
        a, carry = fn(params, carry, obs, pos, vel)
        if k < warmup:
            assert torch.equal(a, torch.tensor([0.0, 0.3, 0.0]).expand(B, 3))
            continue
        q = jnp.asarray(carry["queue"].numpy())
        frac = jnp.asarray((k - warmup) % cfg.step_size,
                           jnp.float32) / cfg.step_size
        want = (1.0 - frac) * q[:, 0] + frac * q[:, 1]
        np.testing.assert_array_equal(a.numpy(), np.asarray(want))


def test_smoke_and_profile_dir_on_cpu(tmp_path):
    out = bench.main(["--mode", "env_render", "--smoke", "--device", "cpu",
                      "--profile-dir", str(tmp_path / "p")])
    assert out["metric"] == "env_render_steps_per_sec_per_chip"
    assert "at 8 envs" in out["unit"] and len(out["seconds"]) == 1
    assert out["value"] > 0 and "partial" not in out
    traces = list((tmp_path / "p").glob("trace_*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]


def test_deadline_prints_what_has_finished(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), SPDM_BENCH_DEADLINE="1")
    res = subprocess.run(
        [sys.executable, "-m", "state_policy_diffusionmodel_torch.bench",
         "--mode", "env_only", "--envs", "8", "--steps", "40",
         "--repeats", "400", "--unique-tracks", "2", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lines = [json.loads(line) for line in res.stdout.splitlines()
             if line.startswith("{")]
    assert len(lines) == 1
    assert lines[0]["partial"] == "deadline 1s" and lines[0]["value"] > 0
