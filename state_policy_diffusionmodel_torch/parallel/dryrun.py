"""A multi-rank dry run of every data-parallel path at tiny shapes.

    python -m state_policy_diffusionmodel_torch.parallel.dryrun [N] [cpu|cuda]

The counterpart of the JAX package's `__graft_entry__.dryrun_multichip`:
in N spawned ranks (`parallel.launch`; gloo on the CPU) it runs one
data-parallel train step, the `device_data` path through `Trainer.fit`
over a few steps, `rollout_constant_sharded` with render off and
`rollout_policy_sharded` with render on, at that function's shapes (a
2-per-rank batch, noise_steps 10, horizons 3 + 5, step_size 1). Each rank
checks that what it computed is finite and returns a summary; ranks that
disagree on a reduced value fail the run.
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

from .launch import launch

CFG = dict(noise_steps=10, obs_horizon=3, pred_horizon=5, inpaint_horizon=1,
           model="UNet", vision_encoder="autoencoder", step_size=1,
           model_width=8)


def _dryrun_rank(mesh, n: int) -> dict:
    from .. import diffusion, track as T
    from ..data.dataset import DataModule, WindowDataset
    from ..envs import vector
    from ..train import loop
    from .mesh import gather_rows

    dev = mesh.device
    cfg = diffusion.PolicyConfig(**CFG)
    policy = diffusion.DiffusionPolicy(cfg, dev)
    params = policy.init_params(torch.Generator().manual_seed(0))
    B, L = 2 * n, cfg.obs_horizon + cfg.pred_horizon
    out = {}

    # one data-parallel step: the rank's rows, t and noise drawn at the
    # global shape, gradients averaged over the ranks
    tcfg = loop.TrainConfig(batch_size=B, lr=1e-4)
    opt = loop.make_optimizer(tcfg, params)
    step = loop.make_train_step(policy, params, opt, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(1)
    t, noise = policy.draw_t_noise(B, gen)
    rows = slice(mesh.rank * 2, mesh.rank * 2 + 2)
    batch = {"image": torch.zeros((2, L, 96, 96, 3), device=dev),
             "position": torch.zeros((2, L, 2), device=dev),
             "velocity": torch.zeros((2, L, 2), device=dev),
             "action": torch.zeros((2, L, 3), device=dev)}
    loss = step(batch, 1e-4, t=t[rows], noise=noise[rows])
    out["step_loss"] = float(gather_rows(loss.reshape(1), mesh).mean())

    # device_data through Trainer.fit: the dataset on every rank's device,
    # batches of B windows split over the ranks
    rng = np.random.default_rng(0)
    T_ = 40
    ds = WindowDataset(({
        "img": rng.random((T_, 96, 96, 3)).astype(np.float32),
        "position": rng.normal(size=(T_, 2)).astype(np.float32),
        "velocity": rng.normal(size=(T_, 2)).astype(np.float32),
        "action": rng.normal(size=(T_, 3)).astype(np.float32)},
        np.asarray([T_])), cfg.obs_horizon, cfg.pred_horizon, step_size=1)
    dm = DataModule(batch_size=B, T_obs=cfg.obs_horizon,
                    T_pred=cfg.pred_horizon, seed=0, step_size=1)
    dm.data_full, dm.stats = ds, ds.stats
    dm.train_idx = np.arange(len(ds))[:2 * B]
    dm.val_idx = np.arange(len(ds))[2 * B:3 * B]
    with tempfile.TemporaryDirectory() as td:
        res = loop.Trainer(
            policy, loop.TrainConfig(epochs=1, batch_size=B, lr=1e-4,
                                     device_data=True, early_stop=False),
            td, mesh=mesh).fit(dm, params=policy.init_params(
                torch.Generator().manual_seed(2)))
    out["fit_train_loss"] = res["history"]["train_loss"][-1]

    # the sharded env: a constant rollout with render off, then the ring
    # policy's closed loop with render on
    bank = T.stack([T.build(T.make_track(s), bake=False, device=dev)
                    for s in (1, 2)])
    tids = torch.arange(B, dtype=torch.int32) % 2
    states = vector.init_batch(bank, tids, device=dev)
    acts = torch.tensor([0.0, 0.6, 0.0], device=dev).repeat(B, 1)
    _, roll = vector.rollout_constant_sharded(mesh, states, bank, acts, 3,
                                              render=False, track_ids=tids)
    out["constant_rewards"] = roll.rewards.cpu()
    fn = diffusion.make_ring_policy(policy, num_inference_steps=2,
                                    sampler="ddim")
    carry = diffusion.init_ring_carry(policy, B)
    _, _, pacts, prews = vector.rollout_policy_sharded(
        mesh, params, bank, diffusion.env_policy_fn(fn), carry, 2,
        render=True, track_ids=tids)
    out["policy_actions"], out["policy_rewards"] = pacts.cpu(), prews.cpu()
    for k, v in out.items():
        if not bool(torch.isfinite(torch.as_tensor(v)).all()):
            raise FloatingPointError(f"rank {mesh.rank}: {k} not finite")
    if tuple(pacts.shape) != (2, B, 3) or tuple(roll.rewards.shape) != (3, B):
        raise ValueError(f"rank {mesh.rank}: policy actions "
                         f"{tuple(pacts.shape)}, rewards "
                         f"{tuple(roll.rewards.shape)}")
    return out


def dryrun_multichip(n: int, device="cpu", timeout: float = 300.0) -> list:
    """Run every data-parallel path in n ranks on `device` ("cpu", or
    "cuda" for a rank a card); returns each rank's summary. Raises if a
    rank fails, or if the ranks disagree on what they gathered or
    reduced."""
    outs = launch(_dryrun_rank, n, device, args=(n,), timeout=timeout)
    for r, o in enumerate(outs[1:], 1):
        for k in o:
            if not torch.equal(torch.as_tensor(o[k]),
                               torch.as_tensor(outs[0][k])):
                raise AssertionError(f"rank {r} disagrees with rank 0 on {k}")
    return outs


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    dev = sys.argv[2] if len(sys.argv) > 2 else "cpu"
    summary = dryrun_multichip(n, dev)[0]
    print(f"dryrun_multichip({n}, {dev!r}) ok: step loss "
          f"{summary['step_loss']:.6f}, fit train loss "
          f"{summary['fit_train_loss']:.6f}")
