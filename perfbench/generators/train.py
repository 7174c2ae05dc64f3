"""Training: the train step of a configuration's recipe on episodes made
from the seed.

Traffic parameters (`workloads/<cell>.json`): `episodes` x `frames` (the
collection's shapes; frames uint8 uniform on the card, positions a random
walk, velocities normal, actions uniform in the recipe's ranges, all from
one `torch.Generator` on the card), `batch` (B), `batch_pool` (the
batches drawn before the window from the seed: whole permutations of the
windows, so every step's rows differ within an epoch), `checked_steps`
(the first steps, which the reference follows), `warmup_steps` (set-up's
steps in all, the checked ones first), `trace_steps` and `limits`. The
recipe (lr, clip, EMA decay, schedule, amp) is the configuration's.

The program's path: `train.load_run` (the configuration's EMA weights as
the starting point), `data.WindowDataset` over the episodes in a
`DataModule`, a `Trainer` with `device_data` whose `_batch` (the trainer's
own batch path: `DeviceWindowDataset.batch`, t and the noise from the
trainer's generator) feeds `make_train_step`'s step with the
configuration's optimizer and EMA. Set-up runs the first steps of the
object the window goes on driving. A unit is one optimizer step and its
batch; the rate is B x steps over the host time of whole steps.

The check follows the checked steps in the reference (`reference/
train.py`) from the same weights, windows and (t, noise): each step's
loss (`loss_gap`), the gradient of the first step as Adam took it,
worked out from its first moment (`grad_gap`), and the change of the
parameters (`change_gap`) and of the EMA (`ema_gap`) after the checked
steps, each by the worst leaf: the gap of the program's norm from the
reference's over the larger of the reference's norm of that leaf and of
the median leaf. Leaves with a reference gradient under a thousandth of
the median leaf's move under Adam by round-off alone and are left out of
the changes; leaves with no gradient at all (a frozen encoder) stay in the
parameters' change, which has to be none, and are left out of the EMA's,
which is round-off alone.
"""

from __future__ import annotations

import copy
import os
import time

import numpy as np
import torch

from ..harness import CACHE_DIR, ROOT
from ..trace import Tracer
from . import Clock, config_matches

B1 = 0.9  # Adam's first-moment decay (optax's default, the recipe's)


def make_episodes(seed: int, traffic: dict, device):
    """({img, position, velocity, action} numpy, episode ends), made on
    `device` from the seed."""
    E, F = int(traffic["episodes"]), int(traffic["frames"])
    n = E * F
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.randint(0, 256, (n, 96, 96, 3), dtype=torch.uint8,
                        generator=gen, device=device)
    walk = torch.randn((E, F, 2), generator=gen, device=device)
    start = torch.rand((E, 1, 2), generator=gen, device=device) * 200 - 100
    pos = (start + torch.cumsum(walk, dim=1)).reshape(n, 2)
    vel = torch.randn((n, 2), generator=gen, device=device) * 20
    lo = torch.tensor(traffic["action_low"], device=device)
    hi = torch.tensor(traffic["action_high"], device=device)
    act = lo + (hi - lo) * torch.rand((n, 3), generator=gen, device=device)
    data = {"img": img.cpu().numpy(), "position": pos.cpu().numpy(),
            "velocity": vel.cpu().numpy(), "action": act.cpu().numpy()}
    return data, np.arange(1, E + 1, dtype=np.int64) * F


def batch_pool(seed: int, n_windows: int, B: int, size: int) -> np.ndarray:
    """(size, B) window indices: whole permutations of the windows, in
    batches, from the seed."""
    rng = np.random.default_rng([seed, 2])
    per = n_windows // B
    reps = -(-size // per)
    return np.concatenate([rng.permutation(n_windows)[:per * B]
                           .reshape(per, B) for _ in range(reps)])[:size]


def leaves(params):
    return [((top, n), p) for top, m in params.items()
            for n, p in m.named_parameters()]


class Generator:
    def __init__(self, run, control: bool = False):
        self.run = run
        self.control = control
        self.clock = Clock(run.device)

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from state_policy_diffusionmodel_torch.data.dataset import (
            DataModule, WindowDataset,
        )
        from state_policy_diffusionmodel_torch.train import (
            TrainConfig, Trainer, load_run, make_optimizer, make_train_step,
        )

        run, t, c = self.run, self.run.traffic, self.run.config
        dev = run.device
        r = c["recipe"]
        policy, params, _ = load_run(os.path.join(ROOT, c["run_dir"]), dev,
                                     ema=c["ema"], epoch=c["epoch"])
        config_matches(policy.config, c)
        cfg = policy.config
        self.B = int(t["batch"])
        self.episodes, self.ends = make_episodes(run.seed, t, dev)
        ws = WindowDataset((self.episodes, self.ends), cfg.obs_horizon,
                           cfg.pred_horizon, cfg.step_size)
        dm = DataModule(self.B, T_obs=cfg.obs_horizon, T_pred=cfg.pred_horizon,
                        seed=run.seed % (2**31), step_size=cfg.step_size)
        dm.data_full, dm.stats = ws, ws.stats
        dm.train_idx, dm.val_idx = np.arange(len(ws)), np.arange(0)
        tcfg = TrainConfig(
            epochs=int(r["epochs"]), batch_size=self.B, lr=float(r["lr"]),
            grad_clip=float(r["grad_clip"]), min_lr=float(r["min_lr"]),
            lr_schedule=r["lr_schedule"], amp=self.control or r["amp"],
            seed=run.seed % (2**31), device_data=True, early_stop=False,
            ema_decay=float(r["ema_decay"]))
        trainer = Trainer(policy, tcfg, os.path.join(CACHE_DIR, "train_out"))
        optimizer = make_optimizer(tcfg, params)
        ema = copy.deepcopy(params)
        self.step = make_train_step(policy, params, optimizer, tcfg.amp, ema,
                                    tcfg.ema_decay, trainer.mesh)
        self.gen = torch.Generator(device=dev).manual_seed(tcfg.seed)
        self.batches = batch_pool(run.seed, len(ws), self.B,
                                  int(t["batch_pool"]))
        self.lr = float(r["lr"])
        self.trainer, self.dm, self.policy = trainer, dm, policy
        self.params, self.ema, self.optimizer = params, ema, optimizer
        self.n_windows = len(ws)

        # the checked steps: the program's own step on the pool's first
        # batches, with what the reference needs kept
        p0 = {k: p.detach().clone() for k, p in leaves(params)}
        self.fed, losses = [], []
        n_checked = int(t["checked_steps"])
        for i in range(n_checked):
            batch, tt, noise = trainer._batch(dm, self.batches[i], self.gen)
            losses.append(self.step(batch, self.lr, t=tt, noise=noise))
            self.fed.append((self.batches[i], tt, noise))
            if i == 0:
                mom = optimizer.moments("exp_avg")
                self.grad = {k: (None if p not in optimizer.adam.state
                                 or not optimizer.adam.state[p]
                                 else float(torch.linalg.vector_norm(
                                     mom[p].double())) / (1 - B1))
                             for k, p in leaves(params)}
        self.change = {k: float(torch.linalg.vector_norm(
            (p.detach() - p0[k]).double())) for k, p in leaves(params)}
        self.ema_change = {k: float(torch.linalg.vector_norm(
            (e.detach() - p0[k]).double())) for k, e in leaves(ema)}
        self.losses = [float(v) for v in losses]
        del p0
        for i in range(n_checked, int(t["warmup_steps"])):
            self._one(i)
        self.clock.sync()

    def _one(self, i: int):
        """One unit: the trainer's batch, then the step; (start, batch
        done) events."""
        idx = self.batches[i % len(self.batches)]
        e0 = self.clock.event()
        batch, tt, noise = self.trainer._batch(self.dm, idx, self.gen)
        e1 = self.clock.event()
        self.step(batch, self.lr, t=tt, noise=noise)
        return e0, e1

    # -- the window -----------------------------------------------------------
    def window(self):
        run = self.run
        tracer = None
        if run.trace:
            tracer = Tracer(int(run.traffic["trace_steps"]),
                            self.clock.sync)
            tracer.start()
        first = int(run.traffic["warmup_steps"])
        marks = []
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        i = 0
        while i == 0 or time.perf_counter() < deadline:
            if tracer is not None and tracer.prof is not None:
                tracer.at_unit(i)
            marks.append(self._one(first + i))
            i += 1
        end = self.clock.event()
        self.clock.sync()
        t_end = time.perf_counter()
        if tracer is not None and tracer.prof is not None:
            # a window shorter than the traced steps
            tracer.units = i
            tracer.at_unit(i)
        run.units, run.unit_items = i, self.B
        run.window_s = t_end - t0
        starts = [m[0] for m in marks] + [end]
        run.spans["step"] = [self.clock.ms(a, b)
                             for a, b in zip(starts, starts[1:])]
        run.spans["batch"] = [self.clock.ms(a, b) for a, b in marks]
        run.attempted = i * self.B
        if tracer is not None:
            run.traced_units = tracer.units
            run.profile = tracer.profile
        run.info.update(steps=i, batch=self.B, windows=self.n_windows,
                        checked_losses=self.losses)

    def release(self):
        for name in ("step", "trainer", "dm", "policy", "params", "ema",
                     "optimizer", "gen"):
            setattr(self, name, None)

    # -- the check ------------------------------------------------------------
    def check(self):
        from ..reference import checkpoints as ref_ckpt
        from ..reference.data import Windows
        from ..reference.train import ReferenceTrainer, snapshot

        run, t = self.run, self.run.traffic
        dev = run.device
        policy, params, _ = ref_ckpt.load_weights(ROOT, run.config, dev)
        cfg = policy.config
        ref = ReferenceTrainer(policy, params,
                               float(run.config["recipe"]["ema_decay"]))
        p0 = snapshot(params)
        windows = Windows(self.episodes, self.ends,
                          cfg.obs_horizon + cfg.pred_horizon, cfg.step_size)
        losses, grad = [], {}
        for i, (idx, tt, noise) in enumerate(self.fed):
            batch = windows.batch(idx, cfg.obs_horizon, dev)
            loss, grads = ref.step(batch, self.lr, tt, noise)
            losses.append(loss)
            if i == 0:
                grad = {k: float(torch.linalg.vector_norm(g.double()))
                        for k, g in grads.items()}
        change = {k: float(torch.linalg.vector_norm((p.detach() - p0[k])
                                                    .double()))
                  for k, p in ref.flat().items()}
        ema_change = {k: float(torch.linalg.vector_norm(e - p0[k].double()))
                      for k, e in ref.ema.items()}
        values = gaps(self.losses, losses, self.grad, grad, self.change,
                      change, self.ema_change, ema_change)
        run.info["reference_losses"] = losses
        return {name: {"value": values[name], "limit": lim}
                for name, lim in t["limits"].items()}


def worst_leaf(got: dict, ref: dict, keys, med_keys) -> float:
    """max over `keys` of |got - ref| / max(ref, the median of ref over
    `med_keys`)."""
    keys = list(keys)
    if not keys:
        return 0.0
    med = float(np.median([ref[k] for k in med_keys])) if med_keys else 0.0
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in keys)


def gaps(loss_p, loss_r, grad_p, grad_r, change_p, change_r, ema_p, ema_r):
    """The four numbers compared; grad_p holds None and grad_r no entry
    for leaves without a gradient."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(loss_p, loss_r))
    with_grad = [k for k in change_r if k in grad_r]
    med = float(np.median([grad_r[k] for k in with_grad])) \
        if with_grad else 0.0
    gp = {k: (grad_p.get(k) or 0.0) for k in change_r}
    grad_gap = worst_leaf(gp, grad_r, with_grad, with_grad)
    # a leaf the program gave a gradient and the reference did not
    stray = [gp[k] / med for k in change_r if k not in grad_r and med > 0]
    grad_gap = max([grad_gap] + stray)
    moving = [k for k in change_r
              if k not in grad_r or grad_r[k] >= 1e-3 * med]
    counted = [k for k in moving if k in grad_r]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "change_gap": worst_leaf(change_p, change_r, moving, counted),
            "ema_gap": worst_leaf(ema_p, ema_r, counted, counted)}
