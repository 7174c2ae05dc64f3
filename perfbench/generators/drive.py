"""Closed-loop driving: the ring policy drives a batch of envs.

Traffic parameters (`workloads/<cell>.json`): `envs`, `tracks` (the bank:
`tracks` tracks whose generator seeds are drawn from the run's seed, env b
on track b % tracks), `sampler`, `inference_steps`, `ddim_spacing`,
`warmup_frames` (a rollout of its own in set-up, from a reset, through the
window's own callable), `trace_frames` (the frames under the profiler in a
traced run), `check_replans` and `check_frames` (how many replanning and
other frames the reference recomputes, drawn from the seed among the first
`check_within` frames; frame 0, the reset and the first plan, always) and
`limits`.

The program's path: `train.load_run` (the configuration's run, epoch and
EMA weights), `track.build(make_track(seed))` stacked into a bank,
`diffusion.make_ring_policy` and `envs.vector.rollout_policy` with
auto-reset. The window is one rollout from a reset; the harness's callable
around the policy records a CUDA event at every call and, once `seconds`
have passed since the first, ends the rollout. A frame is the work between
two calls: the policy (every `step_size`-th frame a replan) and one env
step with its render.

The check: for each drawn frame k, the reference steps the program's
states of frame k - 1 with the program's action (physics, tiles, render,
auto-reset), encodes the frame, and runs the ring policy from the
program's ring as frame k found it: the env's state at frame k (the car's
fields and the tile count), the newest features, positions and velocities
of the ring, and on a replanning frame the actions, are compared with the
program's. Frame 0 runs from the reference's own reset and an empty ring.
`obs_gap` is the largest relative gap of the state and the ring's newest
entries; `action_gap` the largest absolute gap of an action on a
replanning frame.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..harness import ROOT, Refused
from ..trace import Tracer
from . import Clock, config_matches


class StopWindow(Exception):
    pass


def track_seeds(seed: int, n: int):
    rng = np.random.default_rng(seed)
    return [int(s) for s in rng.integers(0, 2**31 - 1, size=n)]


def check_frames(seed: int, traffic: dict):
    """Frame 0 and the drawn replanning and other frames, sorted."""
    rng = np.random.default_rng([seed, 1])
    step = int(traffic["step_size"])
    within = int(traffic["check_within"])
    replans = np.arange(step, within, step)
    others = np.array([k for k in range(1, within) if k % step])
    chosen = set(rng.choice(replans, traffic["check_replans"],
                            replace=False).tolist())
    chosen |= set(rng.choice(others, traffic["check_frames"],
                             replace=False).tolist())
    return [0] + sorted(int(k) for k in chosen)


class Generator:
    def __init__(self, run, control: bool = False):
        self.run = run
        self.control = control
        self.clock = Clock(run.device)
        t = run.traffic
        if (t["sampler"], t["ddim_spacing"]) != ("ddim", "leading"):
            raise Refused(f"the reference samples with DDIM on the leading "
                          f"grid, not {t['sampler']!r} on "
                          f"{t['ddim_spacing']!r}")
        self.envs = int(t["envs"])
        self.frames_checked = check_frames(run.seed, dict(
            t, step_size=run.config["policy"]["step_size"]))
        self.records = {}

    # -- set-up ---------------------------------------------------------------
    def setup(self):
        from state_policy_diffusionmodel_torch import track
        from state_policy_diffusionmodel_torch.diffusion import (
            env_policy, make_ring_policy,
        )
        from state_policy_diffusionmodel_torch.train import load_run

        run, t, c = self.run, self.run.traffic, self.run.config
        dev = run.device
        policy, params, stats = load_run(
            os.path.join(ROOT, c["run_dir"]), dev, ema=c["ema"],
            epoch=c["epoch"])
        config_matches(policy.config, c)
        self.policy, self.params = policy, params
        self.seeds = track_seeds(run.seed, int(t["tracks"]))
        self.bank = track.stack([track.build(track.make_track(s),
                                             device=dev)
                                 for s in self.seeds])
        self.ids = (torch.arange(self.envs, dtype=torch.int32, device=dev)
                    % int(t["tracks"]))
        self.xt_seed = run.seed % (2**31)
        self.fn = make_ring_policy(
            policy, stats, sampler=t["sampler"],
            num_inference_steps=int(t["inference_steps"]),
            ddim_spacing=t["ddim_spacing"], amp=self.control,
            seed=self.xt_seed)
        self.inner = env_policy(self.fn, params)
        self.step_size = policy.config.step_size
        self._rollout(int(t["warmup_frames"]), None)
        self.clock.sync()

    def _rollout(self, n_frames, window):
        """One rollout from a reset; `window` (a dict) makes it the timed
        one, ended by the clock."""
        from state_policy_diffusionmodel_torch.diffusion import (
            init_ring_carry,
        )
        from state_policy_diffusionmodel_torch.envs import vector

        keep = set(self.frames_checked) | {k - 1 for k in self.frames_checked
                                          if k > 0}
        calls = []

        def policy(carry, states, prev_res):
            k = len(calls)
            if window is not None:
                if k == 0:
                    window["t0"] = time.perf_counter()
                    window["deadline"] = window["t0"] + self.run.seconds
                elif time.perf_counter() >= window["deadline"]:
                    window["end"] = self.clock.event()
                    raise StopWindow
                if window["tracer"] is not None and \
                        window["tracer"].at_unit(k):
                    window["tracer"] = None
            calls.append(self.clock.event())
            a, out = self.inner(carry, states, prev_res)
            if window is not None and k in keep:
                self.records[k] = {"carry_in": carry, "states": states,
                                   "action": a, "carry_out": out}
            return a, out

        if window is None:
            vector.rollout_policy(self.bank, policy,
                                  init_ring_carry(self.policy, self.envs),
                                  n_frames, auto_reset=True,
                                  track_ids=self.ids, device=self.run.device)
            return calls
        try:
            vector.rollout_policy(self.bank, policy,
                                  init_ring_carry(self.policy, self.envs),
                                  10**9, auto_reset=True, track_ids=self.ids,
                                  device=self.run.device)
        except StopWindow:
            pass
        return calls

    # -- the window -----------------------------------------------------------
    def window(self):
        run = self.run
        tracer = None
        if run.trace:
            tracer = Tracer(int(run.traffic["trace_frames"]),
                            self.clock.sync)
            tracer.start()
        w = {"tracer": tracer}
        calls = self._rollout(None, w)
        self.clock.sync()
        t_end = time.perf_counter()
        if tracer is not None and tracer.prof is not None:
            # a window shorter than the traced frames
            tracer.units = len(calls)
            tracer.at_unit(len(calls))
        n = len(calls)
        run.units, run.unit_items = n, self.envs
        run.window_s = t_end - w["t0"]
        ends = calls[1:] + [w["end"]]
        run.spans["frame"] = [self.clock.ms(a, b)
                              for a, b in zip(calls, ends)]
        run.marks["replan"] = [k % self.step_size == 0 for k in range(n)]
        run.attempted = n * self.envs
        if tracer is not None:
            run.traced_units = tracer.units
            run.profile = tracer.profile
        run.info.update(frames=n, envs=self.envs,
                        replans=sum(run.marks["replan"]),
                        track_seeds=self.seeds,
                        frames_checked=self.frames_checked)

    def release(self):
        for name in ("policy", "params", "bank", "fn", "inner"):
            setattr(self, name, None)

    # -- the check ------------------------------------------------------------
    def check(self):
        from ..reference import checkpoints as ref_ckpt
        from ..reference import track as ref_track
        from ..reference.diffusion import init_ring_carry, make_ring_policy
        from ..reference.envs import car_racing as ref_env
        from ..reference.physics import CarState

        run, t = self.run, self.run.traffic
        dev = run.device
        limits = t["limits"]
        missing = [k for k in self.frames_checked if k not in self.records
                   or (k > 0 and k - 1 not in self.records)]
        if missing:
            return {name: {"value": None, "limit": lim}
                    for name, lim in limits.items()}
        with torch.no_grad():
            policy, params, stats = ref_ckpt.load_weights(ROOT, run.config,
                                                          dev)
            bank = ref_track.stack([ref_track.build(
                ref_track.make_track(s), device=dev) for s in self.seeds])
            fn = make_ring_policy(
                policy, stats, num_inference_steps=int(t["inference_steps"]),
                seed=self.xt_seed)
            ids = self.ids
            obs_gap = action_gap = 0.0
            for k in self.frames_checked:
                rec = self.records[k]
                if k == 0:
                    _, res = ref_env.reset(bank, ids)
                    carry = init_ring_carry(policy, self.envs)
                else:
                    prev = self.records[k - 1]
                    s = prev["states"]
                    states = ref_env.EnvState(CarState(*s.car), *s[1:])
                    new, res = ref_env.step(states, bank, ids,
                                            prev["action"])
                    new = ref_env.auto_reset(new, bank, ids)
                    obs_gap = max(obs_gap, _state_gap(rec["states"], new))
                    carry = rec["carry_in"]
                a, out = fn(params, carry, res.obs, res.info.car_position,
                            res.info.car_velocity)
                for key in ("image_features", "position", "velocity"):
                    if key not in out["hist"]:
                        continue
                    ref = out["hist"][key][:, -1]
                    got = rec["carry_out"]["hist"][key][:, -1]
                    obs_gap = max(obs_gap, _rel_gap(got, ref))
                if k % self.step_size == 0:
                    action_gap = max(action_gap, float(
                        (rec["action"].float() - a.float()).abs().max()))
        self.records = {}
        values = {"obs_gap": obs_gap, "action_gap": action_gap}
        return {name: {"value": values[name], "limit": lim}
                for name, lim in limits.items()}


def _state_gap(got, ref) -> float:
    """The largest relative gap of the car's fields and the tile count."""
    pairs = list(zip(got.car, ref.car)) + [(got.tile_count, ref.tile_count)]
    return max(_rel_gap(a, b) for a, b in pairs)


def _rel_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    scale = float(ref.float().abs().max())
    gap = float((got.float() - ref.float()).abs().max())
    return gap / scale if scale > 0 else gap
