"""The reference evaluation suite as library functions.

Counterpart of `state_policy_diffusionmodel_tpu/eval/suite.py`, with the
same seven evals and results:

- `position_consistency`: N samples on one window, per-step mean and std
  of the position error against the ground truth;
- `position_accuracy`: every window (or the first max_windows), one sample
  each, in chunks of one sampler call; mean per-step position error and
  the action head's errors and signed biases;
- `precision`: the spread of N samples, and their actions replayed in the
  env held for step_size frames;
- `action_consistency`: N samples' actions replayed in the env with linear
  interpolation, against the ground-truth positions;
- `robustness`: a uniform observation-noise sweep (alpha = level * 0.01)
  of each level's predicted positions and actions and their replay;
- `compare_position_actions`: the position head against the trajectory
  its own actions drive;
- `smoke`: one sample end to end, its replay against the replay of the
  dataset's own actions, and an optional overlay figure.

x_T: the JAX package draws it inside its sampler from a threefry key,
which torch cannot reproduce. Here `sample_n` and `sample_batch` draw it
with `policy.init_noise` from a `torch.Generator` seeded with the call's
seed, or take it from `init_noise_fn(n, seed)` when the context has one
(the parity tests hand both packages the same x_T that way).

Replays step the env with `render=False` on a one-track bank of the
episode's track (`meta/track_seed`, else `track_seed`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data import normalize as N
from ..data.dataset import WindowDataset
from ..diffusion import DiffusionPolicy
from ..envs import car_racing as env
from ..track import build as build_track, make_track, stack as stack_tracks
from . import rollout


@dataclasses.dataclass
class EvalContext:
    """Everything the eval functions need. `init_noise_fn(n, seed)`, when
    given, supplies the (n, horizon, prediction_dim) x_T of each sampler
    call."""

    policy: DiffusionPolicy
    params: Dict
    dataset: WindowDataset          # inference mode (stats supplied)
    track_seed: int = 42            # env track for closed-loop replays
    sampler: str = "ddim"
    num_inference_steps: int = 50
    ddim_spacing: str = "leading"
    init_noise_fn: Optional[Callable] = None

    def __post_init__(self):
        self._geom_cache = {}

    @property
    def device(self) -> torch.device:
        return self.policy.device

    @property
    def geom(self):
        """The default track's one-track bank (for datasets without
        per-episode seeds)."""
        return self._geom_for_seed(self.track_seed)

    def _geom_for_seed(self, seed: int):
        if seed not in self._geom_cache:
            self._geom_cache[seed] = stack_tracks(
                [build_track(make_track(seed), device=self.device)])
        return self._geom_cache[seed]

    def episode_of(self, start: int):
        """(episode index, ep_start, ep_end) of global frame `start`."""
        ends = self.dataset.episode_ends
        ep = int(np.searchsorted(ends, start, side="right"))
        ep_start = 0 if ep == 0 else int(ends[ep - 1])
        return ep, ep_start, int(ends[ep])

    def warmed_state(self, start: int):
        """(geom, state, episode-local dense actions, n_warm): one env
        warm-started through the observation span of the window starting
        at global frame `start`, on that episode's track.

        With per-frame `car_state` vectors in the dataset, the warm start
        restores the recorded post-step state of frame n_warm - 1 into a
        fresh reset (`env.reset_car`, O(1)): car_state[t] follows action t,
        so restoring frame n_warm - 1 stands for replaying n_warm actions.
        Otherwise the episode's own actions are replayed from the reset.
        The two agree closely but not exactly: `save_state` records the
        hull's COM velocity, which `restore_state` takes as the assembly
        COM's, and the rear joint angles restart from their steer targets.
        Tile and reward accounting restarts either way."""
        cfg = self.policy.config
        ep, ep_start, ep_end = self.episode_of(start)
        seeds = self.dataset.meta.get("track_seed")
        seed = int(seeds[ep]) if seeds is not None else self.track_seed
        geom = self._geom_for_seed(seed)
        ep_actions = np.asarray(N.unnormalize_data(
            self.dataset.train_data["action"][ep_start:ep_end],
            self.dataset.stats["action"]))
        n_warm = (start - ep_start) + cfg.obs_horizon * cfg.step_size
        car_states = getattr(self.dataset, "car_state", None)
        if car_states is not None and n_warm > 0:
            ids = torch.zeros(1, dtype=torch.int32, device=self.device)
            state0, _ = env.reset(geom, ids, render=False)
            saved = torch.as_tensor(car_states[ep_start + n_warm - 1])
            state0 = env.reset_car(state0, saved[None].to(self.device))
        else:
            state0 = rollout.state_at_window_start(geom, ep_actions, n_warm)
        return geom, state0, ep_actions, n_warm

    def window(self, idx: int):
        sample, translation, start, end = self.dataset.get_window(idx)
        batch = {k: torch.as_tensor(v)[None].to(self.device)
                 for k, v in sample.items()}
        return batch, translation, start, end

    def _x_T(self, n: int, seed: int) -> torch.Tensor:
        if self.init_noise_fn is not None:
            return torch.as_tensor(self.init_noise_fn(n, seed)).to(
                self.device, torch.float32)
        return self.policy.init_noise(n, torch.Generator().manual_seed(seed))

    def _sample(self, batch, x_T) -> torch.Tensor:
        return self.policy.sample(
            self.params, batch, sampler=self.sampler,
            num_inference_steps=self.num_inference_steps,
            ddim_spacing=self.ddim_spacing, init_noise=x_T)

    def sample_n(self, batch, n_runs: int, seed: int = 0) -> torch.Tensor:
        """(n_runs, horizon, 5) predictions for one window batch."""
        tiled = {k: torch.repeat_interleave(v, n_runs, dim=0)
                 for k, v in batch.items()}
        return self._sample(tiled, self._x_T(n_runs, seed))

    def sample_batch(self, batch, seed: int = 0) -> torch.Tensor:
        """(B, horizon, 5): one prediction per batch element, one sampler
        call."""
        B = next(iter(batch.values())).shape[0]
        return self._sample(batch, self._x_T(B, seed))

    def unnormalize_positions(self, pred, translation) -> np.ndarray:
        """(..., horizon, 2) world positions from normalized predictions."""
        return N.unnormalize_position(
            _host(pred)[..., :2], translation,
            self.dataset.stats["position"])

    def unnormalize_actions(self, pred) -> np.ndarray:
        return N.unnormalize_data(_host(pred)[..., 2:],
                                  self.dataset.stats["action"])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _on(ctx: EvalContext, a: np.ndarray) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32)).to(ctx.device)


def _gt_positions(ctx: EvalContext, idx: int) -> np.ndarray:
    sample, translation, _, _ = ctx.dataset.get_window(idx)
    gt = N.unnormalize_position(sample["position"], translation,
                                ctx.dataset.stats["position"])
    cfg = ctx.policy.config
    return gt[cfg.obs_horizon - cfg.inpaint_horizon:]


def position_consistency(ctx: EvalContext, window_idx: int = 70,
                         n_runs: int = 10, seed: int = 0) -> Dict:
    batch, translation, _, _ = ctx.window(window_idx)
    preds = ctx.sample_n(batch, n_runs, seed)          # (n, horizon, 5)
    pos = ctx.unnormalize_positions(preds, translation)
    gt = _gt_positions(ctx, window_idx)
    err = np.linalg.norm(pos - gt[None], axis=-1)      # (n, horizon)
    return {"mean_error": err.mean(0), "std_error": err.std(0),
            "positions": pos, "ground_truth": gt}


def position_accuracy(ctx: EvalContext, max_windows: Optional[int] = None,
                      seed: int = 0, chunk: int = 64) -> Dict:
    """All-window sweep, one sample each, `chunk` windows a sampler call
    (the last chunk padded with its last window, so every call has one
    shape)."""
    cfg = ctx.policy.config
    n = len(ctx.dataset) if max_windows is None else min(
        max_windows, len(ctx.dataset))
    chunk = min(chunk, n)
    tail = cfg.obs_horizon - cfg.inpaint_horizon
    errors, act_errors, act_abs, act_signed = [], [], [], []
    for c0 in range(0, n, chunk):
        idxs = np.arange(c0, min(c0 + chunk, n))
        pad = chunk - len(idxs)
        padded = np.concatenate([idxs, np.repeat(idxs[-1:], pad)]) if pad \
            else idxs
        # the conditioning reads the first obs_horizon image frames only
        batch_np, translations = ctx.dataset.batch(
            padded, return_translations=True, image_frames=cfg.obs_horizon)
        batch = {k: _on(ctx, v) for k, v in batch_np.items()}
        preds = _host(ctx.sample_batch(batch, seed + c0))
        pos = ctx.unnormalize_positions(preds, translations)
        gt = N.unnormalize_position(batch_np["position"], translations,
                                    ctx.dataset.stats["position"])[:, tail:]
        err = np.linalg.norm(pos - gt, axis=-1)        # (chunk, horizon)
        errors.append(err[: len(idxs)])
        # the action head's error: normalized L2 a step, and per dimension
        # |err| and the signed error in native units
        a_pred = preds[..., 2:5]
        a_gt = batch_np["action"][:, tail:]
        act_errors.append(
            np.linalg.norm(a_pred - a_gt, axis=-1)[: len(idxs)])
        a_pred_u = ctx.unnormalize_actions(preds)
        a_gt_u = np.asarray(N.unnormalize_data(a_gt,
                                               ctx.dataset.stats["action"]))
        act_abs.append(np.abs(a_pred_u - a_gt_u)[: len(idxs)])
        act_signed.append((a_pred_u - a_gt_u)[: len(idxs)])
    errors = np.concatenate(errors)                    # (n_windows, horizon)
    act_errors = np.concatenate(act_errors)
    act_abs = np.concatenate(act_abs)                  # (n, horizon, 3)
    act_signed = np.concatenate(act_signed)
    return {"per_step_error": errors.mean(0),
            "per_window_error": errors.mean(1),
            "overall": float(errors.mean()),
            "action_per_step_error": act_errors.mean(0),
            "action_overall": float(act_errors.mean()),
            "action_mae_steer": float(act_abs[..., 0].mean()),
            "action_mae_gas": float(act_abs[..., 1].mean()),
            "action_mae_brake": float(act_abs[..., 2].mean()),
            "action_bias_steer": float(act_signed[..., 0].mean()),
            "action_bias_gas": float(act_signed[..., 1].mean()),
            "action_bias_brake": float(act_signed[..., 2].mean())}


def precision(ctx: EvalContext, window_idx: int = 70, n_runs: int = 5,
              seed: int = 0) -> Dict:
    """Repeatability, and the samples' actions replayed held for step_size
    frames (eval_precision.py)."""
    cfg = ctx.policy.config
    batch, translation, start, _ = ctx.window(window_idx)
    preds = ctx.sample_n(batch, n_runs, seed)
    pos = ctx.unnormalize_positions(preds, translation)
    spread = pos.std(0).mean()

    actions = ctx.unnormalize_actions(preds)           # (n, horizon, 3)
    geom, state0, _, _ = ctx.warmed_state(start)
    frames = rollout.hold_actions(
        _on(ctx, actions[:, cfg.inpaint_horizon:]), cfg.step_size)
    _, traj, _ = rollout.replay_batch(geom, state0, frames,
                                      int(frames.shape[1]))
    return {"sample_spread": float(spread), "positions": pos,
            "rollout_positions": _host(traj)}


def action_consistency(ctx: EvalContext, window_idx: int = 70,
                       n_runs: int = 5, seed: int = 0) -> Dict:
    """The samples' actions replayed with linear interpolation
    (eval_consistency_diffusion_actions.py)."""
    cfg = ctx.policy.config
    batch, translation, start, _ = ctx.window(window_idx)
    preds = ctx.sample_n(batch, n_runs, seed)
    actions = ctx.unnormalize_actions(preds)[:, cfg.inpaint_horizon:]
    geom, state0, _, _ = ctx.warmed_state(start)
    frames = rollout.interpolate_actions(_on(ctx, actions), cfg.step_size)
    n_steps = int(frames.shape[1])
    _, traj, _ = rollout.replay_batch(geom, state0, frames, n_steps)
    traj = _host(traj)                                 # (n, steps, 2)
    gt = _gt_positions(ctx, window_idx)[1:]
    gt_at_frames = gt[np.minimum(
        np.arange(n_steps) // cfg.step_size, len(gt) - 1)]
    err = np.linalg.norm(traj - gt_at_frames[None], axis=-1)
    return {"mean_error": err.mean(0), "std_error": err.std(0),
            "trajectories": traj}


def robustness(ctx: EvalContext, window_idx: int = 70, n_levels: int = 5,
               seed: int = 0) -> Dict:
    """Uniform observation-noise sweep, alpha = level * 0.01
    (eval_robustness.py:166-322): per level, sample under noisy
    observations, the MSE of the predicted positions and actions against
    the ground truth, and of the predicted actions replayed (held for
    step_size frames). Each level perturbs the clean batch (the reference
    re-noises the noisy one, so its noise accumulates), as the JAX
    package does."""
    cfg = ctx.policy.config
    batch, translation, start, _ = ctx.window(window_idx)
    gt_pos = _gt_positions(ctx, window_idx)
    sample, _, _, _ = ctx.dataset.get_window(window_idx)
    gt_act = np.asarray(N.unnormalize_data(
        np.asarray(sample["action"]), ctx.dataset.stats["action"]))[
        cfg.obs_horizon - cfg.inpaint_horizon:]

    geom, state0, _, _ = ctx.warmed_state(start)

    rng = np.random.default_rng(seed)
    rows = []
    trajectories = []
    for level in range(n_levels):
        alpha = level * 0.01
        noisy = {k: v + alpha * _on(ctx, rng.uniform(-1, 1, v.shape))
                 for k, v in batch.items()}
        pred = ctx.sample_n(noisy, 1, seed + level)
        pos = ctx.unnormalize_positions(pred, translation)[0]
        act = ctx.unnormalize_actions(pred)[0]

        frames = rollout.hold_actions(_on(ctx, act[cfg.inpaint_horizon:]),
                                      cfg.step_size)
        n_steps = int(frames.shape[0])
        _, traj, _ = rollout.replay(geom, state0, frames[None], n_steps)
        traj = _host(traj[0])
        # executed positions at the window's cadence against the ground
        # truth: exec_pos[k] is the pose (k+1)*step_size frames past the
        # observation span, window step obs_horizon + k + 1, gt_pos index
        # inpaint_horizon + k + 1
        exec_pos = traj[cfg.step_size - 1::cfg.step_size]
        gt_exec = gt_pos[cfg.inpaint_horizon + 1:][: len(exec_pos)]
        trajectories.append(traj)

        rows.append({
            "alpha": alpha,
            "position_mse": float(((pos - gt_pos) ** 2).mean()),
            "action_mse": float(((act - gt_act) ** 2).mean()),
            "replay_position_mse": float(
                ((exec_pos[: len(gt_exec)] - gt_exec) ** 2).mean()),
        })
    return {"levels": rows, "trajectories": np.stack(trajectories)}


def compare_position_actions(ctx: EvalContext, window_idx: int = 70,
                             seed: int = 0) -> Dict:
    """Position head against the trajectory its actions drive
    (eval_compare_position_actions.py:198-270)."""
    cfg = ctx.policy.config
    batch, translation, start, _ = ctx.window(window_idx)
    pred = ctx.sample_n(batch, 1, seed)
    pos_head = ctx.unnormalize_positions(pred, translation)[0][
        cfg.inpaint_horizon:]
    actions = ctx.unnormalize_actions(pred)[0, cfg.inpaint_horizon:]
    geom, state0, _, _ = ctx.warmed_state(start)
    frames = rollout.interpolate_actions(_on(ctx, actions), cfg.step_size)
    _, traj, _ = rollout.replay(geom, state0, frames[None],
                                int(frames.shape[0]))
    exec_pos = _host(traj[0])[cfg.step_size - 1::cfg.step_size][
        : len(pos_head) - 1]
    k = len(exec_pos)
    dists = np.linalg.norm(pos_head[1: k + 1] - exec_pos, axis=-1)
    return {"pointwise_distance": dists, "position_head": pos_head,
            "executed": exec_pos}


def smoke(ctx: EvalContext, window_idx: int = 0, seed: int = 0,
          fig_path: Optional[str] = None) -> Dict:
    """evaluate_init.py: one sample end to end, then its actions executed
    in the env (warm-started through the observation span, held for
    step_size frames) against a replay of the dataset's own actions over
    the same span, and optionally both trajectories overlaid with the
    position head and the ground-truth positions in a figure."""
    cfg = ctx.policy.config
    batch, translation, start, end = ctx.window(window_idx)
    pred = ctx.sample_n(batch, 1, seed)
    pos = ctx.unnormalize_positions(pred, translation)
    act = ctx.unnormalize_actions(pred)
    if not (np.isfinite(pos).all() and np.isfinite(act).all()):
        raise FloatingPointError("smoke: the sample is not finite")

    geom, state0, ep_actions, n_warm = ctx.warmed_state(start)
    frames = rollout.hold_actions(_on(ctx, act[0, cfg.inpaint_horizon:]),
                                  cfg.step_size)
    _, pred_traj, _ = rollout.replay(geom, state0, frames[None],
                                     int(frames.shape[0]))
    pred_traj = _host(pred_traj[0])

    # the episode's own actions from the reset (evaluate_init.py:205-215),
    # over the same post-observation span
    ids = torch.zeros(1, dtype=torch.int32, device=ctx.device)
    state1, _ = env.reset(geom, ids, render=False)
    n_total = min(n_warm + int(frames.shape[0]), len(ep_actions))
    _, full_traj, _ = rollout.replay(
        geom, state1, _on(ctx, ep_actions[:n_total])[None], n_total)
    gt_traj = _host(full_traj[0])[n_warm:]

    k = min(len(pred_traj), len(gt_traj))
    replay_mse = float(((pred_traj[:k] - gt_traj[:k]) ** 2).mean())
    gt_pos = _gt_positions(ctx, window_idx)

    if fig_path is not None:
        from ..utils import plotting
        plt = plotting._plt()
        fig = plt.figure()
        plt.plot(gt_pos[:, 0], gt_pos[:, 1], "g.-", label="GT positions")
        plt.plot(gt_traj[:, 0], gt_traj[:, 1], "c-",
                 label="Replayed GT actions")
        plt.plot(pred_traj[:, 0], pred_traj[:, 1], "y-",
                 label="Replayed predicted actions")
        plt.scatter(pos[0][:, 0], pos[0][:, 1], c="r", s=12,
                    label="Predicted positions")
        plt.legend()
        plt.axis("equal")
        plt.grid()
        plt.title(f"smoke replay overlay (window {window_idx})")
        fig.savefig(fig_path, dpi=120)
        plt.close(fig)

    return {"positions": pos[0], "actions": act[0],
            "pred_replay_trajectory": pred_traj,
            "gt_replay_trajectory": gt_traj,
            "replay_mse": replay_mse}
