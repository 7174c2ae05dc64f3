"""Training loop for the diffusion policy, PyTorch, on one device or
data-parallel over the ranks of a `parallel.Mesh`.

Counterpart of `state_policy_diffusionmodel_tpu/train/loop.py`, with its
config, schedule and artifacts: Adam with 0.5 global-norm clipping,
host-side ReduceLROnPlateau + lr early stopping (both stepped once per
epoch on the epoch's last val_loss) or a half-cosine lr over the epochs,
quarter-epoch validation, per-epoch checkpoints, an EMA of the params, the
fp16 insurance snapshot, a STATS.pkl sidecar, resume and `metrics.jsonl`.

There is no fused multi-step program: the TPU's `lax.scan` over a
validation interval becomes a plain loop of steps, over the device twin of
the dataset with `device_data`. Losses stay on the device until the end of
an interval, so the host reads them once per interval, not once per step.

Data parallelism (the JAX trainer's mesh) is one process a rank: the
`Trainer`'s mesh defaults to `parallel.make_mesh()`, so a torchrun launch
is data-parallel and a plain one is world size 1 and computes what a
single device does. Every rank seeds the same host RNG and generator,
computes the same global batch order, pads each global batch to a
multiple of the world size (repeat-last, the padded rows count in the
loss, as in JAX) and takes its block of rows; t and the noise are drawn
at the global batch's shape and each rank keeps its rows, so a step on N
ranks is the step on one. After the backward the gradients are averaged
over the ranks in one flat all_reduce, before the global-norm clip (optax
clips the reduced gradient). No DistributedDataParallel: the params are a
dict of modules and the encoder may be frozen. No layer keeps batch
statistics (GroupNorm throughout), so nothing else needs a reduction. The
logged train loss and every validation loss are means over the ranks, so
the plateau, early-stop and cosine decisions agree on every rank (a rank
that decided alone would deadlock the others at the next collective).
Only rank 0 writes: metrics.jsonl, checkpoints, the EMA, STATS.pkl,
hparams.yaml, the insurance snapshot and TensorBoard; a barrier follows
the saves at the end of `fit`. On resume every rank loads the same files.

The optimizer is the JAX package's `optax.chain(clip_by_global_norm(0.5),
inject_hyperparams(adam)(lr))` written out: optax's clip (unchanged below
the limit, else g / |g| * limit; torch's `clip_grad_norm_` divides by
|g| + 1e-6, which is another result), then `torch.optim.Adam` with optax's
betas and eps, its lr set on the param group before every step. Its state
saves and loads under optax's tree paths, so either package resumes the
other's run.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..data.dataset import DataModule, DeviceWindowDataset
from ..diffusion.policy import DiffusionPolicy
from ..parallel import (
    all_reduce_mean_, barrier, make_mesh, mean_over_ranks, pad_to_multiple,
    replicate, shard_batch,
)
from ..params_from_jax import _torch_leaf, params_to_jax, parse_keystr
from . import checkpoints as ckpt_lib
from .lr_schedule import ReduceLROnPlateau, should_early_stop


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Defaults = the reference's train.py, as in the JAX package."""

    epochs: int = 500
    batch_size: int = 16
    lr: float = 1e-4
    grad_clip: float = 0.5
    min_lr: float = 0.0         # plateau-decay floor (torch min_lr)
    val_interval: float = 0.25
    lr_schedule: str = "plateau"  # "plateau" | "cosine" (half-cosine lr ->
                                  # min_lr over `epochs`; ignores early_stop)
    amp: bool = False
    seed: int = 42
    log_every: int = 50
    device_data: bool = False   # dataset on the card, windows gathered there
    early_stop: bool = True     # stop when lr decays below 1e-4, or after
                                # epochs//10 epochs without an lr decrease
    ema_decay: float = 0.0      # > 0: an EMA of the params, updated every
                                # optimizer step, saved under
                                # checkpoints_ema/
    insurance_dir: Optional[str] = None
                                # when set: an fp16 npz snapshot of the (EMA
                                # if enabled) params + hparams/STATS here
                                # whenever the epoch's val loss improves
    tensorboard: bool = False   # mirror scalars to TensorBoard event files
                                # (where the tensorboard package imports)


def _cosine_lr(cfg: TrainConfig, epochs_done: int) -> float:
    """Half-cosine from cfg.lr to cfg.min_lr across the epoch budget."""
    frac = min(max(epochs_done / max(cfg.epochs, 1), 0.0), 1.0)
    return cfg.min_lr + 0.5 * (cfg.lr - cfg.min_lr) * (
        1.0 + float(np.cos(np.pi * frac)))


# optax.adam's defaults
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0
_ADAM = "[1].inner_state[0]."


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """`optax.clip_by_global_norm` in place: with g_norm the 2-norm of all
    gradients together, each g stays as it is when g_norm < max_norm and
    becomes (g / g_norm) * max_norm otherwise. Returns g_norm (on the
    device: nothing is read back)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


class Optimizer:
    """`make_optimizer` of the JAX package over the policy's modules: the
    global-norm clip, then Adam at the lr given to each step. Every
    parameter is in it, as every leaf is in the JAX tree; a frozen
    encoder's parameters get no gradient and so stay as they are, with zero
    moments, as they do under optax."""

    def __init__(self, params: Dict[str, torch.nn.Module], cfg: TrainConfig):
        self.modules = params
        self.params = [p for m in params.values() for p in m.parameters()]
        self.adam = torch.optim.Adam(self.params, lr=cfg.lr, betas=(B1, B2),
                                     eps=EPS)
        self.grad_clip = cfg.grad_clip
        self.count = 0
        self.lr = cfg.lr

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self, lr: float) -> None:
        """Clip, then one Adam step at `lr` (inject_hyperparams: the lr is a
        value of the step, not of the optimizer)."""
        clip_by_global_norm_([p.grad for p in self.params
                              if p.grad is not None], self.grad_clip)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        self.count += 1
        self.lr = lr

    def moments(self, key: str) -> Dict[torch.nn.Parameter, torch.Tensor]:
        """Adam's exp_avg (optax's mu) or exp_avg_sq (nu) by parameter;
        zeros where a parameter has had no gradient yet."""
        return {p: self.adam.state[p][key] if key in self.adam.state[p]
                else torch.zeros_like(p) for p in self.params}

    def state_to_jax(self) -> Dict[str, np.ndarray]:
        """The optimizer state as the keystr leaves of the JAX package's
        opt_state tree (inject_hyperparams' count and hyperparams, adam's
        count, mu and nu), in the flax layout."""
        out = {}
        for kind, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            for k, v in params_to_jax(self.modules,
                                      self.moments(key)).items():
                out[f"{_ADAM}{kind}{k}"] = v
        count = np.asarray(self.count, np.int32)
        out["[1].count"] = count
        out[f"{_ADAM}count"] = count
        for k, v in (("b1", B1), ("b2", B2), ("eps", EPS),
                     ("eps_root", EPS_ROOT), ("learning_rate", self.lr)):
            out[f"[1].hyperparams['{k}']"] = np.asarray(v, np.float32)
        return out

    def load_jax(self, leaves: Dict[str, np.ndarray]) -> None:
        """Take the state `state_to_jax` (or the JAX package) wrote."""
        self.count = int(leaves[f"{_ADAM}count"])
        self.lr = float(leaves["[1].hyperparams['learning_rate']"])
        by_name = {top: dict(m.named_parameters())
                   for top, m in self.modules.items()}
        state: Dict[torch.nn.Parameter, dict] = {}
        for kind, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            prefix = f"{_ADAM}{kind}"
            for k, arr in leaves.items():
                if not k.startswith(prefix):
                    continue
                top, *path = parse_keystr(k[len(prefix):])
                name, arr = _torch_leaf(tuple(path), np.asarray(arr,
                                                                np.float32))
                p = by_name[top][name]
                if tuple(arr.shape) != tuple(p.shape):
                    raise ValueError(f"{k}: shape {arr.shape} does not fit "
                                     f"{top}.{name} {tuple(p.shape)}")
                state.setdefault(p, {})[key] = torch.from_numpy(
                    np.array(arr)).to(p)
        missing = [p for p in self.params if len(state.get(p, {})) != 2]
        if missing:
            raise ValueError(f"optimizer state misses {len(missing)} "
                             "parameters' moments")
        for p, st in state.items():
            self.adam.state[p] = {"step": torch.tensor(float(self.count)),
                                  **st}


def make_optimizer(cfg: TrainConfig,
                   params: Dict[str, torch.nn.Module]) -> Optimizer:
    return Optimizer(params, cfg)


@torch.no_grad()
def ema_update(ema: Dict[str, torch.nn.Module],
               params: Dict[str, torch.nn.Module], decay: float) -> None:
    """One EMA step in place, ema <- ema*d + params*(1-d), in that order and
    in float32 as the JAX package writes it (not torch.lerp, which rounds
    otherwise)."""
    d = torch.tensor(decay, dtype=torch.float32)
    e = [t for m in ema.values() for t in m.parameters()]
    p = [t for m in params.values() for t in m.parameters()]
    scaled = torch._foreach_mul(p, (1.0 - d).item())
    torch._foreach_mul_(e, d.item())
    torch._foreach_add_(e, scaled)


def _bf16_then(dtype: Optional[torch.dtype]):
    def cast(p):
        p = p.to(torch.bfloat16)
        return p if dtype is None else p.to(dtype)
    return cast


class _Cast:
    """Call `module` with each parameter replaced by `cast(p)`, a
    differentiable copy, so gradients flow back to the fp32 masters."""

    def __init__(self, module: torch.nn.Module, cast):
        self.module, self.cast = module, cast

    def __call__(self, *args):
        return torch.func.functional_call(
            self.module, {n: self.cast(p)
                          for n, p in self.module.named_parameters()}, args)


def amp_params(params: Dict[str, torch.nn.Module]) -> Dict[str, _Cast]:
    """The policy's modules as the JAX package's amp loss sees them: every
    parameter rounded to bf16. The batch is bf16 too, but the noised vector
    the U-Net gets is f32 (add_noise multiplies by the f32 schedule), and
    flax promotes a bf16 kernel to f32 against an f32 input: the JAX amp
    U-Net computes in f32 with bf16-rounded weights (its lowered loss has
    348 f32 and 1 bf16 dot_general at width 8), and only the encoder, fed
    bf16 frames, computes in bf16. The port's layers compute in their
    parameters' dtype, so the U-Net's casts go to bf16 and back to f32."""
    return {name: _Cast(mod, _bf16_then(None if name == "encoder"
                                        else torch.float32))
            for name, mod in params.items()}


def make_train_step(policy: DiffusionPolicy, params, optimizer: Optimizer,
                    amp: bool = False, ema=None, ema_decay: float = 0.0,
                    mesh=None):
    """step(batch, lr, generator=None, t=None, noise=None) -> loss: one
    optimizer step in place on `params` (and `ema` when ema_decay > 0).
    With amp the batch and the params are cast to bf16 for the forward and
    backward (`amp_params`) and the loss is f32; the optimizer keeps the
    fp32 masters. With a mesh, the gradients are averaged over its ranks
    (one flat all_reduce) before the optimizer clips them. The loss (this
    rank's) stays on the device."""

    def step(batch, lr: float, generator=None, t=None, noise=None):
        mods = params
        if amp:
            batch = {k: v.to(torch.bfloat16) if v.dtype == torch.float32
                     else v for k, v in batch.items()}
            mods = amp_params(params)
        optimizer.zero_grad()
        loss = policy.loss(mods, batch, generator, t=t, noise=noise)
        loss.backward()
        if mesh is not None:
            all_reduce_mean_([p.grad for p in optimizer.params
                              if p.grad is not None], mesh)
        optimizer.step(lr)
        if ema is not None and ema_decay > 0.0:
            ema_update(ema, params, ema_decay)
        return loss.detach()

    return step


def make_eval_step(policy: DiffusionPolicy):
    @torch.no_grad()
    def step(params, batch, generator=None, t=None, noise=None):
        return policy.loss(params, batch, generator, t=t, noise=noise)
    return step


class _AsyncSaver:
    """Runs checkpoint writes off the training thread, one in flight.
    Worker exceptions re-raise on the next submit/wait so a failed
    checkpoint cannot pass silently. What it writes is a host snapshot
    taken before the submit: the next steps update the params in place."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _run(self, fn, args):
        try:
            fn(*args)
        except BaseException as e:  # noqa: BLE001 - re-raised on the caller
            self._error = e

    def submit(self, fn, *args):
        self.wait()
        self._thread = threading.Thread(
            target=self._run, args=(fn, args), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _index_chunks(order: np.ndarray, bs: int, drop_last: bool) -> np.ndarray:
    """(K, bs) window-index array; a partial tail repeat-padded (constant
    batch shapes) or dropped."""
    n_full = len(order) // bs
    rem = len(order) - n_full * bs
    chunks = order[:n_full * bs].reshape(n_full, bs)
    if rem and not drop_last:
        tail = np.concatenate(
            [order[n_full * bs:], np.repeat(order[-1:], bs - rem)])
        chunks = np.concatenate([chunks, tail[None]], 0)
    return chunks


@dataclasses.dataclass
class Trainer:
    policy: DiffusionPolicy
    config: TrainConfig
    out_dir: str
    mesh: Optional[Any] = None   # default: parallel.make_mesh()

    def __post_init__(self):
        self.device = self.policy.device
        if self.mesh is None:
            self.mesh = make_mesh(self.device)
        if self.mesh.device != self.device:
            raise ValueError(f"the policy lies on {self.device}, the mesh's "
                             f"rank on {self.mesh.device}")
        ws = self.mesh.world_size
        if self.config.device_data and self.config.batch_size % ws:
            # fail at construction, not mid-training
            raise ValueError(
                f"device_data needs batch_size ({self.config.batch_size}) "
                f"divisible by the world size ({ws})")
        self.is_main = self.mesh.is_main
        self.eval_step = make_eval_step(self.policy)
        self._saver = _AsyncSaver()
        self._dev_ds = None
        if self.is_main:
            os.makedirs(self.out_dir, exist_ok=True)
        self.metrics_path = os.path.join(self.out_dir, "metrics.jsonl")
        self._tb = None
        if self.config.tensorboard and self.is_main:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                print("--tensorboard: the tensorboard package is not "
                      "installed here; scalars go to metrics.jsonl only")
            else:
                self._tb = SummaryWriter(self.out_dir, flush_secs=1)

    def _log(self, record: Dict[str, Any]):
        if not self.is_main:
            return
        record["time"] = time.time()
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._tb is not None:
            # the JAX trainer's tags, at the record's step (or epoch)
            step = int(record.get("step", record.get("epoch", 0) or 0))
            for key, tag in (("loss", "train_loss"), ("val_loss", "val_loss"),
                             ("lr", "lr"), ("train_loss", "epoch_train_loss"),
                             ("steps_per_sec", "steps_per_sec")):
                if key in record:
                    self._tb.add_scalar(tag, float(record[key]), step)

    def _device_ds(self, dm: DataModule) -> DeviceWindowDataset:
        """The device twin, built per DataModule (a second fit() with
        another DataModule must not train on the first one's arrays)."""
        if self._dev_ds is None or self._dev_ds[0] is not dm:
            self._dev_ds = (dm, DeviceWindowDataset(dm.data_full,
                                                    self.device))
        return self._dev_ds[1]

    def _batch(self, dm: DataModule, idx: np.ndarray, gen):
        """(this rank's rows of one global batch on the device, its t, its
        noise). The global batch of windows `idx` is padded to a multiple
        of the world size (repeat-last) and split over the ranks; t and
        the noise are drawn from `gen` at the padded global batch's shape,
        the rank keeping its rows. The windows are gathered on the device
        with device_data, else on the host and copied. Only the image
        frames the conditioning reads are gathered."""
        idx, _ = pad_to_multiple(np.asarray(idx), self.mesh.world_size)
        t, noise = shard_batch(self.policy.draw_t_noise(len(idx), gen),
                               self.mesh)
        idx = shard_batch(idx, self.mesh)
        n_img = self.policy.config.obs_horizon
        if self.config.device_data:
            return (self._device_ds(dm).batch(idx, image_frames=n_img), t,
                    noise)
        batch = dm.data_full.batch(idx, image_frames=n_img)
        return ({k: torch.from_numpy(v).to(self.device)
                 for k, v in batch.items()}, t, noise)

    def _validate(self, params, dm: DataModule, gen) -> float:
        """Mean val loss: the val windows in batches (repeat-padded to full
        batches with device_data, as the JAX fused path pads them), each
        batch's loss averaged over the ranks, read back once."""
        bs = self.config.batch_size
        idx = np.asarray(dm.val_idx)
        if self.config.device_data:
            chunks = list(_index_chunks(idx, bs, False))
        else:
            chunks = [idx[i:i + bs] for i in range(0, len(idx), bs)]
        if not chunks:
            return float("nan")
        losses = []
        for c in chunks:
            batch, t, noise = self._batch(dm, c, gen)
            losses.append(self.eval_step(params, batch, t=t, noise=noise))
        return float(mean_over_ranks(torch.stack(losses), self.mesh).mean())

    def fit(self, dm: DataModule, params: Optional[Dict] = None,
            sample_hook=None, resume: bool = False) -> Dict:
        cfg = self.config
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        if params is None:
            params = self.policy.init_params(
                torch.Generator().manual_seed(cfg.seed))
        replicate(params, self.mesh)
        optimizer = make_optimizer(cfg, params)
        ema_on = cfg.ema_decay > 0.0
        # EMA starts as a copy of the initial params
        ema = copy.deepcopy(params) if ema_on else None

        plateau = ReduceLROnPlateau(lr=cfg.lr, min_lr=cfg.min_lr)
        lr = cfg.lr
        start_epoch = resume_wait = resume_step = 0
        if resume:
            latest = ckpt_lib.latest_checkpoint(self.out_dir)
            state = ckpt_lib.load_train_state(self.out_dir)
            if latest is not None and state is not None:
                ckpt_lib.load_checkpoint(latest, params)
                if ema_on:
                    latest_ema = ckpt_lib.latest_checkpoint(
                        self.out_dir, subdir="checkpoints_ema")
                    ema = (ckpt_lib.load_checkpoint(latest_ema, ema)
                           if latest_ema is not None
                           else copy.deepcopy(params))
                leaves, meta = state
                optimizer.load_jax(leaves)
                start_epoch = int(meta["epoch"]) + 1
                lr = (_cosine_lr(cfg, start_epoch)
                      if cfg.lr_schedule == "cosine" else float(meta["lr"]))
                plateau = ReduceLROnPlateau(
                    lr=lr, min_lr=cfg.min_lr,
                    best=float(meta.get("best_val", np.inf)),
                    num_bad=int(meta.get("num_bad", 0)))
                resume_wait = int(meta.get("es_wait", 0))
                resume_step = int(meta.get("step", 0))
                self._log({"event": "resume", "epoch": start_epoch, "lr": lr,
                           "step": resume_step})
        train_step = make_train_step(self.policy, params, optimizer, cfg.amp,
                                     ema, cfg.ema_decay, self.mesh)
        host_rng = np.random.default_rng(cfg.seed + start_epoch)

        # pre-fit validation materializes the run dir + stats sidecar
        val_loss = self._validate(params, dm, gen)
        if self.is_main:
            dm.save_stats(os.path.join(self.out_dir, "STATS.pkl"))
            ckpt_lib.save_hparams(self.out_dir, self.policy.config, cfg)
        self._log({"event": "pre_val", "val_loss": val_loss})

        n_train_batches = max(1, len(dm.train_idx) // cfg.batch_size)
        step_idx = resume_step or start_epoch * n_train_batches
        val_every = max(1, int(n_train_batches * cfg.val_interval))
        history = {"train_loss": [], "val_loss": []}
        stop = False
        es_patience = max(1, cfg.epochs // 10)
        best_lr, wait = float("inf"), resume_wait
        last_val = float("nan")
        # seeded from an existing insurance snapshot, so a resumed run does
        # not overwrite a better best with its first finite val loss
        best_insured = float("inf")
        if cfg.insurance_dir:
            bj = os.path.join(cfg.insurance_dir, "BEST.json")
            if os.path.exists(bj):
                try:
                    with open(bj) as f:
                        prev = json.load(f)
                    ck = os.path.join(cfg.insurance_dir, "checkpoints",
                                      f"epoch={prev['epoch']}", "params.npz")
                    if os.path.exists(ck):
                        best_insured = float(prev["val_loss"])
                        self._log({"event": "insurance_seed",
                                   "val_loss": best_insured,
                                   "epoch": int(prev["epoch"])})
                except (ValueError, KeyError, OSError):
                    pass  # corrupt sidecar: treat as no prior best

        def after_val(step_idx, val_loss):
            """Quarter-epoch validation: log + sample hook only; the lr
            schedule steps once per epoch (after_epoch)."""
            nonlocal last_val
            last_val = val_loss
            history["val_loss"].append(val_loss)
            self._log({"event": "val", "step": step_idx,
                       "val_loss": val_loss, "lr": lr})
            if sample_hook is not None and self.is_main:
                sample_hook(params, step_idx)

        def after_epoch(epoch):
            """Per-epoch plateau + early-stop step (Lightning cadence)."""
            nonlocal lr, best_lr, wait, stop
            if cfg.lr_schedule == "cosine":
                lr = _cosine_lr(cfg, epoch + 1)
                self._log({"event": "lr_epoch", "epoch": epoch, "lr": lr,
                           "val_loss": last_val})
                return
            if np.isnan(last_val):
                return
            lr = plateau.update(last_val)
            self._log({"event": "lr_epoch", "epoch": epoch, "lr": lr,
                       "val_loss": last_val, "bad_epochs": plateau.num_bad})
            if lr < best_lr:
                best_lr, wait = lr, 0
            else:
                wait += 1
            if cfg.early_stop and (
                    should_early_stop(lr) or wait >= es_patience):
                self._log({"event": "early_stop", "lr": lr, "wait": wait})
                stop = True

        for epoch in range(start_epoch, cfg.epochs):
            if stop:
                break
            t0 = time.time()
            epoch_losses = []
            order = host_rng.permutation(np.asarray(dm.train_idx))
            batches = _index_chunks(order, cfg.batch_size, True)
            for c0 in range(0, len(batches), val_every):
                losses = []
                for idx in batches[c0:c0 + val_every]:
                    batch, t, noise = self._batch(dm, idx, gen)
                    losses.append(train_step(batch, lr, t=t, noise=noise))
                # the mean over the ranks, read once
                losses = mean_over_ranks(torch.stack(losses),
                                         self.mesh).cpu().numpy()
                epoch_losses.extend(np.float32(v) for v in losses)
                for i, v in enumerate(losses):
                    if (step_idx + i + 1) % cfg.log_every == 0:
                        self._log({"event": "train",
                                   "step": step_idx + i + 1,
                                   "epoch": epoch, "loss": float(v),
                                   "lr": lr})
                step_idx += len(losses)
                if len(losses) == val_every:
                    after_val(step_idx, self._validate(params, dm, gen))

            after_epoch(epoch)
            history["train_loss"].append(
                float(np.mean(epoch_losses)) if epoch_losses
                else float("nan"))
            improved = (np.isfinite(last_val)
                        and last_val < best_insured - 1e-12)
            if improved:
                best_insured = last_val
            # host snapshots: the next steps update the modules in place
            save_ema = ema is not None and (epoch % 5 == 4
                                            or epoch >= cfg.epochs - 1)
            insure = improved and cfg.insurance_dir
            if self.is_main:
                snap_p = params_to_jax(params)
                snap_e = (params_to_jax(ema) if ema is not None
                          and (save_ema or insure) else None)
                self._saver.submit(self._save_epoch, snap_p, snap_e,
                                   save_ema, optimizer.state_to_jax(), epoch,
                                   float(lr), float(plateau.best),
                                   int(plateau.num_bad), int(wait),
                                   int(step_idx),
                                   last_val if improved else None)
            dt = time.time() - t0
            self._log({"event": "epoch", "epoch": epoch,
                       "train_loss": history["train_loss"][-1],
                       "seconds": dt,
                       "steps_per_sec": len(epoch_losses) / max(dt, 1e-9),
                       "samples_per_sec":
                           len(epoch_losses) * cfg.batch_size / max(dt, 1e-9)})

        self._saver.wait()
        if self._tb is not None:
            self._tb.flush()
        barrier(self.mesh)
        return {"params": params, "ema": ema, "optimizer": optimizer,
                "history": history, "lr": lr, "step": step_idx}

    def _save_epoch(self, params, ema, save_ema: bool, opt_leaves,
                    epoch: int, lr: float, best_val: float, num_bad: int = 0,
                    es_wait: int = 0, step: int = 0,
                    improved_val: Optional[float] = None):
        ckpt_lib.save_checkpoint(self.out_dir, params, epoch)
        if save_ema:
            # the full-precision EMA persists every 5th epoch and at the
            # end, as in the JAX package; the insurance snapshot tracks the
            # best EMA continuously
            ckpt_lib.save_checkpoint(self.out_dir, ema, epoch,
                                     subdir="checkpoints_ema")
        ckpt_lib.save_train_state(self.out_dir, opt_leaves, {
            "epoch": epoch, "lr": lr, "best_val": best_val,
            "num_bad": num_bad, "es_wait": es_wait, "step": step})
        if improved_val is not None and self.config.insurance_dir:
            self._save_insurance(ema if ema is not None else params,
                                 epoch, improved_val)

    def _save_insurance(self, leaves, epoch: int, val_loss: float):
        """fp16 snapshot of the current best params outside the run dir,
        with hparams/STATS; staged in a temp dir and renamed, BEST.json
        pointed at it, superseded epochs pruned last, so BEST.json always
        names a checkpoint that exists."""
        d = self.config.insurance_dir
        root = os.path.join(d, "checkpoints")
        tmp = os.path.join(root, f".tmp-epoch={epoch}")
        shutil.rmtree(tmp, ignore_errors=True)
        ckpt_lib.save_npz(os.path.join(tmp, "params.npz"), leaves,
                          np.float16)
        final = os.path.join(root, f"epoch={epoch}")
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        for side in ("hparams.yaml", "STATS.pkl"):
            src = os.path.join(self.out_dir, side)
            if os.path.exists(src):
                shutil.copy2(src, os.path.join(d, side))
        bj_tmp = os.path.join(d, ".BEST.json.tmp")
        with open(bj_tmp, "w") as f:
            json.dump({"epoch": epoch, "val_loss": float(val_loss),
                       "ema": self.config.ema_decay > 0.0}, f)
        os.replace(bj_tmp, os.path.join(d, "BEST.json"))
        for name in os.listdir(root):
            if name.startswith("epoch=") and name != f"epoch={epoch}":
                shutil.rmtree(os.path.join(root, name), ignore_errors=True)
