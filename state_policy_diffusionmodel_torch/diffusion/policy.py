"""The conditioned diffusion policy: DDPM / DDIM / DPM-Solver++ samplers.

Counterpart of `state_policy_diffusionmodel_tpu/diffusion/policy.py`. The
config and the sampling semantics are the same:
- conditioning vector = concat(position, action, velocity, image features)
  over the observation horizon;
- prediction vector = concat(position, action), with the last
  `inpaint_horizon` observation steps prepended and overwritten after every
  reverse step;
- samplers start from UNIFORM [0, 1) noise unless `uniform_init=False`.

`params` is the dict of loaded modules {'unet': UNetFiLM or UNetSimple,
'encoder': Encoder or ResNet18GN} (see `params_from_jax.py`). x_T comes
from an explicit `torch.Generator` or from `init_noise`; the JAX package's
threefry draws cannot be reproduced in torch, so `loss` draws t and the
noise from an explicit generator too, or takes them as arguments.
`init_params` builds fresh modules with flax's initializers by
distribution.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..models import Encoder, ResNet18GN, build_model
from ..models.layers import ConvTranspose
from ..params_from_jax import encoder_from_jax
from . import schedules as S


# vision_encoder -> the encoder's module; "none" has none
ENCODERS = {"autoencoder": Encoder, "resnet18": ResNet18GN}
RESNET_FEATURES = 512


@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    """Hyperparameters (defaults = the reference's train.py)."""

    noise_steps: int = 1000
    obs_horizon: int = 10
    pred_horizon: int = 30
    inpaint_horizon: int = 1
    prediction_dim: int = 5          # 2 pos + 3 action
    model: str = "UNet_Film"
    noise_scheduler_type: str = "linear"
    step_size: int = 5
    time_dim: int = 256
    vision_encoder: str = "autoencoder"   # autoencoder | resnet18 | none
    vision_latent: int = 128
    uniform_init: bool = True        # reference torch.rand sampler init
    train_encoder: bool = False      # reference freezes the AE encoder
    model_width: Optional[int] = None  # U-Net base channels (None = ref plan)

    @property
    def state_cond_dim(self) -> int:
        return 2 + 3 + 2             # position + action + velocity

    @property
    def observation_dim(self) -> int:
        return self.state_cond_dim + self.feature_dim

    @property
    def feature_dim(self) -> int:
        """The width of the features the encoder emits (0 without one)."""
        return {"autoencoder": self.vision_latent,
                "resnet18": RESNET_FEATURES}.get(self.vision_encoder, 0)

    @property
    def horizon(self) -> int:
        return self.pred_horizon + self.inpaint_horizon

    @property
    def has_encoder(self) -> bool:
        return self.vision_encoder in ENCODERS


def cast_params(params: Dict[str, torch.nn.Module],
                dtype: torch.dtype) -> Dict[str, torch.nn.Module]:
    """Modules in `dtype`: those already in it as they are, others copied."""
    out = {}
    for name, mod in params.items():
        p = next(mod.parameters())
        out[name] = mod if p.dtype == dtype else copy.deepcopy(mod).to(dtype)
    return out


def _draw(fn, shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    device = generator.device if generator is not None else "cpu"
    return fn(shape, generator=generator, device=device)


# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides by it, so the truncated draw has variance 1
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default kernel init, `lecun_normal`: a normal truncated at two
    standard deviations with variance 1/fan_in. Every weight of the port
    keeps its input features in dims 1.. (OIHW convs, (out, in) dense and
    attention weights), so fan_in is one output row's size, as flax counts
    it on the HWIO / (in, out) / DenseGeneral kernels."""
    std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
    with torch.no_grad():
        torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                    generator=generator)


def init_module_(module: torch.nn.Module, generator: torch.Generator):
    """flax's initializers on every parameter, by name: kernels and weights
    `lecun_normal`, biases zeros, norm scales ones (nn.Dense, nn.Conv,
    nn.ConvTranspose, nn.DenseGeneral, nn.LayerNorm, nn.GroupNorm and
    DoubleConv's own params). A transposed conv's weight is (in, out, kh,
    kw), and flax counts its fan_in as in * kh * kw, as on its HWIO kernel."""
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path))
        if leaf == "weight" and isinstance(owner, ConvTranspose):
            lecun_normal_(p.transpose(0, 1), generator)
        elif leaf == "weight" or leaf.endswith("kernel"):
            lecun_normal_(p, generator)
        elif "scale" in leaf:
            torch.nn.init.ones_(p)
        elif "bias" in leaf:
            torch.nn.init.zeros_(p)
        else:
            raise ValueError(f"no flax initializer known for {name}")
    return module


def make_encoder(config: PolicyConfig) -> torch.nn.Module:
    """A fresh (uninitialised) encoder of the config's kind."""
    if config.vision_encoder == "resnet18":
        return ResNet18GN()
    return Encoder(config.vision_latent)


class DiffusionPolicy:
    def __init__(self, config: PolicyConfig, device="cuda"):
        if config.vision_encoder not in (*ENCODERS, "none"):
            raise ValueError(
                f"unknown vision encoder {config.vision_encoder!r}")
        self.config = config
        self.device = resolve_device(device)
        self.schedule = S.make_schedule(
            config.noise_steps, config.noise_scheduler_type, self.device)

    # -- params -------------------------------------------------------------
    def init_params(self, generator: torch.Generator,
                    encoder_params=None) -> Dict[str, torch.nn.Module]:
        """Fresh {'unet', 'encoder'} modules on the policy's device, drawn
        on the CPU from `generator` with flax's initializers
        (`DiffusionPolicy.init_params`). encoder_params: a pretrained
        encoder module, or its flax parameter tree, in place of a fresh
        one."""
        cfg = self.config
        cond_dim = cfg.obs_horizon * cfg.observation_dim
        unet = build_model(cfg.model, cond_dim, out_channels=1,
                           time_dim=cfg.time_dim, width=cfg.model_width)
        params = {"unet": init_module_(unet, generator).to(self.device)}
        if cfg.has_encoder:
            if encoder_params is None:
                enc = init_module_(make_encoder(cfg), generator)
            elif isinstance(encoder_params, torch.nn.Module):
                enc = encoder_params
            else:
                enc = encoder_from_jax(encoder_params, "cpu")
            if not isinstance(enc, ENCODERS[cfg.vision_encoder]):
                raise ValueError(f"a {type(enc).__name__} is not a "
                                 f"{cfg.vision_encoder!r} encoder")
            params["encoder"] = enc.to(self.device)
        return params

    # -- conditioning -------------------------------------------------------
    def encode_images(self, params, images: torch.Tensor) -> torch.Tensor:
        """(B, T, 96, 96, 3) -> (B, T, latent)."""
        B, T = images.shape[:2]
        feats = params["encoder"](images.reshape(B * T, *images.shape[2:]))
        return feats.reshape(B, T, -1)

    def obs_cond(self, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, T_obs * obs_dim): position, action, velocity, image features
        (precomputed `image_features`, or `image` encoded here). Unless
        `train_encoder`, the features carry no gradient (the JAX package's
        stop_gradient) and the encoder runs under no_grad."""
        cfg = self.config
        T = cfg.obs_horizon
        parts = [batch["position"][:, :T], batch["action"][:, :T],
                 batch["velocity"][:, :T]]
        if cfg.has_encoder:
            if "image_features" in batch:
                feats = batch["image_features"][:, :T]
            else:
                with torch.set_grad_enabled(torch.is_grad_enabled()
                                            and cfg.train_encoder):
                    feats = self.encode_images(params, batch["image"][:, :T])
            parts.append(feats if cfg.train_encoder else feats.detach())
        cond = torch.cat(parts, dim=-1)
        return cond.reshape(cond.shape[0], -1)

    # -- prediction / inpaint vectors --------------------------------------
    def prediction_vector(self, batch) -> torch.Tensor:
        """(B, pred_horizon, 5): positions + actions after the obs horizon."""
        T = self.config.obs_horizon
        return torch.cat([batch["position"][:, T:], batch["action"][:, T:]],
                         dim=-1)

    def inpaint_vector(self, batch) -> torch.Tensor:
        """(B, inpaint_horizon, 5): the last observation steps."""
        T, I = self.config.obs_horizon, self.config.inpaint_horizon
        return torch.cat([batch["position"][:, T - I:T],
                          batch["action"][:, T - I:T]], dim=-1)

    def _constrain(self, x: torch.Tensor, inpaint: torch.Tensor) -> torch.Tensor:
        """Overwrite the first inpaint_horizon rows."""
        return torch.cat([inpaint.to(x.dtype),
                          x[:, self.config.inpaint_horizon:]], dim=1)

    # -- training loss ------------------------------------------------------
    def loss(self, params, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             t: Optional[torch.Tensor] = None,
             noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The denoising loss (`DiffusionPolicy.loss`): the inpaint rows and
        the prediction noised to t by `add_noise`, the inpaint rows written
        back, and the f32 MSE of the U-Net's eps against the noise over the
        whole vector. t (B,) and noise (B, horizon, 5) are drawn from
        `generator` (on its device) unless given; the noise is rounded to
        the batch's dtype, as JAX draws it in that dtype."""
        cfg = self.config
        cond = self.obs_cond(params, batch)
        inpaint = self.inpaint_vector(batch)
        vec = torch.cat([inpaint, self.prediction_vector(batch)], dim=1)
        B = vec.shape[0]
        if t is None:
            t = self._draw_t(B, generator)
        if noise is None:
            noise = _draw(torch.randn, tuple(vec.shape), generator)
        t = t.to(vec.device)
        noise = noise.to(device=vec.device, dtype=vec.dtype)
        x_noisy = self._constrain(S.add_noise(self.schedule, vec, noise, t),
                                  inpaint)
        eps = params["unet"](x_noisy[..., None], t, cond)[..., 0]
        # the mean in f32 whatever the nets compute in
        return torch.mean((noise.float() - eps.float()) ** 2)

    def _draw_t(self, B: int, generator: Optional[torch.Generator]):
        return _draw(lambda shape, **kw: torch.randint(
            0, self.config.noise_steps, shape, **kw), (B,), generator)

    def draw_t_noise(self, B: int,
                     generator: Optional[torch.Generator] = None):
        """(t (B,), noise (B, horizon, prediction_dim)) drawn from
        `generator` as `loss` draws them when it is given neither."""
        cfg = self.config
        t = self._draw_t(B, generator)
        return t, _draw(torch.randn, (B, cfg.horizon, cfg.prediction_dim),
                        generator)

    # -- sampling -----------------------------------------------------------
    def init_noise(self, B: int, generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """x_T drawn on the generator's device, moved to the policy's."""
        cfg = self.config
        shape = (B, cfg.horizon, cfg.prediction_dim)
        draw = torch.rand if cfg.uniform_init else torch.randn
        return _draw(draw, shape, generator).to(self.device)

    @torch.no_grad()
    def sample(self, params, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               sampler: str = "ddpm",   # "ddpm" | "ddim" | "dpmpp"
               num_inference_steps: Optional[int] = None,
               history: bool = False, ddim_compat_100: bool = False,
               amp: bool = False, ddim_spacing: str = "leading",
               init_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Reverse diffusion conditioned on an observation-only batch.

        Returns (B, inpaint+pred, 5), or with history=True the whole
        (steps+1, B, inpaint+pred, 5) trajectory. amp=True runs the nets in
        bfloat16 (modules and batch cast, scheduler math f32). x_T is
        `init_noise` when given, else drawn from `generator` (on its
        device; a fresh CPU draw when None); ddpm also draws its per-step
        noise from `generator`."""
        cfg = self.config
        inpaint = self.inpaint_vector(batch).float()   # written verbatim
        if amp:
            params = cast_params(params, torch.bfloat16)
            batch = {k: v.to(torch.bfloat16) if v.dtype == torch.float32
                     else v for k, v in batch.items()}
        cond = self.obs_cond(params, batch)
        B = cond.shape[0]
        unet = params["unet"]
        in_dtype = torch.bfloat16 if amp else torch.float32

        x = self.init_noise(B, generator) if init_noise is None else init_noise
        x = self._constrain(x.float(), inpaint)

        def eps_at(x, t):
            t_b = torch.full((B,), int(t), device=x.device, dtype=torch.int64)
            return unet(x.to(in_dtype)[..., None], t_b, cond)[..., 0].float()

        hist = [x]
        if sampler == "ddpm":
            sched = self.schedule
            for t in range(cfg.noise_steps - 1, -1, -1):
                z = _draw(torch.randn, x.shape, generator).to(x.device)
                x = S.ddpm_step(sched, eps_at(x, t), t, x, z)
                x = self._constrain(x, inpaint)
                hist.append(x)
        elif sampler in ("ddim", "dpmpp"):
            n = num_inference_steps or 100
            if sampler == "ddim" and ddim_compat_100:
                # the reference generate.py: a fresh n-step schedule fed
                # t in [0, n) to a model trained on noise_steps
                sched = S.make_schedule(n, "linear", self.device)
                timesteps = np.arange(n - 1, -1, -1)
                prev_ts = timesteps - 1
            else:
                sched = self.schedule
                timesteps = S.ddim_timesteps(cfg.noise_steps, n, ddim_spacing)
                prev_ts = np.concatenate([timesteps[1:], [-1]])
            m_prev = torch.zeros_like(x)
            lam_prev = torch.zeros((), device=x.device)
            for i, (t, prev_t) in enumerate(zip(timesteps, prev_ts)):
                eps = eps_at(x, t)
                if sampler == "ddim":
                    x = S.ddim_step(sched, eps, int(t), int(prev_t), x)
                else:
                    # first step has no history; the last drops to first
                    # order (lower_order_final)
                    second = 1 <= i < n - 1
                    x, m_prev, lam_prev = S.dpmpp_2m_step(
                        sched, eps, int(t), int(prev_t), x, m_prev, lam_prev,
                        second)
                x = self._constrain(x, inpaint)
                hist.append(x)
        else:
            raise ValueError(sampler)
        return torch.stack(hist) if history else x
