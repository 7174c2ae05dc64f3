"""The conditioned diffusion policy: the denoising loss and the DDIM
sampler.

Counterpart of `state_policy_diffusionmodel_tpu/diffusion/policy.py`. The
config and the semantics are the same:
- conditioning vector = concat(position, action, velocity, image features)
  over the observation horizon;
- prediction vector = concat(position, action), with the last
  `inpaint_horizon` observation steps prepended and overwritten after every
  reverse step.

`params` is the dict of loaded modules {'unet': UNetFiLM, 'encoder':
Encoder or ResNet18GN} (see `params_from_jax.py`). The loss takes its t
and noise, and the sampler its x_T, as arguments: the benchmark hands the
reference the program's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .. import resolve_device
from ..models import Encoder, ResNet18GN, build_model
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


class DiffusionPolicy:
    def __init__(self, config: PolicyConfig, device="cuda"):
        if config.vision_encoder not in (*ENCODERS, "none"):
            raise ValueError(
                f"unknown vision encoder {config.vision_encoder!r}")
        self.config = config
        self.device = resolve_device(device)
        self.schedule = S.make_schedule(
            config.noise_steps, config.noise_scheduler_type, self.device)

    def modules(self) -> Dict[str, torch.nn.Module]:
        """Fresh {'unet', 'encoder'} modules of the config's shapes on the
        policy's device, with torch's initial values (for counting
        operations, not for running the policy)."""
        cfg = self.config
        cond_dim = cfg.obs_horizon * cfg.observation_dim
        params = {"unet": build_model(cfg.model, cond_dim, out_channels=1,
                                      time_dim=cfg.time_dim,
                                      width=cfg.model_width)}
        if cfg.vision_encoder == "resnet18":
            params["encoder"] = ResNet18GN()
        elif cfg.has_encoder:
            params["encoder"] = Encoder(cfg.vision_latent)
        return {k: m.to(self.device) for k, m in params.items()}

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
    def loss(self, params, batch: Dict[str, torch.Tensor], t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
        """The denoising loss (`DiffusionPolicy.loss`): the inpaint rows and
        the prediction noised to t (B,) by `add_noise` with `noise` (B,
        horizon, 5), the inpaint rows written back, and the f32 MSE of the
        U-Net's eps against the noise over the whole vector."""
        cond = self.obs_cond(params, batch)
        inpaint = self.inpaint_vector(batch)
        vec = torch.cat([inpaint, self.prediction_vector(batch)], dim=1)
        t = t.to(vec.device)
        noise = noise.to(device=vec.device, dtype=vec.dtype)
        x_noisy = self._constrain(S.add_noise(self.schedule, vec, noise, t),
                                  inpaint)
        eps = params["unet"](x_noisy[..., None], t, cond)[..., 0]
        return torch.mean((noise.float() - eps.float()) ** 2)

    # -- sampling -----------------------------------------------------------
    @torch.no_grad()
    def sample(self, params, batch: Dict[str, torch.Tensor],
               init_noise: torch.Tensor,
               num_inference_steps: int) -> torch.Tensor:
        """DDIM (eta 0, clipped x0, leading spacing) from x_T = `init_noise`, conditioned on
        an observation-only batch, in float32. Returns (B, inpaint+pred,
        5)."""
        cfg = self.config
        inpaint = self.inpaint_vector(batch).float()   # written verbatim
        cond = self.obs_cond(params, batch)
        B = cond.shape[0]
        unet = params["unet"]
        x = self._constrain(init_noise.float(), inpaint)
        timesteps = S.ddim_timesteps(cfg.noise_steps, num_inference_steps)
        prev_ts = list(timesteps[1:]) + [-1]
        for t, prev_t in zip(timesteps, prev_ts):
            t_b = torch.full((B,), int(t), device=x.device,
                             dtype=torch.int64)
            eps = unet(x[..., None], t_b, cond)[..., 0].float()
            x = S.ddim_step(self.schedule, eps, int(t), int(prev_t), x)
            x = self._constrain(x, inpaint)
        return x
