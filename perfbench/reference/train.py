"""The training step from its definition: the denoising loss, its
gradient, the global-norm clip at 0.5 (unchanged below the limit, else
g / |g| * 0.5), Adam with optax's constants (b1 0.9, b2 0.999, eps 1e-8,
bias-corrected moments) at a given learning rate, and the EMA
e <- e * d + p * (1 - d) of every parameter (kept in float64). Parameters that get no
gradient (a frozen encoder) keep their values."""

from __future__ import annotations

from typing import Dict

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class ReferenceTrainer:
    def __init__(self, policy, params: Dict[str, torch.nn.Module],
                 ema_decay: float):
        self.policy, self.params = policy, params
        self.names = [(top, n) for top, m in params.items()
                      for n, _ in m.named_parameters()]
        # the EMA in float64: what the EMA's definition gives, without the
        # round-off of a float32 sum whose change is 1 - d of the params'
        self.ema = {k: v.detach().double() for k, v in self.flat().items()}
        self.m: Dict[tuple, torch.Tensor] = {}
        self.v: Dict[tuple, torch.Tensor] = {}
        self.count = 0
        self.decay = ema_decay

    def flat(self) -> Dict[tuple, torch.nn.Parameter]:
        return {(top, n): p for top, m in self.params.items()
                for n, p in m.named_parameters()}

    def step(self, batch, lr: float, t, noise):
        """One step in place. Returns (loss, {leaf: clipped gradient})."""
        flat = self.flat()
        for p in flat.values():
            p.grad = None
        loss = self.policy.loss(self.params, batch, t=t, noise=noise)
        loss.backward()
        grads = {k: p.grad for k, p in flat.items() if p.grad is not None}
        norm = torch.sqrt(sum((g.double() ** 2).sum()
                              for g in grads.values()))
        scale = 1.0 if float(norm) < 0.5 else 0.5 / float(norm)
        grads = {k: g * scale for k, g in grads.items()}
        self.count += 1
        c1, c2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        with torch.no_grad():
            for k, g in grads.items():
                m = self.m.get(k, torch.zeros_like(g)) * B1 + (1 - B1) * g
                v = self.v.get(k, torch.zeros_like(g)) * B2 \
                    + (1 - B2) * g * g
                self.m[k], self.v[k] = m, v
                flat[k].sub_(lr * (m / c1) / (torch.sqrt(v / c2) + EPS))
            for k, p in flat.items():
                self.ema[k] = self.ema[k] * self.decay \
                    + p.detach().double() * (1 - self.decay)
        return float(loss.detach()), grads


def snapshot(params: Dict[str, torch.nn.Module]) -> Dict[tuple, torch.Tensor]:
    return {(top, n): p.detach().clone() for top, m in params.items()
            for n, p in m.named_parameters()}
