"""ResNet-18 with GroupNorm, the alternative vision encoder, PyTorch, NHWC.

Counterpart of `state_policy_diffusionmodel_tpu/models/resnet.py`:
torchvision's resnet18 without its fc (a 512-wide output), every BatchNorm
replaced by GroupNorm(features // 16) with flax's semantics. The children
carry the names flax gives them (`Conv_0`, `GroupNorm_0`, `BasicBlock_0..7`;
inside a block `Conv_0..2`, `GroupNorm_0..2`, the third pair being the
projection of the residual), so a checkpoint's key paths name the torch
parameters. The convs have no bias and run as plain PyTorch convolutions,
as the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, GroupNorm


def _gn(features: int) -> GroupNorm:
    return GroupNorm(max(1, features // 16), features)


class BasicBlock(nn.Module):
    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.Conv_0 = Conv(in_features, features, 3, stride=strides,
                           padding=1, bias=False)
        self.GroupNorm_0 = _gn(features)
        self.Conv_1 = Conv(features, features, 3, padding=1, bias=False)
        self.GroupNorm_1 = _gn(features)
        if in_features != features or strides != 1:
            self.Conv_2 = Conv(in_features, features, 1, stride=strides,
                               bias=False)
            self.GroupNorm_2 = _gn(features)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        residual = x
        if hasattr(self, "Conv_2"):
            residual = self.GroupNorm_2(self.Conv_2(x))
        return F.relu(y + residual)


class ResNet18GN(nn.Module):
    """(B, H, W, 3) -> (B, 512)."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 channels: int = 3):
        super().__init__()
        self.Conv_0 = Conv(channels, 64, 7, stride=2, padding=3, bias=False)
        self.GroupNorm_0 = _gn(64)
        i_block, cin = 0, 64
        for i, blocks in enumerate(stage_sizes):
            features = 64 * 2 ** i
            for b in range(blocks):
                strides = 2 if i > 0 and b == 0 else 1
                setattr(self, f"BasicBlock_{i_block}",
                        BasicBlock(cin, features, strides))
                i_block, cin = i_block + 1, features
        self.n_blocks = i_block

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        # 3x3 / stride 2, padded by one with -inf (flax nn.max_pool)
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, stride=2,
                         padding=1).permute(0, 2, 3, 1)
        for i in range(self.n_blocks):
            x = getattr(self, f"BasicBlock_{i}")(x)
        return x.mean((1, 2))                 # global average pool
