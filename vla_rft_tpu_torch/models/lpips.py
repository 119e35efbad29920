"""LPIPS perceptual loss on VGG16 features.

Port of vla_rft_tpu/models/lpips.py (the reference's lpips.py: VGG16 taps
after relu1_2 .. relu5_3, unit-normalised over channels, squared
difference, learned 1x1 "lin" heads, spatial mean, sum over taps).  Public
inputs are channels-last (B, H, W, 3) in [-1, 1], as in the reference.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from vla_rft_tpu_torch.models.layers import Conv

# (channels, convs) per VGG16 stage; a feature tap after each stage
_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# lpips ScalingLayer constants
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        idx, prev = 0, 3
        for ch, n in _VGG_STAGES:
            for _ in range(n):
                self.add_module(f"conv{idx}", Conv(prev, ch, 3, padding=1, dtype=dtype))
                prev, idx = ch, idx + 1

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, 3, H, W) -> the five stage taps, NCHW."""
        feats, idx = [], 0
        for s, (_, n) in enumerate(_VGG_STAGES):
            for _ in range(n):
                x = F.relu(getattr(self, f"conv{idx}")(x))
                idx += 1
            feats.append(x)
            if s < len(_VGG_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return feats


class LPIPS(nn.Module):
    def __init__(self, dtype=torch.float32):
        super().__init__()
        self.vgg = VGG16Features(dtype)
        for i, (ch, _) in enumerate(_VGG_STAGES):
            self.add_module(f"lin{i}", Conv(ch, 1, 1, bias=False, dtype=dtype))
        self.register_buffer("shift", torch.tensor(_SHIFT), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE), persistent=False)

    def forward(self, real: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
        """real/pred (B, H, W, 3) in [-1, 1] -> per-sample loss (B,)."""
        f0 = self.vgg(((real - self.shift) / self.scale).permute(0, 3, 1, 2))
        f1 = self.vgg(((pred - self.shift) / self.scale).permute(0, 3, 1, 2))
        total = 0.0
        for i, (a, b) in enumerate(zip(f0, f1)):
            a = a / torch.sqrt((a * a).sum(dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt((b * b).sum(dim=1, keepdim=True) + 1e-10)
            total = total + getattr(self, f"lin{i}")((a - b) ** 2).mean(dim=(1, 2, 3))
        return total
