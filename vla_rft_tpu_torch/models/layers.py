"""Flax-equivalent building blocks: Dense, Conv, LayerNorm, GroupNorm, Embed.

Flax modules keep parameters in `param_dtype` and compute in `dtype`: every
weight is cast to the compute dtype where it is used (`promote_dtype`).
These modules do the same, so a bf16-compute model with f32 parameters (the
action expert) or bf16 parameters (the VLM) behaves as the reference does.
Parameter names follow torch (`weight` (out, in), `bias`); `convert.py`
maps Flax trees onto them.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """nn.Dense / nn.DenseGeneral over a flattened input or output axis."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 dtype=torch.float32, param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features, dtype=param_dtype))
        self.bias = (
            nn.Parameter(torch.empty(out_features, dtype=param_dtype)) if bias else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.Module):
    """flax nn.LayerNorm: statistics in f32, output in `dtype` (or the
    input's dtype when None)."""

    def __init__(self, dim: int, *, eps: float = 1e-6, use_bias: bool = True,
                 use_scale: bool = True, dtype=None, param_dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(dim, dtype=param_dtype)) if use_scale else None
        self.bias = nn.Parameter(torch.empty(dim, dtype=param_dtype)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
        y = (xf - mean) * torch.rsqrt(var.clamp_min(0.0) + self.eps)
        if self.weight is not None:
            y = y * self.weight.float()
        if self.bias is not None:
            y = y + self.bias.float()
        return y.to(out_dtype)


class Embed(nn.Module):
    """nn.Embed: a (num, dim) table; lookups cast to `dtype` when given."""

    def __init__(self, num: int, dim: int, *, dtype: Optional[torch.dtype] = None,
                 param_dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(num, dim, dtype=param_dtype))

    def table(self) -> torch.Tensor:
        return self.weight if self.dtype is None else self.weight.to(self.dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        w = self.weight[ids]
        return w if self.dtype is None else w.to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding logits: x @ table^T in the compute dtype."""
        return x @ self.table().t()


class Conv(nn.Module):
    """nn.Conv over NCHW tensors: a (out, in, kh, kw) weight, symmetric
    integer padding, computed in `dtype` (Flax's NHWC kernels are transposed
    by convert.py)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, *, stride: int = 1,
                 padding: int = 0, bias: bool = True, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        self.dtype, self.stride, self.padding = dtype, stride, padding
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel, kernel, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(out_ch, dtype=param_dtype)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride, self.padding)


class GroupNorm(nn.Module):
    """flax nn.GroupNorm over NCHW tensors: statistics in f32 with Flax's
    fast variance E[x^2] - E[x]^2 (clipped at 0), output in `dtype`."""

    def __init__(self, groups: int, channels: int, *, eps: float = 1e-6, dtype=torch.float32,
                 param_dtype=torch.float32):
        super().__init__()
        self.groups, self.eps, self.dtype = groups, eps, dtype
        self.weight = nn.Parameter(torch.empty(channels, dtype=param_dtype))
        self.bias = nn.Parameter(torch.empty(channels, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        xf = x.float().reshape(B, self.groups, -1)
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(B, C, -1)
        y = y * self.weight.float()[:, None] + self.bias.float()[:, None]
        return y.reshape(x.shape).to(self.dtype)
