"""Finite Scalar Quantization (FSQ, arXiv:2309.15505).

Port of vla_rft_tpu/models/fsq.py: round a bounded latent onto a small
per-channel level grid; codes are normalised to [-1, 1] and flattened to
indices with a mixed-radix basis.  Channels-last over the last axis.
LIBERO's ctx_msp token space: levels [7, 5, 5, 5, 5] -> 4375 codes.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch


def get_fsq_levels(n: int) -> List[int]:
    return {
        8: [8, 6, 5],
        10: [8, 5, 5, 5],
        12: [7, 5, 5, 5, 5],
        14: [8, 8, 8, 6, 5],
        16: [8, 8, 8, 5, 5, 5],
    }[n]


class FSQ:
    """Stateless FSQ over the last axis (dim == len(levels))."""

    def __init__(self, levels: Sequence[int]):
        self.levels = np.asarray(levels, np.int32)
        self.basis = np.concatenate([[1], np.cumprod(self.levels[:-1])]).astype(np.int32)
        self.codebook_size = int(np.prod(self.levels))
        self.dim = len(levels)

    def _t(self, a, like: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=like.device)

    def bound(self, z: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
        levels = self._t(self.levels, z, z.dtype)
        half_l = (levels - 1) * (1 + eps) / 2
        offset = torch.where(self._t(self.levels % 2 == 0, z, torch.bool),
                             torch.full_like(levels, 0.5), torch.zeros_like(levels))
        shift = torch.atanh(offset / half_l)
        return torch.tanh(z + shift) * half_l - offset

    def quantize(self, z: torch.Tensor) -> torch.Tensor:
        """Rounded codes normalised to [-1, 1] (no gradient path: the port
        runs FSQ only at inference)."""
        rounded = torch.round(self.bound(z.float()))
        return (rounded / self._t(self.levels // 2, z)).to(z.dtype)

    def codes_to_indices(self, zhat: torch.Tensor) -> torch.Tensor:
        """Normalised codes (..., d) -> flat indices (...), int32."""
        half = self._t(self.levels // 2, zhat)
        scaled = zhat.float() * half + half
        return (torch.round(scaled) * self._t(self.basis, zhat)).sum(dim=-1).to(torch.int32)

    def indices_to_codes(self, indices: torch.Tensor) -> torch.Tensor:
        """Flat indices (...) -> normalised codes (..., d), f32."""
        idx = indices[..., None].to(torch.int32)
        level = torch.remainder(torch.div(idx, self._t(self.basis, idx, torch.int32),
                                          rounding_mode="floor"),
                                self._t(self.levels, idx, torch.int32))
        half = self._t(self.levels // 2, indices)
        return (level.float() - half) / half

    def __call__(self, z: torch.Tensor):
        codes = self.quantize(z)
        return codes, self.codes_to_indices(codes)
