"""PyTorch/CUDA port of vla_rft_tpu for NVIDIA Hopper (H100).

The JAX package `vla_rft_tpu` is the reference; this package mirrors its
module layout and imports only torch and numpy.  Every Pallas kernel of the
reference that a ported path runs becomes a hand-written CUDA kernel under
`csrc/`, built with nvcc at first use; each has a plain PyTorch twin that
runs for CPU tensors and serves as the reference on the card.

Entry points take `device="cuda"` by default and raise when CUDA is absent:
they never fall back to the CPU silently.  Pass `device="cpu"` to run the
plain twins on the CPU (the tests do).
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  A CUDA device must exist; the CPU
    is used only when the caller names it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev
