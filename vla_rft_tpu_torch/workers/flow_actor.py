"""The flow-matching policy actor (port of vla_rft_tpu/workers/flow_actor.py).

Only `encode_context` is ported so far: the single multimodal VLM forward
shared by serving, rollout, replay and the SFT trainers.  It is
differentiable (nothing here or in the modules below it turns autograd
off), so `VLAAdapterSFTTrainer` trains the VLM through it; callers that do
not train wrap it in `torch.no_grad()`.  The stochastic rollout, the
log-prob replay and the policy loss come with the GRPO slice.
"""
from __future__ import annotations

from typing import Dict

import torch

from vla_rft_tpu_torch.models.prismatic import OpenVLA


def encode_context(vla: OpenVLA, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The single multimodal VLM forward shared by rollout and replay:
    batch input_ids/pixels/labels/attention_mask -> the DiT's context
    (B, total_patches + num_tokens, llm_dim)."""
    return vla.encode_context(
        batch["input_ids"], batch["pixels"], batch["labels"], batch["attention_mask"]
    )
