"""Eval-time action prediction: deterministic flow integration + unnormalize.

Port of vla_rft_tpu/workers/predict.py (and `encode_context`, the one-line
VLM forward of workers/flow_actor.py): ONE VLM context forward, then K
deterministic Euler steps of the flow head from Gaussian noise, then
unnormalization from dataset statistics and the gripper post-processing.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vla_rft_tpu_torch.models.action_head import ActionExpert
from vla_rft_tpu_torch.models.prismatic import OpenVLA


def encode_context(vla: OpenVLA, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The single multimodal VLM forward shared by rollout and replay."""
    return vla.encode_context(
        batch["input_ids"], batch["pixels"], batch["labels"], batch["attention_mask"]
    )


@torch.no_grad()
def predict_action(
    vla: OpenVLA,
    expert: ActionExpert,
    batch: Dict[str, torch.Tensor],
    num_flow_steps: int = 10,
    *,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Deterministic Euler integration x += dt * flow from noise.

    batch: input_ids/pixels/labels/attention_mask/proprio on one device.
    noise: the (B, chunk, action_dim) start point; drawn from `generator`
    (as f32, rounded to bf16 like the reference) when not given.  Returns
    the normalized actions (B, chunk, action_dim) in bf16."""
    hidden = encode_context(vla, batch)
    cfg = expert.cfg
    B = batch["input_ids"].shape[0]
    dev = hidden.device
    if noise is None:
        noise = torch.randn(
            (B, cfg.num_actions_chunk, cfg.action_dim), generator=generator,
            device=dev, dtype=torch.float32,
        )
    x = noise.to(device=dev, dtype=torch.bfloat16)
    K = num_flow_steps
    dt = torch.tensor(-1.0 / K, dtype=x.dtype, device=dev)
    for k in range(K):
        t = torch.full((B,), k / K, dtype=torch.float32, device=dev)
        flow = expert.predict_flow(hidden, x, t, batch["proprio"])
        x = x + dt * flow.to(x.dtype)
    return x


def unnormalize_actions(
    normalized_actions: np.ndarray,
    norm_stats: Dict[str, np.ndarray],
    normalization_type: str = "bounds_q99",
) -> np.ndarray:
    """modeling_prismatic._unnormalize_actions."""
    if normalization_type == "bounds":
        high, low = np.asarray(norm_stats["max"]), np.asarray(norm_stats["min"])
        mask = np.asarray(norm_stats.get("mask", np.ones_like(low, bool)), bool)
    elif normalization_type == "bounds_q99":
        high, low = np.asarray(norm_stats["q99"]), np.asarray(norm_stats["q01"])
        mask = np.asarray(norm_stats.get("mask", np.ones_like(low, bool)), bool)
    else:
        raise ValueError(f"Unsupported normalization: {normalization_type}")
    return np.where(
        mask,
        0.5 * (normalized_actions + 1) * (high - low + 1e-8) + low,
        normalized_actions,
    )


def normalize_gripper_action(action: np.ndarray, binarize: bool = True) -> np.ndarray:
    """robot_utils.normalize_gripper_action: [0,1] -> [-1,+1], optional sign."""
    action = np.asarray(action).copy()
    action[..., -1] = 2 * (action[..., -1] - 0.0) / (1.0 - 0.0) - 1
    if binarize:
        action[..., -1] = np.sign(action[..., -1])
    return action


def invert_gripper_action(action: np.ndarray) -> np.ndarray:
    """robot_utils.invert_gripper_action: LIBERO uses -1 = open, +1 = close."""
    action = np.asarray(action).copy()
    action[..., -1] = action[..., -1] * -1.0
    return action
