"""CLI entry point for supervised fine-tuning (port of vla_rft_tpu/trainer/main_sft.py).

Selected by sft.mode, with the reference's dotted overrides and defaults:

  vla_flow     flow-matching behaviour cloning of the action expert on
               synthetic LIBERO-shaped data; the VLM stays frozen and each
               batch's context is encoded once, without gradients
  vla_adapter  the same loss with the VLM trained too (VLA-Adapter's
               finetune stage; sft.vlm_lr, sft.freeze_vision_backbone,
               sft.freeze_llm)

`text` (needs an HF tokenizer and a parquet dataset) and `vla_align` (needs
`OpenVLA.lm_forward`) are not ported yet and raise.  Weights are seeded
random (trainer.seed), as the reference's `fast_random_params`.

Usage:
  python -m vla_rft_tpu_torch.trainer.main_sft sft.mode=vla_adapter \
      trainer.total_training_steps=3 [--preset=tiny] [--device=cpu]

The device defaults to the card; `--device=cpu` runs the plain PyTorch path.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, List, Optional

import torch

from vla_rft_tpu_torch import resolve_device
from vla_rft_tpu_torch.config import PolicyConfig, WMRewardConfig, vla_rft_default_config
from vla_rft_tpu_torch.data.synthetic import SyntheticVLAConfig, SyntheticVLADataset
from vla_rft_tpu_torch.models.factory import build_policy, wm_reward_configs
from vla_rft_tpu_torch.trainer.sft_trainer import (VLAAdapterSFTTrainer, VLAFlowSFTTrainer,
                                                   to_device)
from vla_rft_tpu_torch.workers.flow_actor import encode_context

NOT_PORTED = {
    "text": "needs an HF tokenizer and a parquet dataset, which the repository does not hold",
    "vla_align": "needs OpenVLA.lm_forward and PrismaticAlignTrainer",
}


@dataclasses.dataclass
class SFTRun:
    """What a run leaves behind: the loss of each step, the trainer (its
    modules hold the trained weights) and the policy bundle."""
    losses: List[float]
    trainer: object
    bundle: object


def run(argv: Optional[List[str]] = None,
        on_start: Optional[Callable[[object], None]] = None,
        on_step: Optional[Callable[[int, float, float], None]] = None) -> SFTRun:
    """Parse flags and overrides, train, print one `[sft step N]` line per
    step.  A caller that reads clocks, counters or weights gets the trainer
    in `on_start(trainer)` before the first step and `on_step(step, loss,
    seconds)` after each one (a step ends by reading its loss, so its
    seconds include every kernel it launched)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    preset, device = "libero", "cuda"
    for a in list(argv):
        if a.startswith("--preset="):
            preset = a.split("=", 1)[1]
            argv.remove(a)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
            argv.remove(a)
    config = vla_rft_default_config().apply_overrides([a for a in argv if "=" in a])
    mode = config.get("sft", {}).get("mode", "vla_flow")
    steps = config.trainer.total_training_steps
    if mode in NOT_PORTED:
        raise NotImplementedError(f"sft.mode={mode} is not ported yet: {NOT_PORTED[mode]}")
    if mode not in ("vla_flow", "vla_adapter"):
        raise SystemExit(f"unknown sft.mode {mode!r} (text | vla_flow | vla_adapter | vla_align)")
    dev = resolve_device(device)
    seed = config.trainer.get("seed", 0)
    bundle = build_policy(preset, PolicyConfig.from_config(config), device=dev, seed=seed,
                          trainable=True)
    dataset = SyntheticVLADataset(dataset_config(config, preset, bundle))
    gen = torch.Generator(device=dev).manual_seed(seed)
    if mode == "vla_flow":
        trainer = VLAFlowSFTTrainer(bundle.expert, lr=config.actor_rollout_ref.actor.optim.lr)
        step_fn = lambda: _vla_flow_step(trainer, bundle, dataset, gen, dev)
        tag = "flow_bc_loss"
    else:
        trainer = _adapter_trainer(config, bundle)
        step_fn = lambda: trainer.training_step(gen, policy_batch(dataset.next_batch(), dev))
        tag = "adapter_bc_loss"
    if on_start is not None:
        on_start(trainer)
    losses = []
    for step in range(1, steps + 1):
        t0 = time.perf_counter()
        losses.append(step_fn())
        seconds = time.perf_counter() - t0
        print(f"[sft step {step}] {tag} {losses[-1]:.4f} ({seconds:.2f}s)", flush=True)
        if on_step is not None:
            on_step(step, losses[-1], seconds)
    return SFTRun(losses, trainer, bundle)


def dataset_config(config, preset: str, bundle) -> SyntheticVLAConfig:
    """The reference's SyntheticVLAConfig for a policy bundle (the WM frame
    size and frame count set how many draws precede the policy fields)."""
    segment_length = config.data.video.segment_length
    wm_image_size = wm_reward_configs(preset, WMRewardConfig(segment_length=segment_length))[5]
    return SyntheticVLAConfig(
        batch_size=config.data.train_batch_size,
        seq_len=bundle.policy_seq_len,
        num_action_tokens=bundle.vla_cfg.num_tokens,
        policy_image_size=bundle.policy_image_size,
        wm_image_size=wm_image_size,
        num_frames=segment_length,
        action_chunk=bundle.expert_cfg.num_actions_chunk,
        action_dim=bundle.expert_cfg.action_dim,
        proprio_dim=bundle.vla_cfg.proprio_dim,
        num_images=bundle.vla_cfg.num_images,
        seed=config.trainer.get("seed", 0),
    )


def policy_batch(b, device):
    """A dataset batch as the policy reads it (pixel_values -> pixels)."""
    keys = ("input_ids", "attention_mask", "labels", "proprio", "actions")
    out = to_device({k: b[k] for k in keys}, device)
    out["pixels"] = torch.as_tensor(b["pixel_values"], device=device)
    return out


def _vla_flow_step(trainer, bundle, dataset, gen, dev) -> float:
    """One vla_flow step: the batch's context without gradients, then BC."""
    b = policy_batch(dataset.next_batch(), dev)
    with torch.no_grad():
        hidden = encode_context(bundle.vla, b)
    return trainer.training_step(gen, hidden, b["actions"], b["proprio"])


def _adapter_trainer(config, bundle) -> VLAAdapterSFTTrainer:
    sft = config.get("sft", {})
    return VLAAdapterSFTTrainer(
        bundle.vla, bundle.expert,
        lr=float(sft.get("vlm_lr", 2e-5)),
        expert_lr=config.actor_rollout_ref.actor.optim.lr,
        freeze_vision_backbone=bool(sft.get("freeze_vision_backbone", False)),
        freeze_llm=bool(sft.get("freeze_llm", False)),
    )


if __name__ == "__main__":
    run()
