"""CLI entry point for supervised fine-tuning (port of vla_rft_tpu/trainer/main_sft.py).

Selected by sft.mode, with the reference's dotted overrides and defaults:

  text         masked next-token CE of Qwen2.5-0.5B (full width in every
               preset, as the reference) on a parquet of prompt / response
               columns (data.train_files; data.prompt_key / response_key;
               rows right-padded to max_prompt_length + max_response_length;
               the HF tokenizer from actor_rollout_ref.model.ckpt_path)
  vla_flow     flow-matching behaviour cloning of the action expert on
               synthetic LIBERO-shaped data; the VLM stays frozen and each
               batch's context is encoded once, without gradients
  vla_adapter  the same loss with the VLM trained too (VLA-Adapter's
               finetune stage; sft.vlm_lr, sft.freeze_vision_backbone,
               sft.freeze_llm)
  vla_align    the prismatic pretraining stage: only the projector trains
               (sft.projector_lr), on caption next-token loss through
               `OpenVLA.lm_forward`; a LLaVA chat JSON when sft.chat_json is
               set (sft.stage align | finetune | full-finetune, images under
               sft.image_dir, the HF tokenizer from actor_rollout_ref.model.
               path), synthetic captions otherwise

The VLA modes train on synthetic batches in the reference too (it reads no
data.video.dataset_path there).  Weights are seeded random (trainer.seed),
as the reference's `fast_random_params`.

Usage:
  python -m vla_rft_tpu_torch.trainer.main_sft sft.mode=vla_adapter \
      trainer.total_training_steps=3 [--preset=tiny] [--device=cpu]
  python -m vla_rft_tpu_torch.trainer.main_sft sft.mode=text \
      data.train_files=train.parquet actor_rollout_ref.model.ckpt_path=<tokenizer dir>

The device defaults to the card; `--device=cpu` runs the plain PyTorch path.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from vla_rft_tpu_torch import resolve_device
from vla_rft_tpu_torch.config import PolicyConfig, WMRewardConfig, vla_rft_default_config
from vla_rft_tpu_torch.data.synthetic import SyntheticVLAConfig, SyntheticVLADataset
from vla_rft_tpu_torch.models.action_masks import IGNORE_INDEX
from vla_rft_tpu_torch.models.factory import build_policy, wm_reward_configs
from vla_rft_tpu_torch.models.transformer import TransformerConfig
from vla_rft_tpu_torch.trainer.sft_trainer import (PrismaticAlignTrainer, SFTTrainer,
                                                   VLAAdapterSFTTrainer, VLAFlowSFTTrainer,
                                                   to_device)
from vla_rft_tpu_torch.utils.fs import copy_to_local
from vla_rft_tpu_torch.workers.flow_actor import encode_context

MODES = ("text", "vla_flow", "vla_adapter", "vla_align")
# each mode's step line, as the reference prints it
STEP_LINES = {
    "text": "[sft step {step}] loss {loss:.4f} ({seconds:.2f}s)",
    "vla_flow": "[sft step {step}] flow_bc_loss {loss:.4f} ({seconds:.2f}s)",
    "vla_adapter": "[sft step {step}] adapter_bc_loss {loss:.4f} ({seconds:.2f}s)",
    "vla_align": "[align {step}] loss {loss:.4f}  ({seconds:.2f}s)",
}


@dataclasses.dataclass
class SFTRun:
    """What a run leaves behind: the loss of each step, the trainer (its
    modules hold the trained weights) and the policy bundle (None for
    `text`)."""
    losses: List[float]
    trainer: object
    bundle: object


def run(argv: Optional[List[str]] = None,
        on_start: Optional[Callable[[object], None]] = None,
        on_step: Optional[Callable[[int, float, float], None]] = None,
        tokenizer=None) -> SFTRun:
    """Parse flags and overrides, train, print one step line per step.  A
    caller that reads clocks, counters or weights gets the trainer in
    `on_start(trainer)` before the first step and `on_step(step, loss,
    seconds)` after each one (a step ends by reading its loss, so its
    seconds include every kernel it launched).  `tokenizer` stands in for
    the HF tokenizer that `text` and `vla_align` with sft.chat_json load
    from their configured path."""
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
    if mode not in MODES:
        raise SystemExit(f"unknown sft.mode {mode!r} (text | vla_flow | vla_adapter | vla_align)")
    dev = resolve_device(device)
    if mode == "text":
        trainer, step_fn = _text(config, dev, tokenizer)
        bundle = None
    else:
        seed = config.trainer.get("seed", 0)
        bundle = build_policy(preset, PolicyConfig.from_config(config), device=dev, seed=seed,
                              trainable=True)
        dataset = SyntheticVLADataset(dataset_config(config, preset, bundle))
        gen = torch.Generator(device=dev).manual_seed(seed)
        if mode == "vla_flow":
            trainer = VLAFlowSFTTrainer(bundle.expert, lr=config.actor_rollout_ref.actor.optim.lr)
            step_fn = lambda: _vla_flow_step(trainer, bundle, dataset, gen, dev)
        elif mode == "vla_adapter":
            trainer = _adapter_trainer(config, bundle)
            step_fn = lambda: trainer.training_step(gen, policy_batch(dataset.next_batch(), dev))
        else:
            trainer, step_fn = _vla_align(config, bundle, dataset, tokenizer)
    if on_start is not None:
        on_start(trainer)
    losses = []
    for step in range(1, steps + 1):
        t0 = time.perf_counter()
        losses.append(step_fn())
        seconds = time.perf_counter() - t0
        print(STEP_LINES[mode].format(step=step, loss=losses[-1], seconds=seconds), flush=True)
        if on_step is not None:
            on_step(step, losses[-1], seconds)
    return SFTRun(losses, trainer, bundle)


class SFTParquetDataset:
    """A prompt / response parquet -> (input_ids, labels, attention_mask),
    right-padded to `max_length`, labels -100 over the prompt and the
    padding (fsdp_sft_trainer's SFTDataset tokenize-and-mask)."""

    def __init__(self, parquet_files, tokenizer, prompt_key="prompt", response_key="response",
                 max_length=512, batch_size=8, seed=0):
        import pandas as pd

        files = parquet_files if isinstance(parquet_files, (list, tuple)) else [parquet_files]
        self.df = pd.concat([pd.read_parquet(copy_to_local(f)) for f in files])
        self.tokenizer = tokenizer
        self.prompt_key, self.response_key = prompt_key, response_key
        self.max_length, self.batch_size = max_length, batch_size
        self.rng = np.random.default_rng(seed)
        self.pad = tokenizer.pad_token_id or 0

    def draw(self) -> np.ndarray:
        """The next batch's row positions: what the reference's
        `df.sample(batch_size, random_state=s)` takes (pandas/core/sample.py:
        RandomState(s).choice(len, size, replace=False)), drawn by numpy
        whatever pandas version reads the files."""
        seed = int(self.rng.integers(1 << 31))
        return np.random.RandomState(seed).choice(len(self.df), self.batch_size, replace=False)

    def next_batch(self):
        rows = self.df.iloc[self.draw()]
        L = self.max_length
        ids = np.full((len(rows), L), self.pad, np.int32)
        labels = np.full((len(rows), L), -100, np.int32)
        attn = np.zeros((len(rows), L), np.int32)
        for i, (_, row) in enumerate(rows.iterrows()):
            p = self.tokenizer.encode(str(row[self.prompt_key]))
            r = self.tokenizer.encode(str(row[self.response_key])) + [
                self.tokenizer.eos_token_id or self.pad
            ]
            seq = (p + r)[:L]
            ids[i, : len(seq)] = seq
            attn[i, : len(seq)] = 1
            labels[i, min(len(p), L) : len(seq)] = seq[min(len(p), L) :]
        return {"input_ids": ids, "labels": labels, "attention_mask": attn}


def _text(config, dev, tokenizer):
    """Text SFT: Qwen2.5-0.5B's SFTTrainer over the parquet's batches."""
    if tokenizer is None:
        model_path = config.actor_rollout_ref.model.ckpt_path
        if not model_path:
            raise SystemExit("actor_rollout_ref.model.ckpt_path is required for text SFT")
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(model_path)
    trainer = SFTTrainer(TransformerConfig.qwen25_0_5b(),
                         lr=config.actor_rollout_ref.actor.optim.lr, device=dev)
    data = config.data
    dataset = SFTParquetDataset(
        data.get("train_files"), tokenizer,
        prompt_key=data.get("prompt_key", "prompt"),
        response_key=data.get("response_key", "response"),
        max_length=data.get("max_prompt_length", 256) + data.get("max_response_length", 256),
        batch_size=data.train_batch_size,
    )
    return trainer, lambda: trainer.training_step(dataset.next_batch())


def _vla_align(config, bundle, synthetic: SyntheticVLADataset, tokenizer):
    """The align stage over the chat JSON's stage dataset, or over synthetic
    captions when sft.chat_json is not set."""
    sft = config.get("sft", {})
    seed = config.trainer.get("seed", 0)
    chat_json = sft.get("chat_json", None)
    if chat_json:
        from vla_rft_tpu_torch.data.caption import get_caption_dataset

        if tokenizer is None:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(config.actor_rollout_ref.model.path)
        dataset = get_caption_dataset(
            sft.get("stage", "align"), json_path=chat_json, image_dir=sft.get("image_dir", "."),
            tokenizer=tokenizer, image_size=bundle.policy_image_size,
            batch_size=config.data.train_batch_size, seq_len=bundle.policy_seq_len,
            pad_token_id=tokenizer.pad_token_id or 0, seed=seed)
        keys = ("input_ids", "pixel_values", "attention_mask", "labels")
        next_batch = lambda: {k: v for k, v in dataset.next_batch().items() if k in keys}
    else:
        next_batch = lambda: synthetic_caption_batch(synthetic.next_batch())
    trainer = PrismaticAlignTrainer(bundle.vla, lr=float(sft.get("projector_lr", 1e-3)))
    return trainer, lambda: trainer.training_step(next_batch())


def synthetic_caption_batch(b):
    """A synthetic VLA batch as caption supervision: the valid tokens after
    the first quarter of each row are predicted (a prompt / caption split
    stand-in, as the reference's)."""
    am, ids = b["attention_mask"], b["input_ids"]
    labels = np.where(am > 0, ids, IGNORE_INDEX)
    labels[:, :max(1, ids.shape[1] // 4)] = IGNORE_INDEX
    return {"input_ids": ids, "pixel_values": b["pixel_values"], "attention_mask": am,
            "labels": labels}


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
