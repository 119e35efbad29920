"""Synthetic LIBERO-shaped dataset (port of vla_rft_tpu/data/synthetic.py).

Stands in for the RLDS pipeline when the LIBERO tfrecords are not present:
seeded numpy batches with the fields and shapes the trainers read
(pixel_values for the policy towers, proprio, input_ids/attention_mask/
labels with a 64-token action tail, the gt action chunk, raw WM frames).
Numpy only; for the same seed and step a batch equals the reference's bit
for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from vla_rft_tpu_torch.models.action_masks import ACTION_TOKEN_BEGIN_IDX


@dataclasses.dataclass
class SyntheticVLAConfig:
    batch_size: int = 16
    seq_len: int = 96
    num_action_tokens: int = 64
    policy_image_size: int = 224
    wm_image_size: int = 256
    num_frames: int = 9  # segment_length
    action_chunk: int = 8
    action_dim: int = 7
    proprio_dim: int = 8
    text_vocab: int = 150000
    # camera views: each contributes a 6-channel dino|siglip stack
    # (num_images_in_input, modeling_prismatic.py:209-231)
    num_images: int = 1
    seed: int = 0


class SyntheticVLADataset:
    """Deterministic, seedable batch stream (StatefulDataLoader analog:
    `state_dict`/`load_state_dict` expose the step counter for resume)."""

    def __init__(self, cfg: SyntheticVLAConfig):
        self.cfg = cfg
        self._step = 0

    def state_dict(self) -> Dict:
        return {"step": self._step}

    def load_state_dict(self, state: Dict) -> None:
        self._step = int(state["step"])

    def next_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed + self._step)
        self._step += 1
        B, S, N = cfg.batch_size, cfg.seq_len, cfg.num_action_tokens

        # prompt layout: [BOS, text ..., 64 action tokens, EOS, padding]
        text_len = S - N - 2
        input_ids = rng.integers(10, cfg.text_vocab, (B, S))
        labels = np.full((B, S), -100, np.int64)
        action_ids = ACTION_TOKEN_BEGIN_IDX + 1 + rng.integers(0, 100, (B, N))
        start = 1 + text_len
        input_ids[:, start : start + N] = action_ids
        labels[:, start : start + N] = action_ids
        attention_mask = np.ones((B, S), np.int64)
        attention_mask[:, -1] = 0  # a little right padding to exercise masking

        # smooth-ish video so the WM/tokenizer see structure, not white noise
        base = rng.uniform(0, 255, (B, 1, cfg.wm_image_size, cfg.wm_image_size, 3))
        drift = rng.uniform(-8, 8, (B, cfg.num_frames, 1, 1, 3))
        raw = np.clip(base + np.cumsum(drift, axis=1), 0, 255).astype(np.uint8)

        return {
            "pixel_values": rng.uniform(
                0, 1,
                (B, cfg.policy_image_size, cfg.policy_image_size, 6 * cfg.num_images),
            ).astype(np.float32),
            "proprio": rng.normal(size=(B, cfg.proprio_dim)).astype(np.float32),
            "input_ids": input_ids.astype(np.int32),
            "attention_mask": attention_mask.astype(np.int32),
            "labels": labels.astype(np.int32),
            "actions": rng.uniform(-1, 1, (B, cfg.action_chunk, cfg.action_dim)).astype(
                np.float32
            ),
            "raw_pixel_values": raw,
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()


def default_action_ranges(action_dim: int = 7) -> np.ndarray:
    """Stand-in for libero_action_ranges.pth: [-1, 1]^A as (A, 2) [min, max]."""
    return np.stack([-np.ones(action_dim), np.ones(action_dim)], axis=-1).astype(np.float32)


def load_action_ranges(path: str) -> np.ndarray:
    """Per-dimension action ranges (A, 2) [min, max] f32 from a torch tensor
    file (.pth / .pt, the reference's libero_action_ranges.pth) or
    .npy / .npz / .json."""
    if path.endswith((".npy", ".npz")):
        arr = np.load(path)
        if hasattr(arr, "files"):  # npz
            arr = arr[arr.files[0]]
    elif path.endswith(".json"):
        import json

        with open(path) as f:
            arr = np.asarray(json.load(f))
    else:
        import torch

        arr = torch.load(path, map_location="cpu", weights_only=True).numpy()
    arr = np.asarray(arr, np.float32)
    if arr.ndim != 2 or arr.shape[1] != 2:
        raise ValueError(f"action ranges at {path} must be (A, 2), got {arr.shape}")
    return arr
