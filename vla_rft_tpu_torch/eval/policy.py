"""Policy-loading glue for the serving path.

Port of vla_rft_tpu/eval/policy.py: `build_policy_fn` returns
`policy_fn(observation, task_description) -> (chunk, 7)` with the policy
resident on the device, as the action server needs it.  Differences from
the reference, both deliberate:

* the no-checkpoint tokenizer stub hashes words with `zlib.crc32` instead
  of Python's salted `hash()`, so a request maps to the same token ids in
  every process;
* `_fit_views` resizes with `F.interpolate(bilinear, antialias=True)`, the
  PyTorch counterpart of `jax.image.resize(..., "bilinear")` (which
  antialiases when it downscales).
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from vla_rft_tpu_torch import resolve_device
from vla_rft_tpu_torch.config import PolicyConfig
from vla_rft_tpu_torch.data.prompting import build_vla_sample, pad_collate
from vla_rft_tpu_torch.eval.libero_eval import center_crop_image
from vla_rft_tpu_torch.models.factory import build_policy
from vla_rft_tpu_torch.workers.predict import (
    invert_gripper_action,
    normalize_gripper_action,
    predict_action,
    unnormalize_actions,
)

QWEN_PAD_TOKEN_ID = 151643


def assemble_pixels(observation: Dict[str, Any], num_images: int = 1,
                    center_crop: bool = False) -> np.ndarray:
    """Observation -> (H, W, 6*num_images) float32 [0,1] policy pixels:
    full_image first, then every key containing 'wrist' in dict order, each
    view (center-cropped when asked) stacked [view, view] into its 6-channel
    dino|siglip slot."""
    views = [observation["full_image"]]
    if num_images > 1:
        views += [observation[k] for k in observation if "wrist" in k]
    views = views[:num_images]
    while len(views) < num_images:  # missing cameras: repeat the last
        views.append(views[-1])
    stacks = []
    for v in views:
        if center_crop:
            v = center_crop_image(np.asarray(v))
        v = np.asarray(v, np.float32) / 255.0
        stacks.append(np.concatenate([v, v], -1))
    return np.concatenate(stacks, -1)


def fit_views(six: np.ndarray, size: int) -> np.ndarray:
    """Per-view bilinear resize (antialiased when shrinking) of (H, W, C) to
    (size, size, C)."""
    if six.shape[0] == size and six.shape[1] == size:
        return six
    x = torch.from_numpy(np.ascontiguousarray(six, np.float32)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    return y[0].permute(1, 2, 0).numpy()


class _StubTokenizer:
    """Stand-in when no checkpoint tokenizer is given: stable word hashes."""

    def encode(self, text):
        return [zlib.crc32(w.encode()) % 1000 + 10 for w in text.split()][:20] + [1, 2, 3]


def build_policy_fn(ckpt: str = "", num_flow_steps: int = 10, seed: int = 7,
                    num_images: int = 1, center_crop: bool = False,
                    preset: str = "libero", device="cuda",
                    ) -> Callable[[Dict[str, Any], str], np.ndarray]:
    """Build the policy of `preset` ('libero', or 'tiny' / 'push' on the
    CPU) on `device` with seeded random weights, as the reference does, and
    return the closed-over policy function; views are resized to the
    preset's resolution.  `ckpt` supplies dataset_statistics.json and, when
    `transformers` can load one, a tokenizer; the weights are not read from
    it (load them into `policy_fn.bundle`).

    Observation keys used: full_image (H, W, 3 uint8), proprio/state, and,
    when num_images > 1, every key containing 'wrist'.  The returned
    function also carries `bundle` (the models) and `make_batch` (the
    request -> tensors step) for callers that drive the model directly."""
    dev = resolve_device(device)
    config = PolicyConfig(num_images_in_input=int(num_images))
    bundle = build_policy(preset, config, device=dev, seed=0)
    norm_stats = {"q01": -np.ones(7), "q99": np.ones(7)}
    tokenizer = None
    if ckpt:
        stats_path = os.path.join(ckpt, "dataset_statistics.json")
        if os.path.exists(stats_path):
            with open(stats_path) as f:
                norm_stats = json.load(f)["action"]
        try:
            from transformers import AutoTokenizer

            tokenizer = AutoTokenizer.from_pretrained(ckpt)
        except (ImportError, OSError, ValueError):
            tokenizer = None
    if tokenizer is None:
        tokenizer = _StubTokenizer()

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    vcfg = bundle.vla_cfg

    def make_batch(observation: Dict[str, Any], task_description: str) -> Dict[str, torch.Tensor]:
        s = build_vla_sample(tokenizer, task_description, None, num_tokens=vcfg.num_tokens)
        coll = pad_collate(
            [s], pad_token_id=QWEN_PAD_TOKEN_ID,
            max_length=max(bundle.policy_seq_len, len(s["input_ids"])),
        )
        six = fit_views(assemble_pixels(observation, num_images, center_crop),
                        bundle.policy_image_size)
        proprio = observation.get("proprio", observation.get("state"))
        if proprio is None:
            proprio = np.zeros(vcfg.proprio_dim)
        # LIBERO proprio is 8-dim; pad/trim to the projector's input width
        pd = vcfg.proprio_dim
        proprio = np.asarray(proprio, np.float32).reshape(-1)[:pd]
        if proprio.shape[0] < pd:
            proprio = np.pad(proprio, (0, pd - proprio.shape[0]))
        return {
            "input_ids": torch.as_tensor(coll["input_ids"], device=dev),
            "labels": torch.as_tensor(coll["labels"], device=dev),
            "attention_mask": torch.as_tensor(coll["attention_mask"], device=dev),
            "pixels": torch.as_tensor(six, device=dev)[None],
            "proprio": torch.as_tensor(proprio, device=dev)[None],
        }

    def policy_fn(observation: Dict[str, Any], task_description: str) -> np.ndarray:
        batch = make_batch(observation, task_description)
        normalized = predict_action(
            bundle.vla, bundle.expert, batch, num_flow_steps, generator=gen
        )
        normalized = normalized.float().cpu().numpy()[0]
        actions = unnormalize_actions(normalized, norm_stats)
        actions = normalize_gripper_action(actions, binarize=True)
        return invert_gripper_action(actions)

    policy_fn.bundle = bundle
    policy_fn.make_batch = make_batch
    return policy_fn
