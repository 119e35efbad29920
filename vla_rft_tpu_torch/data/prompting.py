"""Prompt construction for the minivla policy (numpy only).

A copy of vla_rft_tpu/data/prompting.py, which the port may not import.

Port of QwenPromptBuilder + RLDSBatchTransform_V1's minivla path
(prismatic/vla/datasets/datasets.py:300-433): a Qwen chat prompt around
"What action should the robot take to {instruction}?", the chat-template tail
trimmed (3 tokens dropped, datasets.py:349-353), then NUM_TOKENS=64 action
token ids appended (the 8x7 chunk, padded by resampling to 64); labels mask
everything except the final (NUM_TOKENS + 1) positions.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from vla_rft_tpu_torch.data.action_tokenizer import ActionTokenizer

IGNORE_INDEX = -100
NUM_TOKENS = 64


class QwenPromptBuilder:
    """Chat-template prompt for Qwen2.5 (prismatic/models/backbones/llm/
    prompting qwen builder). The rendered text matches Qwen's chat format."""

    SYSTEM = "You are a helpful assistant."

    def __init__(self, model_family: str = "openvla"):
        self.turns: List[Dict[str, str]] = []

    def add_turn(self, role: str, message: str) -> None:
        self.turns.append({"from": role, "value": message})

    def get_prompt(self) -> str:
        parts = [f"<|im_start|>system\n{self.SYSTEM}<|im_end|>\n"]
        for t in self.turns:
            if t["from"] == "human":
                parts.append(f"<|im_start|>user\n{t['value']}<|im_end|>\n")
            else:
                parts.append(f"<|im_start|>assistant\n{t['value']}<|im_end|>\n")
        return "".join(parts)


def build_vla_sample(
    tokenizer,
    instruction: str,
    actions: Optional[np.ndarray] = None,
    action_tokenizer: Optional[ActionTokenizer] = None,
    num_tokens: int = NUM_TOKENS,
    rng: Optional[random.Random] = None,
) -> Dict[str, np.ndarray]:
    """RLDSBatchTransform_V1 minivla path -> input_ids/labels.

    tokenizer: a HF tokenizer (or any callable .encode(text)->List[int]).
    actions: (chunk, action_dim) continuous chunk; at eval time pass None and
    arbitrary action ids fill the 64 slots (the embeddings are replaced by
    action queries anyway, modeling_prismatic.py:642-651).
    """
    rng = rng or random.Random(0)
    action_tokenizer = action_tokenizer or ActionTokenizer()

    pb = QwenPromptBuilder("openvla")
    pb.add_turn("human", f"What action should the robot take to {instruction.lower()}?")
    pb.add_turn("gpt", "")
    prompt = pb.get_prompt()
    if hasattr(tokenizer, "encode"):
        input_ids = list(tokenizer.encode(prompt))
    else:
        input_ids = list(tokenizer(prompt))
    # trim the 3 chat-template tail tokens (datasets.py:349-353)
    if len(input_ids) >= 3:
        del input_ids[-3:]

    if actions is not None:
        chunk_ids = [action_tokenizer.encode(a).tolist() for a in np.asarray(actions)]
        flat = [i for row in chunk_ids for i in row]
    else:
        flat = [action_tokenizer.vocab_size - 1] * num_tokens  # arbitrary action ids
    if num_tokens < len(flat):
        flat = flat[:num_tokens]
    else:
        flat = flat + rng.choices(flat, k=num_tokens - len(flat))
    input_ids = input_ids + flat

    labels = np.asarray(input_ids, np.int64).copy()
    labels[: -(num_tokens + 1)] = IGNORE_INDEX
    return {
        "input_ids": np.asarray(input_ids, np.int64),
        "labels": labels,
    }


def pad_collate(
    samples: Sequence[Dict[str, np.ndarray]],
    pad_token_id: int,
    max_length: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """PaddedCollatorForActionPrediction (prismatic/util/data_utils.py):
    right-pad input_ids with pad_token, labels with IGNORE; attention mask."""
    L = max_length or max(len(s["input_ids"]) for s in samples)
    B = len(samples)
    input_ids = np.full((B, L), pad_token_id, np.int64)
    labels = np.full((B, L), IGNORE_INDEX, np.int64)
    mask = np.zeros((B, L), np.int64)
    for i, s in enumerate(samples):
        n = min(len(s["input_ids"]), L)
        input_ids[i, :n] = s["input_ids"][:n]
        labels[i, :n] = s["labels"][:n]
        mask[i, :n] = 1
    return {"input_ids": input_ids, "labels": labels, "attention_mask": mask}
