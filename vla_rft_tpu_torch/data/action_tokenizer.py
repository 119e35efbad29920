"""ActionTokenizer: continuous actions <-> discrete token ids in the LLM
vocab tail.  A copy of vla_rft_tpu/data/action_tokenizer.py (numpy only).

Port of prismatic/vla/datasets/rlds/utils/data_utils ActionTokenizer
(prismatic/vla/action_tokenizer.py:22-99 in the reference tree): actions
clipped to [-1, 1], discretized into 256 uniform bins, mapped to the LAST 256
tokenizer ids — for Qwen2.5 that is ids (vocab_len-256 .. vocab_len-1], all
above ACTION_TOKEN_BEGIN_IDX=151386 (prismatic/vla/constants.py).
"""
from __future__ import annotations

import numpy as np


class ActionTokenizer:
    def __init__(
        self,
        tokenizer_vocab_size: int = 151643,  # len(Qwen2.5 tokenizer)
        bins: int = 256,
        min_action: float = -1.0,
        max_action: float = 1.0,
    ):
        self.vocab_size = tokenizer_vocab_size
        self.n_bins = bins
        self.min_action = min_action
        self.max_action = max_action
        self.bins = np.linspace(min_action, max_action, bins)
        self.bin_centers = (self.bins[:-1] + self.bins[1:]) / 2.0

    def encode(self, action: np.ndarray) -> np.ndarray:
        """(..., A) float -> (..., A) int token ids."""
        action = np.clip(action, self.min_action, self.max_action)
        disc = np.digitize(action, self.bins)
        return (self.vocab_size - disc).astype(np.int64)

    def __call__(self, action: np.ndarray, use_minivla: bool = True):
        """Reference call convention: use_minivla=True returns per-step lists
        of token ids (datasets.py:329-331); else decoded strings (unused here)."""
        ids = self.encode(np.asarray(action))
        if ids.ndim == 1:
            return ids.tolist()
        return [row.tolist() for row in ids]

    def decode_token_ids_to_actions(self, token_ids: np.ndarray) -> np.ndarray:
        disc = self.vocab_size - np.asarray(token_ids)
        disc = np.clip(disc - 1, 0, self.bin_centers.shape[0] - 1)
        return self.bin_centers[disc]

    @property
    def action_token_begin_idx(self) -> int:
        return int(self.vocab_size - self.n_bins - 1)  # 151386 for Qwen2.5
