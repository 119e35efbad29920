"""Reward managers for the text-RL path (port of
vla_rft_tpu/workers/reward_manager.py, verl's
workers/reward_manager/{naive,dapo}.py): decode each response up to its
mask, score it with a rule scorer (the port's `utils/reward_score`), and
place the scalar at the last valid response token.  Host-only numpy."""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np

from vla_rft_tpu_torch.utils.reward_score import default_compute_score


class NaiveRewardManager:
    """verl/workers/reward_manager/naive.py."""

    def __init__(self, tokenizer, compute_score: Optional[Callable] = None, num_examine: int = 0):
        self.tokenizer = tokenizer
        self.compute_score = compute_score or default_compute_score
        self.num_examine = num_examine

    def __call__(
        self,
        responses: np.ndarray,  # (B, R) token ids
        response_mask: np.ndarray,  # (B, R)
        data_sources: List[str],
        ground_truths: List[str],
        extra_infos: Optional[List] = None,
    ) -> np.ndarray:
        """(B, R) f32 token-level scores: each row's score at its last valid
        token, 0 elsewhere (and a row with an empty response scores 0)."""
        B, R = responses.shape
        reward = np.zeros((B, R), np.float32)
        for i in range(B):
            n = int(response_mask[i].sum())
            if n == 0:
                continue
            text = self.tokenizer.decode(responses[i, :n].tolist())
            score = self.compute_score(
                data_sources[i], text, ground_truths[i],
                extra_infos[i] if extra_infos else None,
            )
            reward[i, n - 1] = score
            if i < self.num_examine:
                print(f"[reward] src={data_sources[i]} score={score} text={text[:200]!r}")
        return reward


class DAPORewardManager(NaiveRewardManager):
    """DAPO's soft overlong punishment (verl/workers/reward_manager/dapo.py):
    a response within `overlong_buffer` tokens of max_response_length gets a
    penalty rising linearly to `penalty_factor`, added at its last token."""

    def __init__(self, tokenizer, compute_score=None, num_examine: int = 0,
                 max_response_length: int = 1024, overlong_buffer: int = 128,
                 penalty_factor: float = 1.0):
        super().__init__(tokenizer, compute_score, num_examine)
        self.max_response_length = max_response_length
        self.overlong_buffer = overlong_buffer
        self.penalty_factor = penalty_factor

    def __call__(self, responses, response_mask, data_sources, ground_truths,
                 extra_infos=None):
        reward = super().__call__(responses, response_mask, data_sources, ground_truths,
                                  extra_infos)
        lengths = response_mask.sum(-1)
        expected = self.max_response_length - self.overlong_buffer
        overlong = np.clip(lengths - expected, 0, None).astype(np.float32)
        penalty = -overlong / max(self.overlong_buffer, 1) * self.penalty_factor
        for i in range(reward.shape[0]):
            n = int(lengths[i])
            if n > 0 and penalty[i] < 0:
                reward[i, n - 1] += penalty[i]
        return reward


class BatchRewardManager(NaiveRewardManager):
    """The reference's batch (prime) manager has the naive contract; process
    reward scores come through `compute_score` closures."""
