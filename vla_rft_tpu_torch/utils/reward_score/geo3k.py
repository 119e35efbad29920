"""Geometry3k scorer (verl/utils/reward_score/geo3k.py parity): extract the
last \\boxed{...} answer and compare numerically with a small tolerance."""
from __future__ import annotations

from vla_rft_tpu_torch.utils.reward_score.math import last_boxed_only_string, normalize


def compute_score(solution_str: str, ground_truth: str) -> float:
    ans = last_boxed_only_string(solution_str)
    if ans is None:
        return 0.0
    a, b = normalize(ans), normalize(str(ground_truth))
    if a == b:
        return 1.0
    try:
        return 1.0 if abs(float(a) - float(b)) < 1e-4 else 0.0
    except ValueError:
        return 0.0
