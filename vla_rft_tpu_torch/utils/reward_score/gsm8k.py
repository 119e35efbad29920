"""GSM8K scorer (verl/utils/reward_score/gsm8k.py parity): extract the final
'#### <number>' answer; strict match scores 1.0, formatted-but-wrong scores
format_score, no answer scores 0."""
from __future__ import annotations

import re
from typing import Optional

_ANSWER_RE = re.compile(r"#### (\-?[0-9\.\,]+)")
_NUMBER_RE = re.compile(r"(\-?[0-9\.\,]+)")


def extract_solution(solution_str: str, method: str = "strict") -> Optional[str]:
    if method == "strict":
        matches = _ANSWER_RE.findall(solution_str)
        if not matches:
            return None
        return matches[-1].replace(",", "").replace("$", "")
    # flexible: last number anywhere
    matches = _NUMBER_RE.findall(solution_str)
    for m in reversed(matches):
        clean = m.replace(",", "")
        if clean not in ("", ".", "-"):
            return clean
    return None


def compute_score(
    solution_str: str,
    ground_truth: str,
    method: str = "strict",
    format_score: float = 0.0,
    score: float = 1.0,
) -> float:
    answer = extract_solution(solution_str, method)
    if answer is None:
        return 0.0
    if answer == str(ground_truth).replace(",", ""):
        return score
    return format_score
