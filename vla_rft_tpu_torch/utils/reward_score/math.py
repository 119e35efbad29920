"""MATH scorer (verl/utils/reward_score/math.py parity, lightweight):
extract \\boxed{...} and string-compare after normalization."""
from __future__ import annotations

from typing import Optional


def last_boxed_only_string(s: str) -> Optional[str]:
    idx = s.rfind("\\boxed{")
    if idx < 0:
        return None
    depth = 0
    for i in range(idx + len("\\boxed{") - 1, len(s)):
        if s[i] == "{":
            depth += 1
        elif s[i] == "}":
            depth -= 1
            if depth == 0:
                return s[idx + len("\\boxed{") : i]
    return None


def normalize(ans: str) -> str:
    for tok in ("\\left", "\\right", " ", "\\!", "\\,", "$"):
        ans = ans.replace(tok, "")
    ans = ans.replace("\\frac", "\\dfrac")
    return ans.strip()


def compute_score(solution_str: str, ground_truth: str) -> float:
    answer = last_boxed_only_string(solution_str)
    if answer is None:
        return 0.0
    return 1.0 if normalize(answer) == normalize(str(ground_truth)) else 0.0
