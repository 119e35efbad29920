"""Math-Verify-style scorer, implemented natively.

The reference's math_verify.py (train/verl/verl/utils/reward_score/
math_verify.py:23-39) delegates to the pip `math-verify` library: the gold
answer is wrapped in \\boxed{...}, the model output is scanned for latex or
plain expressions, and the two are verified for mathematical equivalence.
That library is not available here (no pip installs), so this module
reproduces the same contract on top of the native prime_math grader:
candidate answers are extracted from the model output (last boxed latex,
then display/inline math, then the trailing expression/number) and each is
graded against the gold with the tiered sympy equivalence check.

Returns 1.0 / 0.0 like the library's metric (timeout -> `timeout_score`).
"""
from __future__ import annotations

import re
from typing import List

from vla_rft_tpu_torch.utils.reward_score.prime_math import (
    grade_answer,
    last_boxed_content,
)

_MATH_SPANS = re.compile(r"\$\$(.+?)\$\$|\$(.+?)\$|\\\[(.+?)\\\]|\\\((.+?)\\\)", re.S)
_TRAILING_EXPR = re.compile(r"([-+]?[\d][\d,./a-z^*+\- ()]*?)\s*[.!?]?\s*$", re.I)


def _candidates(model_output: str) -> List[str]:
    """Prediction extraction order mirrors the library's
    (ExprExtractionConfig, LatexExtractionConfig) fallback chain: boxed
    first, then the last math span, then a trailing bare expression."""
    cands: List[str] = []
    boxed = last_boxed_content(model_output)
    if boxed:
        cands.append(boxed)
    spans = _MATH_SPANS.findall(model_output)
    if spans:
        last = next(g for g in spans[-1][::-1] if g)  # last non-empty group
        inner = last_boxed_content(last)
        cands.append(inner if inner else last.strip())
    tail = _TRAILING_EXPR.search(model_output.strip())
    if tail and any(c.isdigit() for c in tail.group(1)):
        cands.append(tail.group(1).strip())
    return cands


def compute_score(model_output: str, ground_truth: str, timeout_score: float = 0) -> float:
    try:
        gt = last_boxed_content(ground_truth) or ground_truth
        for cand in _candidates(str(model_output)):
            if grade_answer(cand, str(gt)):
                return 1.0
        return 0.0
    except TimeoutError:
        return float(timeout_score)
    except Exception:
        return 0.0
