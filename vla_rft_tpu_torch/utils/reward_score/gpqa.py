"""GPQA multiple-choice scorer (recipe/r1/tasks/gpqa.py): extract the
'Answer: X' letter (openai/simple-evals template) and exact-match it."""
from __future__ import annotations

import re

ANSWER_PATTERN_MULTICHOICE = r"(?i)Answer[ \t]*:[ \t]*\$?([A-D])\$?"


def compute_score(solution_str: str, ground_truth: str) -> float:
    match = re.search(ANSWER_PATTERN_MULTICHOICE, solution_str)
    extracted = match.group(1).upper() if match else None
    return 1.0 if extracted == str(ground_truth).strip().upper() else 0.0
