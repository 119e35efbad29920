"""DAPO-style strict math scorer (verl/utils/reward_score/math_dapo.py).

Differences from the plain MATH scorer: the LAST \\boxed{...} (or a trailing
"Answer: ..." line) is extracted, answers are normalized (units, commas,
leading zeros, \\text wrappers), and the reward is +1 / -1 rather than 1 / 0 —
wrong OR missing answers are punished, which is what makes the DAPO recipe's
advantage filtering meaningful.
"""
from __future__ import annotations

import re
from typing import Optional


def last_boxed(text: str) -> Optional[str]:
    idx = text.rfind("\\boxed{")
    if idx < 0:
        m = re.findall(r"[Aa]nswer\s*[:=]\s*([^\n]+)", text)
        return m[-1].strip() if m else None
    depth = 0
    for i in range(idx + len("\\boxed"), len(text)):
        if text[i] == "{":
            depth += 1
        elif text[i] == "}":
            depth -= 1
            if depth == 0:
                return text[idx + len("\\boxed{") : i]
    return None


def normalize(ans: str) -> str:
    ans = ans.strip()
    ans = re.sub(r"\\text\{([^}]*)\}", r"\1", ans)
    ans = re.sub(r"\\mbox\{([^}]*)\}", r"\1", ans)
    ans = ans.replace("\\!", "").replace("\\,", "").replace("\\ ", "")
    ans = ans.replace("dfrac", "frac").replace("tfrac", "frac")
    ans = ans.replace("\\left", "").replace("\\right", "")
    ans = ans.replace("^{\\circ}", "").replace("^\\circ", "")
    ans = ans.replace("\\$", "").replace("$", "").replace("%", "")
    ans = ans.replace(",", "").replace(" ", "")
    ans = re.sub(r"^0+(?=\d)", "", ans)
    if ans.endswith(".0"):
        ans = ans[:-2]
    return ans


def compute_score(solution_str: str, ground_truth: str) -> float:
    pred = last_boxed(solution_str)
    if pred is None:
        return -1.0
    return 1.0 if normalize(pred) == normalize(ground_truth) else -1.0
