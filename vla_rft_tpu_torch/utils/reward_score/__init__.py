"""Rule-based reward scorers (port of vla_rft_tpu/utils/reward_score/,
verl/utils/reward_score/): a copy of the reference's modules, host-only
Python (sympy is imported inside prime_math's grader; prime_code runs each
program in a `python -I` subprocess)."""
from __future__ import annotations

import importlib
from typing import Optional

# data_source -> scorer module name (verl/utils/reward_score/__init__.py
# dispatch table, trimmed to the text-RL sources the retained recipes use)
_REGISTRY = {
    "openai/gsm8k": "gsm8k",
    "gsm8k": "gsm8k",
    "lighteval/MATH": "math",
    "math": "math",
    "DigitalLearningGmbH/MATH-lighteval": "math",
    "math_dapo": "math_dapo",
    "aime2024": "math_dapo",
    "math_verify": "math_verify",
    # numina sources dispatch to the sympy grader (reference __init__.py:35-40)
    "prime_math": "prime_math",
    "numina_aops_forum": "prime_math",
    "numina_synthetic_math": "prime_math",
    "numina_amc_aime": "prime_math",
    "numina_synthetic_amc": "prime_math",
    "numina_cn_k12": "prime_math",
    "numina_olympiads": "prime_math",
    "gpqa": "gpqa",
    "Idavidrein/gpqa": "gpqa",
    "hiyouga/geometry3k": "geo3k",
    "geo3k": "geo3k",
    # APPS-style code sources run in a subprocess sandbox (prime_code)
    "codecontests": "prime_code",
    "apps": "prime_code",
    "codeforces": "prime_code",
    "taco": "prime_code",
}


def has_scorer(data_source: str) -> bool:
    return data_source in _REGISTRY


def default_compute_score(
    data_source: str, solution_str: str, ground_truth: str, extra_info=None
) -> float:
    """Dispatch like verl's default_compute_score."""
    mod_name = _REGISTRY.get(data_source)
    if mod_name is None:
        raise NotImplementedError(f"no scorer for data source {data_source!r}")
    mod = importlib.import_module(f"vla_rft_tpu_torch.utils.reward_score.{mod_name}")
    if mod_name == "prime_code":
        # reference registry passes continuous=True explicitly for code
        # sources (__init__.py:41-42) while the scorer itself defaults False
        res = mod.compute_score(solution_str, ground_truth, continuous=True)
    else:
        res = mod.compute_score(solution_str, ground_truth)
    # scorers may return score, (score, metadata), or {"score": ...}
    # (reference __init__.py:49-55)
    if isinstance(res, dict):
        return float(res["score"])
    if isinstance(res, (int, float, bool)):
        return float(res)
    return float(res[0])


def compute_score_with_info(
    data_source: str, solution_str: str, ground_truth: str, extra_info=None
) -> tuple:
    """Like default_compute_score but keeps the scorer's side channel:
    returns (score, info_dict).  info_dict carries 'pred' (the extracted
    answer string) when the scorer exposes one — the majority-vote key the
    validation metrics need (reference metric_utils.py:193-207)."""
    mod_name = _REGISTRY.get(data_source)
    if mod_name is None:
        raise NotImplementedError(f"no scorer for data source {data_source!r}")
    mod = importlib.import_module(f"vla_rft_tpu_torch.utils.reward_score.{mod_name}")
    if mod_name == "prime_code":
        res = mod.compute_score(solution_str, ground_truth, continuous=True)
    else:
        res = mod.compute_score(solution_str, ground_truth)
    if isinstance(res, dict):
        info = {k: v for k, v in res.items() if k != "score"}
        return float(res["score"]), info
    if isinstance(res, (int, float, bool)):
        return float(res), {}
    info = {}
    if mod_name == "prime_math" and len(res) >= 3:
        info = {"format_correct": bool(res[1]), "pred": str(res[2])}
    return float(res[0]), info
