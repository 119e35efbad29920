"""Offline evaluation of generated responses against rule verifiers (port of
vla_rft_tpu/trainer/main_eval.py, verl's main_eval).

Reads a parquet of prompts, N generated responses per row and ground truth,
scores each response with its data source's rule scorer
(utils/reward_score), and reports pass@1 (the mean) and best@n per source.
Host-only: pandas and the scorer registry; no model, no device.

Usage:
  python -m vla_rft_tpu_torch.trainer.main_eval data.path=out.parquet \
      [data.prompt_key=prompt] [data.response_key=responses] \
      [data.data_source_key=data_source] [data.reward_model_key=reward_model]
"""
from __future__ import annotations

import sys
from collections import defaultdict


def _get(row, key, default=None):
    try:
        v = row[key]
    except (KeyError, IndexError):
        return default
    return v


def evaluate_parquet(
    path: str,
    prompt_key: str = "prompt",
    response_key: str = "responses",
    data_source_key: str = "data_source",
    reward_model_key: str = "reward_model",
    compute_score=None,
):
    import numpy as np
    import pandas as pd

    from vla_rft_tpu_torch.utils.fs import copy_to_local
    from vla_rft_tpu_torch.utils.reward_score import default_compute_score

    compute_score = compute_score or default_compute_score
    df = pd.read_parquet(copy_to_local(path))
    passes = defaultdict(list)  # source -> per-sample best-of-N
    means = defaultdict(list)  # source -> per-sample mean@N
    for _, row in df.iterrows():
        responses = row[response_key]
        if isinstance(responses, str):
            responses = [responses]
        src = _get(row, data_source_key, "unknown")
        rm_info = _get(row, reward_model_key, {}) or {}
        gt = rm_info.get("ground_truth") if isinstance(rm_info, dict) else rm_info
        scores = [float(compute_score(src, str(r), str(gt))) for r in responses]
        passes[src].append(float(np.max(scores)))
        means[src].append(float(np.mean(scores)))
    result = {}
    for src in passes:
        n = len(df[df[data_source_key] == src]) if data_source_key in df else len(passes[src])
        result[f"test_score/{src}/pass@1"] = float(sum(means[src]) / max(len(means[src]), 1))
        result[f"test_score/{src}/best@n"] = float(sum(passes[src]) / max(len(passes[src]), 1))
        result[f"test_score/{src}/count"] = n
    return result


def run(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    path = kv.get("data.path")
    if not path:
        raise SystemExit("data.path=<parquet> is required")
    result = evaluate_parquet(
        path,
        prompt_key=kv.get("data.prompt_key", "prompt"),
        response_key=kv.get("data.response_key", "responses"),
        data_source_key=kv.get("data.data_source_key", "data_source"),
        reward_model_key=kv.get("data.reward_model_key", "reward_model"),
    )
    for k, v in sorted(result.items()):
        print(f"{k}: {v}")
    return result


if __name__ == "__main__":
    run()
