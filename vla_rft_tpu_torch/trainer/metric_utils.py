"""Training metric families (port of the step-metric part of
vla_rft_tpu/trainer/metric_utils.py, verl's metric_utils): reward /
advantage / return statistics and throughput.  The validation metrics
(bootstrap best-of-n, majority vote) belong to `validate()`, which is not
ported yet."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np


def compute_data_metrics(batch: Dict[str, Any], use_critic: bool = False) -> Dict[str, float]:
    m: Dict[str, float] = {}

    def _stats(name, arr):
        arr = np.asarray(arr, np.float32)
        m[f"{name}/mean"] = float(arr.mean())
        m[f"{name}/max"] = float(arr.max())
        m[f"{name}/min"] = float(arr.min())

    if "token_level_rewards" in batch:
        _stats("critic/rewards", np.asarray(batch["token_level_rewards"]).sum(-1))
    if "token_level_scores" in batch:
        _stats("critic/score", np.asarray(batch["token_level_scores"]).sum(-1))
    if "advantages" in batch:
        _stats("critic/advantages", batch["advantages"])
    if "returns" in batch:
        _stats("critic/returns", batch["returns"])
    if use_critic and "values" in batch:
        _stats("critic/values", batch["values"])
    if "old_log_probs" in batch:
        m["actor/old_log_prob_mean"] = float(np.asarray(batch["old_log_probs"], np.float32).mean())
    if "predicted_actions" in batch:
        m["actor/predicted_action_abs_mean"] = float(
            np.abs(np.asarray(batch["predicted_actions"], np.float32)).mean())
    return m


def compute_throughput_metrics(timing: Dict[str, float], num_sequences: int, num_frames: int,
                               n_devices: int, step_flops: float = 0.0,
                               peak_flops: float = 0.0) -> Dict[str, float]:
    """perf/*: sequences/s, predicted WM frames/s per device and, given the
    step's FLOPs estimate and the device peak, the whole step's MFU."""
    step_t = timing.get("step", None)
    out: Dict[str, float] = {}
    if step_t and step_t > 0:
        out["perf/seqs_per_sec"] = num_sequences / step_t
        out["perf/frames_per_sec_per_chip"] = num_sequences * num_frames / step_t / n_devices
        if step_flops and peak_flops:
            out["perf/mfu"] = step_flops / step_t / n_devices / peak_flops
    if "wm_rollout" in timing and timing["wm_rollout"] > 0:
        out["perf/wm_frames_per_sec_per_chip"] = (
            num_sequences * num_frames / timing["wm_rollout"] / n_devices)
    return out
