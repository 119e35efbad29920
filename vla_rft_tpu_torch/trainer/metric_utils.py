"""Training metric families (port of vla_rft_tpu/trainer/metric_utils.py,
verl's metric_utils): reward / advantage / return statistics, throughput,
and the validation metrics of the PPO trainer's `validate()` (bootstrap
best / worst-of-n and majority vote per data source), which draw the
reference's numpy resamples and so give its numbers bit for bit."""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Any, Callable, Dict, List, Sequence, Tuple

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



# ------------------------------------------------------------ validation
def bootstrap_metric(data: Sequence[Any], subset_size: int,
                     reduce_fns: Sequence[Callable[[list], float]], n_bootstrap: int = 1000,
                     seed: int = 42) -> List[Tuple[float, float]]:
    """(mean, std) of each reduce_fn over n_bootstrap resamples of
    `subset_size` records drawn with replacement; one index matrix drawn up
    front, so every reduce_fn sees the same resamples."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(data), size=(n_bootstrap, subset_size))
    stats = [[] for _ in reduce_fns]
    for row in idx:
        subset = [data[i] for i in row]
        for acc, fn in zip(stats, reduce_fns):
            acc.append(fn(subset))
    return [(float(np.mean(s)), float(np.std(s))) for s in stats]


def calc_maj_val(data: Sequence[Dict[str, Any]], vote_key: str, val_key: str) -> float:
    """The `val_key` of the first record of the most common `vote_key`
    (ties go to the vote seen first)."""
    votes = [d[vote_key] for d in data]
    winner, _ = Counter(votes).most_common(1)[0]
    return next(d[val_key] for d in data if d[vote_key] == winner)


def process_validation_metrics(data_sources: Sequence[str], sample_inputs: Sequence[str],
                               infos_dict: Dict[str, Sequence[Any]]
                               ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """data_source -> variable -> {metric -> value}.  Per (source, prompt)
    group of n responses: mean@n / std@n of each variable and, for n > 1,
    bootstrap best@k / worst@k (and maj@k with a 'pred' variable) for k in
    the powers of two below n and n itself; 'pred' and 'final_reward' get
    no statistics of their own.  Each metric is then averaged over the
    source's prompts."""
    groups: Dict[Tuple[str, str], List[int]] = defaultdict(list)
    for i, (src, prompt) in enumerate(zip(data_sources, sample_inputs)):
        groups[(src, prompt)].append(i)

    acc: Dict[str, Dict[str, Dict[str, List[float]]]] = defaultdict(
        lambda: defaultdict(lambda: defaultdict(list)))
    for (src, _prompt), idxs in groups.items():
        n = len(idxs)
        preds = [infos_dict["pred"][i] for i in idxs] if "pred" in infos_dict else None
        for var, vals_all in infos_dict.items():
            if var in ("pred", "final_reward"):
                continue
            vals = [vals_all[i] for i in idxs]
            metric: Dict[str, float] = {f"mean@{n}": float(np.mean(vals)),
                                        f"std@{n}": float(np.std(vals))}
            if n > 1:
                ks = []
                k = 2
                while k < n:
                    ks.append(k)
                    k *= 2
                ks.append(n)
                records = [{"val": v, "pred": preds[j] if preds is not None else None}
                           for j, v in enumerate(vals)]
                fns: List[Callable[[list], float]] = [
                    lambda arr: max(d["val"] for d in arr),
                    lambda arr: min(d["val"] for d in arr),
                ]
                if preds is not None:
                    fns.append(lambda arr: calc_maj_val(arr, "pred", "val"))
                for k in ks:
                    res = bootstrap_metric(records, k, fns)
                    metric[f"best@{k}/mean"], metric[f"best@{k}/std"] = res[0]
                    metric[f"worst@{k}/mean"], metric[f"worst@{k}/std"] = res[1]
                    if preds is not None:
                        metric[f"maj@{k}/mean"], metric[f"maj@{k}/std"] = res[2]
            for mname, mval in metric.items():
                acc[src][var][mname].append(mval)

    return {src: {var: {m: float(np.mean(vs)) for m, vs in metrics.items()}
                  for var, metrics in per_var.items()}
            for src, per_var in acc.items()}


def flatten_validation_metrics(var2metric2val: Dict[str, Dict[str, Dict[str, float]]]
                               ) -> Dict[str, float]:
    """Logger keys `{section}/{source}/{variable}/{metric}`: the core
    variable ('acc' when present, else 'score') at the largest @n goes to
    'val-core' for its mean / std / maj / best metrics, everything else to
    'val-aux'."""
    out: Dict[str, float] = {}
    for src, per_var in var2metric2val.items():
        core_var = "acc" if "acc" in per_var else ("score" if "score" in per_var else None)
        for var, metrics in per_var.items():
            n_max = 0
            for name in metrics:
                try:
                    n_max = max(n_max, int(name.split("@")[-1].split("/")[0]))
                except ValueError:
                    pass
            for name, val in metrics.items():
                is_core = (var == core_var
                           and any(name.startswith(p) for p in ("mean", "std", "maj", "best"))
                           and f"@{n_max}" in name)
                sec = "val-core" if is_core else "val-aux"
                out[f"{sec}/{src}/{var}/{name}"] = val
    return out
