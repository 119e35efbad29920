"""Core PPO / GRPO algorithms (port of vla_rft_tpu/trainer/core_algos.py,
verl's core_algos): the KL controllers; the GRPO, GAE, REINFORCE++ (with
and without baseline), RLOO and REMAX advantages; `compute_rewards`,
`agg_loss`, the dual-clip PPO `compute_policy_loss`, `compute_value_loss`
and `kl_penalty`.  Groups are an int `group_ids` tensor (the trainer maps
uids to dense ids), so the group statistics are segment sums.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vla_rft_tpu_torch.ops.masked import masked_mean, masked_whiten


# ----------------------------------------------------------------- KL control
class FixedKLController:
    def __init__(self, kl_coef: float):
        self.value = kl_coef

    def update(self, current_kl, n_steps):
        pass


class AdaptiveKLController:
    """https://arxiv.org/pdf/1909.08593.pdf."""

    def __init__(self, init_kl_coef: float, target_kl: float, horizon: float):
        self.value = init_kl_coef
        self.target = target_kl
        self.horizon = horizon

    def update(self, current_kl: float, n_steps: int):
        # the reference clips in f32 (jnp.clip of the Python-float ratio)
        err = np.float32(float(current_kl) / self.target - 1)
        proportional_error = float(np.clip(err, np.float32(-0.2), np.float32(0.2)))
        self.value *= 1 + proportional_error * n_steps / self.horizon


def get_kl_controller(kl_ctrl_cfg):
    if kl_ctrl_cfg.type == "fixed":
        return FixedKLController(kl_coef=kl_ctrl_cfg.kl_coef)
    if kl_ctrl_cfg.type == "adaptive":
        assert kl_ctrl_cfg.horizon > 0
        return AdaptiveKLController(init_kl_coef=kl_ctrl_cfg.kl_coef,
                                    target_kl=kl_ctrl_cfg.target_kl, horizon=kl_ctrl_cfg.horizon)
    raise NotImplementedError(kl_ctrl_cfg.type)


# ------------------------------------------------------------- advantage fns
def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, ids.long(), x)


def _group_stats(scores: torch.Tensor, group_ids: torch.Tensor, num_groups: int):
    """Per-group mean, unbiased std and count; groups of one get mean 0, std 1."""
    counts = _segment_sum(torch.ones_like(scores), group_ids, num_groups)
    means = _segment_sum(scores, group_ids, num_groups) / torch.clamp(counts, min=1.0)
    sq = _segment_sum((scores - means[group_ids.long()]) ** 2, group_ids, num_groups)
    stds = torch.sqrt(sq / torch.clamp(counts - 1.0, min=1.0))
    means = torch.where(counts <= 1.0, torch.zeros_like(means), means)
    stds = torch.where(counts <= 1.0, torch.ones_like(stds), stds)
    return means, stds, counts


def compute_grpo_outcome_advantage(token_level_rewards, response_mask, group_ids, num_groups: int,
                                   epsilon: float = 1e-6, uniform_std: bool = False
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-group z-score of the summed reward, broadcast over the mask."""
    scores = token_level_rewards.sum(dim=-1)
    means, stds, counts = _group_stats(scores, group_ids, num_groups)
    g = group_ids.long()
    if uniform_std:  # the mean of the per-group stds
        present = counts > 0
        std = torch.where(present, stds, torch.zeros_like(stds)).sum() / torch.clamp(
            present.sum(), min=1)
        norm = (scores - means[g]) / (std + epsilon)
    else:
        norm = (scores - means[g]) / (stds[g] + epsilon)
    adv = norm[:, None] * response_mask
    return adv, adv


def compute_gae_advantage_return(token_level_rewards, values, response_mask, gamma: float,
                                 lam: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAE over the response, then masked whitening of the advantages."""
    T = values.shape[1]
    lastgaelam = torch.zeros(values.shape[0], dtype=values.dtype, device=values.device)
    adv_rev = []
    for t in reversed(range(T)):
        next_value = values[:, t + 1] if t + 1 < T else torch.zeros_like(lastgaelam)
        delta = token_level_rewards[:, t] + gamma * next_value - values[:, t]
        lastgaelam = delta + gamma * lam * lastgaelam
        adv_rev.append(lastgaelam)
    advantages = torch.stack(adv_rev[::-1], dim=1)
    returns = advantages + values
    return masked_whiten(advantages, response_mask), returns


def compute_reinforce_plus_plus_outcome_advantage(token_level_rewards, response_mask, gamma: float
                                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Discounted returns that restart after masked positions, whitened."""
    T = token_level_rewards.shape[1]
    running = torch.zeros(token_level_rewards.shape[0], dtype=token_level_rewards.dtype,
                          device=token_level_rewards.device)
    ret_rev = []
    for t in reversed(range(T)):
        running = token_level_rewards[:, t] + gamma * running
        ret_rev.append(running)
        running = running * response_mask[:, t]
    returns = torch.stack(ret_rev[::-1], dim=1)
    return masked_whiten(returns, response_mask) * response_mask, returns


def compute_reinforce_plus_plus_baseline_outcome_advantage(token_level_rewards, response_mask,
                                                           group_ids, num_groups: int):
    """Group-mean baseline, then masked whitening."""
    scores = token_level_rewards.sum(dim=-1)
    means, _, _ = _group_stats(scores, group_ids, num_groups)
    scores = scores - means[group_ids.long()]
    adv = masked_whiten(scores[:, None] * response_mask, response_mask)
    return adv, adv


def compute_rloo_outcome_advantage(token_level_rewards, response_mask, group_ids,
                                   num_groups: int):
    """Leave-one-out baseline: n / (n - 1) (score - group mean)."""
    scores = token_level_rewards.sum(dim=-1)
    means, _, counts = _group_stats(scores, group_ids, num_groups)
    g = group_ids.long()
    n = counts[g]
    scale = torch.where(n > 1, n / (n - 1), torch.ones_like(n))
    mean_term = torch.where(n > 1, means[g] * scale, torch.zeros_like(n))
    scores = torch.where(n > 1, scores * scale - mean_term, scores)
    adv = scores[:, None] * response_mask
    return adv, adv


def compute_remax_outcome_advantage(token_level_rewards, reward_baselines, response_mask):
    """Reward-to-go minus the greedy rollout's score."""
    masked = token_level_rewards * response_mask
    returns = torch.flip(torch.cumsum(torch.flip(masked, dims=[-1]), dim=-1), dims=[-1])
    return returns - reward_baselines[:, None] * response_mask, returns


def compute_rewards(token_level_scores, old_log_prob, ref_log_prob, kl_ratio):
    return token_level_scores - (old_log_prob - ref_log_prob) * kl_ratio


# ------------------------------------------------------------------- losses
def agg_loss(loss_mat: torch.Tensor, loss_mask: torch.Tensor, loss_agg_mode: str):
    """token-mean / seq-mean-token-sum / seq-mean-token-mean; fully-masked
    rows (the trainer's padding) drop out of the seq-mean denominators."""
    if loss_agg_mode == "token-mean":
        return masked_mean(loss_mat, loss_mask)
    row_tokens = loss_mask.sum(dim=-1)
    valid = (row_tokens > 0).to(loss_mat.dtype)
    n_valid = torch.clamp(valid.sum(), min=1.0)
    if loss_agg_mode == "seq-mean-token-sum":
        return (loss_mat * loss_mask).sum(dim=-1).sum() / n_valid
    if loss_agg_mode == "seq-mean-token-mean":
        per_seq = (loss_mat * loss_mask).sum(dim=-1) / torch.clamp(row_tokens, min=1.0)
        return (per_seq * valid).sum() / n_valid
    raise ValueError(f"Invalid loss_agg_mode: {loss_agg_mode}")


def compute_policy_loss(old_log_prob, log_prob, advantages, response_mask,
                        cliprange: Optional[float] = None, cliprange_low: Optional[float] = None,
                        cliprange_high: Optional[float] = None, clip_ratio_c: float = 3.0,
                        loss_agg_mode: str = "token-mean", log_prob_aggregated: bool = False):
    """Dual-clip PPO.  Returns (pg_loss, pg_clipfrac, ppo_kl, pg_clipfrac_lower)."""
    assert clip_ratio_c > 1.0
    cliprange_low = cliprange if cliprange_low is None else cliprange_low
    cliprange_high = cliprange if cliprange_high is None else cliprange_high
    if log_prob_aggregated:
        if advantages.dim() > 1 and advantages.shape[-1] > 1:
            advantages = (advantages * response_mask).sum(dim=-1, keepdim=True) / \
                response_mask.sum(dim=-1, keepdim=True)
        denom = response_mask.sum(dim=-1, keepdim=True)
        negative_approx_kl = (log_prob - old_log_prob) / denom
        mean = lambda v, m=None: v.mean()
    else:
        negative_approx_kl = log_prob - old_log_prob
        mean = lambda v, m=response_mask: masked_mean(v, m)
    ratio = torch.exp(negative_approx_kl)
    ppo_kl = mean(-negative_approx_kl)
    pg_losses1 = -advantages * ratio
    pg_losses2 = -advantages * torch.clamp(ratio, 1 - cliprange_low, 1 + cliprange_high)
    clip_pg_losses1 = torch.maximum(pg_losses1, pg_losses2)
    pg_clipfrac = mean((pg_losses2 > pg_losses1).float())
    pg_losses3 = -advantages * clip_ratio_c
    clip_pg_losses2 = torch.minimum(pg_losses3, clip_pg_losses1)
    pg_clipfrac_lower = mean(((clip_pg_losses2 > pg_losses3) & (advantages < 0)).float())
    pg_losses = torch.where(advantages < 0, clip_pg_losses2, clip_pg_losses1)
    if log_prob_aggregated:
        pg_loss = pg_losses.mean()
    else:
        pg_loss = agg_loss(pg_losses, response_mask, loss_agg_mode)
    return pg_loss, pg_clipfrac, ppo_kl, pg_clipfrac_lower


def compute_value_loss(vpreds, returns, values, response_mask, cliprange_value):
    vpredclipped = torch.clamp(vpreds, values - cliprange_value, values + cliprange_value)
    vf_losses1 = (vpreds - returns) ** 2
    vf_losses2 = (vpredclipped - returns) ** 2
    vf_loss = 0.5 * masked_mean(torch.maximum(vf_losses1, vf_losses2), response_mask)
    vf_clipfrac = masked_mean((vf_losses2 > vf_losses1).float(), response_mask)
    return vf_loss, vf_clipfrac


def kl_penalty(logprob: torch.Tensor, ref_logprob: torch.Tensor, penalty: str) -> torch.Tensor:
    if penalty == "kl":
        return logprob - ref_logprob
    if penalty == "abs":
        return (logprob - ref_logprob).abs()
    if penalty == "mse":
        return 0.5 * (logprob - ref_logprob) ** 2
    if penalty == "low_var_kl":
        kl = (ref_logprob - logprob) / 7.0  # the reference's scaling
        return torch.clamp(torch.exp(kl) - kl - 1, -10, 10)
    raise NotImplementedError(penalty)
