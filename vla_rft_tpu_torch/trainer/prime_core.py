"""PRIME's algorithms on tensors (port of vla_rft_tpu/trainer/prime_core.py,
verl's recipe/prime/prime_core_algos.py and prime_dp_rm.py's norm).

An LM "reward model" scores each response token as the log-ratio of its own
next-token log-prob to a frozen reference's (an implicit process reward
model), is trained online with a DPO-style loss against the verifier's
outcome, and the policy takes RLOO advantages over the process scores and
the outcome reward together.

Everything is vectorised over the (group, n_samples) structure: rows are
group-major (the n samples of a prompt are contiguous).  Host-free tensor
code; no kernel runs here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vla_rft_tpu_torch.ops.masked import masked_whiten


def masked_rloo(reward: torch.Tensor, mask: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Leave-one-out baseline over rollout groups (prime_core_algos.py:22-39).

    reward, mask: (B, S), B = n_groups * n_samples.  Per sample i the mean
    m_i of its masked rewards; the group's baseline sum(m) / (n - 1); the
    output r * n / (n - 1) - baseline at masked positions, 0 elsewhere."""
    B = reward.shape[0]
    m = mask.float()
    r = reward.float() * m
    per = r.sum(-1) / m.sum(-1).clamp_min(1.0)  # (B,) per-sample mean
    group_sum = per.reshape(-1, n_samples).sum(-1, keepdim=True)  # (G, 1)
    baseline = (group_sum / (n_samples - 1)).expand(B // n_samples, n_samples).reshape(B)
    return (r * (n_samples / (n_samples - 1)) - baseline[:, None]) * m


def _at_last(values: torch.Tensor, last: torch.Tensor, R: int) -> torch.Tensor:
    """(B, R) zeros with values[b] at column last[b]."""
    out = torch.zeros(values.shape[0], R, dtype=torch.float32, device=values.device)
    return out.scatter(1, last.long()[:, None], values.float()[:, None])


def compute_prime_advantage(
    response_mask: torch.Tensor,  # (B, R) 1/0
    n_samples: int,
    rm_scores: Optional[torch.Tensor] = None,  # (B, R) implicit-PRM token scores
    acc: Optional[torch.Tensor] = None,  # (B,) outcome correctness
    valid_response_length: Optional[torch.Tensor] = None,  # (B,)
    reward_dpo_coef: float = 1.0,
    reward_gt_coef: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """compute_rloo_advantage_return: RLOO of each reward source (the
    process scores; the outcome at the last valid token), summed; the
    reversed cumsum gives the returns, their masked whitening the
    advantages."""
    m = response_mask.float()
    B, R = m.shape
    total = torch.zeros(B, R, dtype=torch.float32, device=m.device)
    if rm_scores is not None and reward_dpo_coef != 0.0:
        total = total + reward_dpo_coef * masked_rloo(rm_scores, m, n_samples)
    if acc is not None and reward_gt_coef != 0.0:
        if valid_response_length is None:
            valid_response_length = m.sum(-1).to(torch.int32)
        last = (valid_response_length - 1).clamp_min(0)
        gt_reward = _at_last(acc, last, R)
        gt_mask = _at_last(torch.ones(B, device=m.device), last, R)
        total = total + reward_gt_coef * masked_rloo(gt_reward, gt_mask, n_samples)
    returns = torch.flip(torch.cumsum(torch.flip(total * m, [-1]), -1), [-1])
    return masked_whiten(returns, m), returns


def compute_ce_dpo_loss_rm(token_level_scores: torch.Tensor, acc: torch.Tensor,
                           response_mask: torch.Tensor, beta: float) -> torch.Tensor:
    """BCE(sigmoid(beta x the row's summed scores), acc), the mean over rows
    (prime_core_algos.py:79)."""
    q = torch.sigmoid((token_level_scores * response_mask).sum(-1) * beta)
    q = q.clamp(1e-7, 1 - 1e-7)
    return -(acc * torch.log(q) + (1 - acc) * torch.log(1 - q)).mean()


def compute_detach_dpo_loss_rm(
    token_level_scores: torch.Tensor,  # (B, R)
    acc: torch.Tensor,  # (B,)
    Q_bc: torch.Tensor,  # (B, n) the row's group's Q values (detached)
    acc_bc: torch.Tensor,  # (B, n) the row's group's accs
    response_mask: torch.Tensor,
    beta: float,
    bon_mode: str = "none",
) -> torch.Tensor:
    """DPO of each row against the mean Q of its group's members of the
    opposite outcome (prime_core_algos.py:84-116): the mean over rows; with
    `bon_rm` / `bon_acc` the sum weighted by n x (the share of the group the
    row's Q / acc is at least) ^ (n - 1), best-of-n."""
    n = acc_bc.shape[1]
    cur_q = (token_level_scores * response_mask).sum(-1) * beta  # (B,)
    pos = acc > 0
    sel = torch.where(pos[:, None], acc_bc < acc[:, None], acc_bc > acc[:, None]).float()
    cnt = sel.sum(-1)
    other_q = torch.where(cnt > 0, (Q_bc * sel).sum(-1) / cnt.clamp_min(1.0) * beta,
                          torch.zeros_like(cnt))
    sign = pos.float() * 2.0 - 1.0
    dpo = -F.logsigmoid((cur_q - other_q) * sign)
    if bon_mode == "none":
        return dpo.mean()
    if bon_mode == "bon_rm":
        frac = (Q_bc * beta <= cur_q[:, None]).float().mean(-1)
    elif bon_mode == "bon_acc":
        frac = (acc_bc <= acc[:, None]).float().mean(-1)
    else:
        raise NotImplementedError(bon_mode)
    weight = n * frac ** (n - 1)
    return (dpo * weight).sum()


def compute_dpo_accuracy(token_level_scores: torch.Tensor, acc: torch.Tensor,
                         response_mask: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Pairwise ranking accuracy of the summed scores against the outcomes
    within each group, weighted by |acc difference|; 0.5 for a group whose
    outcomes are all equal; the mean over groups (prime_core_algos.py:118-141)."""
    scores = (token_level_scores * response_mask).sum(-1)
    G = scores.shape[0] // n_samples
    s = scores.reshape(G, n_samples)
    a = acc.reshape(G, n_samples).float()
    sd = s[:, :, None] - s[:, None, :]
    ad = a[:, :, None] - a[:, None, :]
    triu = torch.triu(torch.ones(n_samples, n_samples, dtype=torch.bool, device=s.device),
                      diagonal=1)[None]
    w = ad.abs() * triu
    agree = ((sd > 0) == (ad > 0)).float()
    denom = w.sum((1, 2))
    per_group = torch.where(denom > 0, (agree * w).sum((1, 2)) / denom.clamp_min(1e-9),
                            torch.full_like(denom, 0.5))
    return per_group.mean()


def prime_norm(token_level_scores: torch.Tensor, mode: str = "batch_norm") -> torch.Tensor:
    """With `batch_norm`, the scores over the largest |reverse cumsum| of the
    whole batch (+ 1e-6), so that it becomes 1 (prime_dp_rm.py:194-198);
    any other mode leaves them as they are."""
    if mode != "batch_norm":
        return token_level_scores
    rc = torch.flip(torch.cumsum(torch.flip(token_level_scores, [-1]), -1), [-1])
    return token_level_scores / (rc.abs().max() + 1e-6)
