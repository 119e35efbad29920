"""Rewards of the GRPO step: the MSP reward, the WM log-prob reward and the
action-space reward.

Port of vla_rft_tpu/workers/reward.py.  `msp_reward`: split each response
into per-frame visual tokens, FSQ-decode them with the compressive
tokenizer (the context decode's features computed once per unique sample
and gathered per row), per-frame reconstruction loss (mae or mse) plus
LPIPS, weighted, aggregated over frames (mean, last or discounted), and the
negated loss written at the last response token.  `wm_logprob_reward`: the
teacher-forced WM log-likelihood of the recorded future under the policy's
action tokens, one WM forward (`wm_rollout.compute_log_prob`) instead of a
decode loop.  `ac_reward`: the element-wise negative l1 / mse / huber loss
between predicted and recorded actions.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

from vla_rft_tpu_torch.models.lpips import LPIPS
from vla_rft_tpu_torch.models.tokenizers import CompressiveVQModelFSQ
from vla_rft_tpu_torch.workers.processor import ProcessorConfig, split_response_tokens
from vla_rft_tpu_torch.workers.wm_rollout import compute_log_prob


@dataclasses.dataclass(frozen=True)
class RewardConfig:
    """trainer.reward_fn / loss_weight / msp_* (reference RewardConfig)."""

    reward_fn: str = "mae"  # mae | mse
    lpips_weight: float = 1.0
    recon_weight: float = 1.0  # loss_weight[reward_fn]
    msp_reward_aggregate: str = "mean"  # mean | last | discount
    msp_reward_discount: float = 0.95
    num_frames: int = 8


def _recon_loss(real: torch.Tensor, pred: torch.Tensor, kind: str) -> torch.Tensor:
    """(B, F, H, W, C) -> (B, F)."""
    if kind == "mse":
        return ((real - pred) ** 2).mean(dim=(2, 3, 4))
    if kind == "mae":
        return (real - pred).abs().mean(dim=(2, 3, 4))
    raise NotImplementedError(kind)


def perceptual_loss_frames(lpips: LPIPS, real: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """(B, F, H, W, C) in [0, 1] -> (B, F), LPIPS on inputs scaled to [-1, 1]."""
    B, Fn = real.shape[:2]
    r = real.reshape(B * Fn, *real.shape[2:]) * 2.0 - 1.0
    p = pred.reshape(B * Fn, *pred.shape[2:]) * 2.0 - 1.0
    return lpips(r, p).reshape(B, Fn)


def aggregate_msp(loss: torch.Tensor, cfg: RewardConfig) -> torch.Tensor:
    """(B, F) per-frame loss -> (B,)."""
    if cfg.msp_reward_aggregate == "mean":
        return loss.mean(dim=-1)
    if cfg.msp_reward_aggregate == "last":
        return loss[:, -1]
    if cfg.msp_reward_aggregate == "discount":
        Fn = loss.shape[1]
        w = cfg.msp_reward_discount ** torch.arange(Fn - 1, -1, -1, dtype=torch.float32,
                                                    device=loss.device)
        return (loss * w[None]).sum(dim=-1) / w.sum()
    raise NotImplementedError(cfg.msp_reward_aggregate)


def _gather(feats: Sequence[torch.Tensor], rows: torch.Tensor):
    return [f[rows] for f in feats]


def detokenize_response_frames(tokenizer: CompressiveVQModelFSQ, proc_cfg: ProcessorConfig,
                               num_frames: int, responses: torch.Tensor, ctx_feats,
                               feat_map: torch.Tensor) -> torch.Tensor:
    """FSQ-decode WM responses (N, response_length) to frames (N, F, H, W, C)
    in [0, 1]; row i uses context features ctx_feats[*][feat_map[i]]."""
    vis = split_response_tokens(proc_cfg, responses, num_frames)
    out = tokenizer.detokenize_dyn(vis, _gather(ctx_feats, feat_map.long()))
    return out.clamp(0.0, 1.0)


def msp_reward(tokenizer: CompressiveVQModelFSQ, lpips: LPIPS, proc_cfg: ProcessorConfig,
               reward_cfg: RewardConfig, responses: torch.Tensor,
               ctx_tokens: Optional[torch.Tensor] = None,
               real_frames: Optional[torch.Tensor] = None,
               gt_responses: Optional[torch.Tensor] = None, ctx_feats=None,
               ctx_map: Optional[torch.Tensor] = None, gt_map: Optional[torch.Tensor] = None,
               gt_feat_idx: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (reward (B, response_length) f32, metrics).

    Reward = -(recon * w + lpips * w) aggregated over frames, at the last
    response token.  With `ctx_feats`/`ctx_map` the context decode is
    skipped (features of unique samples, gathered per row); otherwise
    `ctx_tokens` (B, 1, Nc, offset) are decoded in full.  The real frames
    are `real_frames`, or the decode of `gt_responses` (one decoder call
    for both branches).  With `gt_map`, `gt_responses` holds U unique gt
    rollouts, decoded with the context rows `gt_feat_idx` (U,) (default:
    the rows' own), and row i is scored against decoded gt row gt_map[i]."""
    Fn = reward_cfg.num_frames
    vis = split_response_tokens(proc_cfg, responses, Fn)
    B = vis.shape[0]
    row_map = (ctx_map.long() if ctx_map is not None
               else torch.arange(B, device=responses.device))

    def detok(v, fmap):
        if ctx_feats is not None:
            return tokenizer.detokenize_dyn(v, _gather(ctx_feats, fmap))
        ctx_raw = (ctx_tokens - proc_cfg.visual_token_num)[fmap]
        return tokenizer.detokenize(ctx_raw, v)[:, 1:]  # drop the decoded ctx frame

    if gt_responses is not None:
        gt_vis = split_response_tokens(proc_cfg, gt_responses, Fn)
        gfm = gt_feat_idx.long() if gt_feat_idx is not None else row_map
        both = detok(torch.cat([vis, gt_vis]), torch.cat([row_map, gfm])).clamp(0.0, 1.0)
        pred, real = both[:B], both[B:]
        if gt_map is not None:
            real = real[gt_map.long()]
    else:
        if real_frames is None:
            raise ValueError("msp_reward needs real_frames or gt_responses")
        pred, real = detok(vis, row_map).clamp(0.0, 1.0), real_frames
    recon = _recon_loss(real, pred, reward_cfg.reward_fn)
    perc = perceptual_loss_frames(lpips, real, pred)
    loss = aggregate_msp(recon * reward_cfg.recon_weight + perc * reward_cfg.lpips_weight,
                         reward_cfg)
    reward = torch.zeros(responses.shape, dtype=torch.float32, device=responses.device)
    reward[:, -1] = -loss.float()
    return reward, {"critic/recon_loss/mean": recon.float().mean(),
                    "critic/perceptual_loss/mean": perc.float().mean()}


@torch.no_grad()
def wm_logprob_reward(wm, proc_cfg: ProcessorConfig, reward_cfg: RewardConfig,
                      input_ids: torch.Tensor, prompt_length: int, temperature: float = 1.0
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's extension reward (reward.py:183-227): the mean
    log-prob of each frame's dyn tokens in the teacher-forced WM forward
    over `input_ids` (B, prompt + response), the recorded frames' tokens
    interleaved with the policy's action tokens (ctx_msp_process's layout),
    aggregated over frames as the msp reward's loss is, at the last
    response token.  Returns (reward (B, response_length) f32, metrics)."""
    resp_len = input_ids.shape[1] - prompt_length
    lp = compute_log_prob(wm, input_ids, resp_len, temperature)
    Fn, tpf = reward_cfg.num_frames, proc_cfg.tokens_per_frame
    per_frame = tpf + proc_cfg.action_dim
    if resp_len != Fn * per_frame:
        raise ValueError(f"response length {resp_len} != {Fn} frames x {per_frame}")
    # the dyn tokens only: the action tokens are the policy's own inputs
    frame_ll = lp.reshape(lp.shape[0], Fn, per_frame)[:, :, :tpf].mean(dim=-1)  # (B, F)
    agg = aggregate_msp(-frame_ll, reward_cfg)
    reward = torch.zeros((input_ids.shape[0], resp_len), dtype=torch.float32,
                         device=input_ids.device)
    reward[:, -1] = -agg
    return reward, {"critic/wm_dyn_logprob/mean": frame_ll.mean()}


def ac_reward(gt_actions: torch.Tensor, predicted_actions: torch.Tensor,
              reward_type: str = "l1", huber_delta: float = 1.0
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The action-space reward (reference reward.py:230-253): the negative
    element-wise l1 / mse / huber loss of (B, C, A) predicted vs recorded
    actions in f32, (B, C * A), and the loss's mean."""
    B = gt_actions.shape[0]
    diff = predicted_actions.reshape(B, -1).float() - gt_actions.reshape(B, -1).float()
    absd = diff.abs()
    if reward_type == "l1":
        loss = absd
    elif reward_type == "mse":
        loss = diff ** 2
    elif reward_type == "huber":
        loss = torch.where(absd <= huber_delta, 0.5 * diff ** 2,
                           huber_delta * (absd - 0.5 * huber_delta))
    else:
        raise ValueError(reward_type)
    return -loss, {f"critic/{reward_type}_loss/mean": loss.mean()}
