"""The flow-matching policy actor (port of vla_rft_tpu/workers/flow_actor.py).

* `encode_context`: the single multimodal VLM forward shared by serving,
  rollout, replay and the SFT trainers.  It is differentiable (the
  VLA-adapter SFT trainer trains the VLM through it); callers that do not
  train wrap it in `torch.no_grad()`.
* `generate_actions` / `rollout_from_hidden`: the stochastic flow rollout,
  K Euler steps x_{k+1} ~ N(x_k + dt * flow, sigma) with the sigma net,
  the chain stored in bf16 for the replay; `deterministic=True` is the plain
  Euler mean (REMAX's greedy baseline).  Gaussian draws come from a
  `torch.Generator`, or from `eps` (K, B, C, A) when a caller pins them
  (a test hands it the draws JAX made).
* `_replay_logp`, `compute_log_prob`, `logp_from_hidden`: the teacher-forced
  replay of the chain, the K steps folded into the batch, per-dim Gaussian
  log-probs in f32 (and the entropy of the sigma net).
* `policy_loss_fn`: dual-clip PPO + entropy bonus + the gated flow-matching
  MSE + the optional KL loss, with the VLM context detached (only the action
  expert trains).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from vla_rft_tpu_torch.models.action_head import ActionExpert
from vla_rft_tpu_torch.models.prismatic import OpenVLA
from vla_rft_tpu_torch.trainer import core_algos

LOG_2PI = math.log(2.0 * math.pi)
CONST_ENTROPY = 0.5 * (LOG_2PI + 1.0)  # 0.5 log(2 pi e)


def encode_context(vla: OpenVLA, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch input_ids/pixels/labels/attention_mask -> the DiT's context
    (B, total_patches + num_tokens, llm_dim)."""
    return vla.encode_context(
        batch["input_ids"], batch["pixels"], batch["labels"], batch["attention_mask"]
    )


def _euler_mean(x: torch.Tensor, flow: torch.Tensor, K: int) -> torch.Tensor:
    """x + dt * flow, f32 from bf16 operands: the reference writes it in the
    chain's dtype (dt and the flow cast to bf16), but XLA, allowed excess
    precision, keeps the product and the sum in f32 until the chain stores
    bf16.  With this rounding the replay's log-probs equal the reference's
    bit for bit (tests/test_torch_grpo.py); inside a larger jitted program
    XLA may also keep other intermediates in f32, so a chain can land one
    bf16 ulp from the reference's."""
    dt = torch.tensor(-1.0 / K, dtype=x.dtype).float()
    return x.float() + dt * flow.to(x.dtype).float()


@torch.no_grad()
def generate_actions(vla: OpenVLA, expert: ActionExpert, gen: Optional[torch.Generator],
                     batch: Dict[str, torch.Tensor], num_flow_steps: int = 10,
                     eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Encode the context, then the stochastic rollout from batch["noise"]."""
    hidden = encode_context(vla, batch)
    return rollout_from_hidden(expert, gen, hidden, batch["noise"], batch["proprio"],
                               num_flow_steps, eps=eps)


@torch.no_grad()
def rollout_from_hidden(expert: ActionExpert, gen: Optional[torch.Generator],
                        hidden: torch.Tensor, noise: torch.Tensor, proprio: torch.Tensor,
                        num_flow_steps: int = 10, deterministic: bool = False,
                        eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """K flow steps from `noise` (B, C, A) given the VLM context: the DiT
    sees time k / K, the mean is x + dt * flow in bf16, the next point is
    mean + clip(std, 1e-6) * eps drawn in f32 and stored in bf16.  Returns
    predicted_actions (B, C, A) and x_chain (B, K+1, C, A), bf16."""
    x = noise.to(torch.bfloat16)
    K = num_flow_steps
    B = x.shape[0]
    chain = [x]
    for k in range(K):
        t = torch.full((B,), float(k), dtype=torch.float32, device=x.device) / K
        flow = expert.predict_flow(hidden, x, t, proprio)
        mean_next = _euler_mean(x, flow, K)
        if deterministic:
            x = mean_next.to(torch.bfloat16)
        else:
            std, _ = expert.predict_std(hidden, x, t, proprio)
            e = (eps[k].to(x.device, torch.float32) if eps is not None
                 else torch.randn(x.shape, generator=gen, dtype=torch.float32, device=x.device))
            x = (mean_next + torch.clamp(std.float(), min=1e-6) * e).to(torch.bfloat16)
        chain.append(x)
    return {"predicted_actions": x, "x_chain": torch.stack(chain, dim=1)}


def _replay_logp(expert: ActionExpert, hidden: torch.Tensor, x_chain: torch.Tensor,
                 proprio: torch.Tensor, return_entropy: bool, step_chunks: int = 2):
    """Replay the chain with the K steps folded into the batch, in
    `step_chunks` DiT calls of B * K / step_chunks rows: per-dim Gaussian
    log-prob of each x_{k+1} under N(x_k + dt flow, std) in f32, summed
    over steps -> (B, C*A) bf16; with `return_entropy` also the mean over
    the K + 1 chain points of log_std + 0.5 log(2 pi e) -> (B, C*A) bf16."""
    B, Kp1, C, A = x_chain.shape
    K = Kp1 - 1
    while K % step_chunks != 0:
        step_chunks += 1
    kc = K // step_chunks

    def fold(x):  # (B, K, C, A) -> (step_chunks, B*kc, C, A)
        return x.reshape(B, step_chunks, kc, C, A).transpose(0, 1).reshape(
            step_chunks, B * kc, C, A)

    x_in, x_next = fold(x_chain[:, :K]), fold(x_chain[:, 1:])
    ks = torch.arange(K, dtype=torch.float32, device=x_chain.device).reshape(step_chunks, kc)
    t_all = (ks[:, None, :] / K).expand(step_chunks, B, kc).reshape(step_chunks, B * kc)
    hid_rep = hidden.repeat_interleave(kc, dim=0)
    prop_rep = proprio.repeat_interleave(kc, dim=0)
    logp = torch.zeros((B, C, A), dtype=torch.float32, device=x_chain.device)
    ent = torch.zeros_like(logp)
    for c in range(step_chunks):
        x_k, x_k1, t = x_in[c], x_next[c], t_all[c]
        flow = expert.predict_flow(hid_rep, x_k, t, prop_rep)
        std, log_std = expert.predict_std(hid_rep, x_k, t, prop_rep)
        mean = _euler_mean(x_k, flow, K)
        sd = torch.clamp(std.float(), min=1e-6)
        z = (x_k1.float() - mean) / sd
        step_logp = -0.5 * z * z - torch.log(sd) - 0.5 * LOG_2PI
        logp = logp + step_logp.reshape(B, kc, C, A).sum(dim=1)
        if return_entropy:
            ent = ent + (log_std.float() + CONST_ENTROPY).reshape(B, kc, C, A).sum(dim=1)
    logp_vec = logp.reshape(B, C * A).to(torch.bfloat16)
    if return_entropy:
        return logp_vec, (ent / (K + 1)).reshape(B, C * A).to(torch.bfloat16)
    return logp_vec, None


def compute_log_prob(vla: OpenVLA, expert: ActionExpert, batch: Dict[str, torch.Tensor],
                     return_entropy: bool = False, stop_vlm_gradient: bool = True):
    """Encode the context and replay batch["x_chain"] (fully batched)."""
    hidden = encode_context(vla, batch)
    if stop_vlm_gradient:
        hidden = hidden.detach()
    logp, ent = _replay_logp(expert, hidden, batch["x_chain"], batch["proprio"],
                             return_entropy, step_chunks=1)
    return (logp, ent, hidden) if return_entropy else logp


def logp_from_hidden(expert: ActionExpert, hidden: torch.Tensor, x_chain: torch.Tensor,
                     proprio: torch.Tensor, return_entropy: bool = False):
    """The chain's log-probs (and entropy) given a precomputed context."""
    logp, ent = _replay_logp(expert, hidden, x_chain, proprio, return_entropy, step_chunks=1)
    return (logp, ent) if return_entropy else logp


def policy_loss_fn(expert: ActionExpert, hidden: torch.Tensor, batch: Dict[str, torch.Tensor],
                   cfg, global_mean=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The micro-batch loss (dp_actor.update_policy).  batch: x_chain,
    proprio, old_log_probs, advantages (B, C*A); optional mb_mask (rows the
    trainer repeated to fill a micro-batch, weight 0), flow /
    gt_noisy_actions / gt_timesteps (BC MSE), ref_log_probs (KL),
    gt_actions / predicted_actions (l1 metric).  cfg: the actor group.
    `global_mean`, when this rank holds a slice of the micro-batch, maps a
    mean over the slice's rows to the mean over the whole micro-batch's (the
    MSE gate reads the whole micro-batch's ppo_kl, as in the reference)."""
    new_logp, entropy = _replay_logp(
        expert, hidden, batch["x_chain"], batch["proprio"], True,
        step_chunks=int(cfg.get("replay_step_chunks", 2) or 2),
    )
    # one f32 view of the bf16 log-probs for every use: their gradients then
    # sum in f32 and round to bf16 once, as in the reference's backward
    new_logp = new_logp.float()
    old_logp = batch["old_log_probs"].float()
    advantages = batch["advantages"].float()
    response_mask = torch.ones_like(advantages)
    if "mb_mask" in batch:
        response_mask = response_mask * batch["mb_mask"].float()[:, None]
    row_w = response_mask[:, 0]
    n_valid = torch.clamp(row_w.sum(), min=1.0)

    clip_ratio = cfg.clip_ratio
    pg_loss, pg_clipfrac, ppo_kl, pg_clipfrac_lower = core_algos.compute_policy_loss(
        old_log_prob=old_logp, log_prob=new_logp, advantages=advantages,
        response_mask=response_mask, cliprange=clip_ratio,
        cliprange_low=cfg.get("clip_ratio_low", None) or clip_ratio,
        cliprange_high=cfg.get("clip_ratio_high", None) or clip_ratio,
        clip_ratio_c=cfg.get("clip_ratio_c", 3.0), loss_agg_mode=cfg.loss_agg_mode,
    )
    entropy_loss = core_algos.agg_loss(entropy.float(), response_mask, cfg.loss_agg_mode)
    policy_loss = pg_loss - entropy_loss * cfg.entropy_coeff
    metrics = {
        "actor/entropy": entropy_loss,
        "actor/pg_loss": pg_loss,
        "actor/pg_clipfrac": pg_clipfrac,
        "actor/ppo_kl": ppo_kl,
        "actor/pg_clipfrac_lower": pg_clipfrac_lower,
    }
    if cfg.get("log_l1_loss", False) and "gt_actions" in batch:
        l1_rows = (batch["predicted_actions"].float() - batch["gt_actions"].float()).abs()
        l1_rows = l1_rows.reshape(row_w.shape[0], -1).mean(dim=-1)
        metrics["actor/l1_loss"] = ((l1_rows * row_w).sum() / n_valid).detach()
    if cfg.get("use_mse_loss", False):
        # adaptive gate in [0, 1] from ppo_kl (dp_actor.py:465-489)
        kl = ppo_kl.detach() if global_mean is None else global_mean(ppo_kl.detach())
        t = (kl - cfg.mse_kl_low) / (cfg.mse_kl_high - cfg.mse_kl_low)
        mse_coef = cfg.mse_loss_coef * torch.clamp(t, 0.0, 1.0)
        flow_pred = expert.predict_flow(hidden, batch["gt_noisy_actions"],
                                        batch["gt_timesteps"].float(), batch["proprio"])
        sq = (flow_pred.float() - batch["flow"].float()) ** 2
        mse = (sq.reshape(row_w.shape[0], -1).mean(dim=-1) * row_w).sum() / n_valid
        policy_loss = policy_loss + mse * mse_coef
        metrics["actor/mse_loss"] = mse.detach()
        metrics["actor/mse_coef"] = mse_coef
    if cfg.get("use_kl_loss", False) and "ref_log_probs" in batch:
        kld = core_algos.kl_penalty(new_logp, batch["ref_log_probs"].float(),
                                    cfg.kl_loss_type)
        kl_loss = core_algos.agg_loss(kld, torch.ones_like(kld) * row_w[:, None],
                                      cfg.loss_agg_mode)
        policy_loss = policy_loss + kl_loss * cfg.kl_loss_coef
        metrics["actor/kl_loss"] = kl_loss
    return policy_loss, metrics
