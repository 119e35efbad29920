"""Text-RL PPO trainer on one device (port of vla_rft_tpu/trainer/ppo_trainer.py,
verl's RayPPOTrainer.fit for a text policy).

The whole policy LLM trains: AdamW over every parameter of a `Decoder`
after clipping by the global norm, with a frozen copy of the starting
weights as the reference policy.  One `training_step`:

  gen           the n rollouts of each prompt (`llm_rollout.generate_sequences`:
                kernel #1 for the prefill, #5 per decode call and layer, or
                #4 with rollout.prefix_share)
  old_log_prob  the policy's and the reference policy's log-probs of the
                responses, in row chunks of rollout.log_prob_micro_batch_size_per_gpu
                and ref.log_prob_micro_batch_size_per_gpu (rows are
                independent, so the chunks change no number; #1 per layer)
  values        with adv_estimator gae: the critic's values (#1 per layer)
  reward        the reward manager's token-level scores of the decoded
                responses (host); with reward_model.enable and the value-head
                RM (models/reward_model.py) the RM scores every row (#1 per
                layer and log-prob chunk) and the rule scorers override the
                rows whose data source has one; with reward_model.rm_type=
                prime, PRIME's implicit process scores and its RM's online
                update (workers/prime_rm.py: the RM's log-probs in chunks,
                the update's micro-batches of whole groups, in the order
                reward_model.update gives); minus
                kl_coef x KL(old || ref) with algorithm.use_kl_in_reward
  adv           gae / grpo / rloo / reinforce_plus_plus / remax (the greedy
                rollout of the unique prompts as the baseline) / prime (RLOO
                of the process scores and the outcome, trainer/prime_core.py)
  update        ppo_epochs x mini-batches of ppo_mini_batch_size rows: the
                critic's update (gae), then the actor's once critic_warmup
                steps have passed; each a forward and a backward through
                left-padded rows (#1, then #2 and #3 per layer)

Each stage ends in a device synchronize, so `timing_s/*` is what the stage
took; the RM's stages are also timed on their own (`timing_s/rm_score`,
and with PRIME `timing_s/rm_update`, and `timing_s/rm_ref_log_prob` when it
runs, inside `timing_s/reward`).  Sampling draws from the caller's `torch.Generator`.

Over ranks (a process group is up) the step computes the numbers of the
reference's SPMD program on the global batch.  config.mesh is resolved
against the world (the reference's ValueError for a mesh the world cannot
hold, at world 1 too); the data ranks are its (dp, fsdp) ranks, and tp /
sp ranks replicate (`parallel/mesh.py::DataRanks`).

  placement  the policy, the reference policy, the critic, the value-head
             RM and PRIME's RM are placed by `shard_params_fsdp` (FSDP2 at
             fsdp > 1), each with reshard_after_forward=False:
             `compute_log_probs` reads the LM head through `Decoder.logits`
             after the forward, outside FSDP2's hooks, so a trained tree
             stays whole from its forward to the end of its backward
  whole      the generation, the old / reference log-probs, the values and
             the RM scores run inside `mesh.gathered`: one all-gather of
             each tree per stage, none per decode call; only the updates
             run sharded
  rows       every rank draws the same global prompt batch and takes its
             (dp, fsdp) share of the unique prompts (a batch the ranks
             cannot split raises), repeated n times on the rank, so a group
             stays whole there; `fit` and `validate` fold the rank's data
             index into its sampling stream
  gathered   after each per-row stage its rows are all-gathered, so every
             rank holds the global rollout and computes the reward
             manager's scores, KL in the reward, every estimator (gae's
             whitening over the whole batch), prime_norm and
             balance_batch (over dp x fsdp) from it
  updates    the reference's global mini-batches (ppo_epochs x rows
             i:i+mini of the balanced data); each rank takes its share of
             one, its loss weighted so that the shares sum to the global
             loss (token-mean by the mini-batch's valid tokens, the
             seq-mean modes by its valid rows; the value loss by tokens),
             the gradients summed over the data ranks, clipped by the norm
             of the whole gradient, one AdamW step on every rank's shards;
             PRIME's RM update likewise over its micro-batches of whole
             groups; the actor/*, critic/*, prime/* and global_seqlen/*
             metrics are the global batch's on every rank
Only rank 0 logs.

The value-head RM keeps its seeded initialisation (seed + 2), as the
reference's: no entry point loads RM weights.  PRIME's RM starts as a copy
of the starting policy and its reference is the frozen reference policy
itself (neither ever trains), and `load_actor` loads them too (the
reference's main_ppo loads the policy only, so its PRIME RM stays at the
random initialisation).  PRIME's reference log-probs are those of the
reference policy when the rollout's temperature is 1 (the same module,
chunks and temperature give the same numbers); at another temperature
PRIME computes its own at temperature 1.  PRIME's update differentiates
micro-batches of actor.ppo_mini_batch_size rows rounded down to whole
groups of rollout.n; the decoder's `remat` (enable_gradient_checkpointing)
holds for the RM as for the policy, since both take the policy's config.
The port also reads reward_model.bon_mode (default none), which the
reference's trainer never hands to its worker.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from vla_rft_tpu_torch import resolve_device
from vla_rft_tpu_torch.config import Config
from vla_rft_tpu_torch.models.critic import CriticModel, compute_values
from vla_rft_tpu_torch.models.factory import build_decoder, init_random_
from vla_rft_tpu_torch.models.reward_model import SequenceRewardModel, compute_rm_score
from vla_rft_tpu_torch.models.transformer import TransformerConfig
from vla_rft_tpu_torch.parallel import distributed as pd
from vla_rft_tpu_torch.parallel import mesh as pm
from vla_rft_tpu_torch.trainer import core_algos, prime_core
from vla_rft_tpu_torch.trainer.config_check import resolve_mesh
from vla_rft_tpu_torch.trainer.optim import AdamW
from vla_rft_tpu_torch.utils.reward_score import has_scorer
from vla_rft_tpu_torch.utils.timers import timer, timing_metrics
from vla_rft_tpu_torch.utils.tracking import Tracking, append_to_dict, reduce_metrics
from vla_rft_tpu_torch.workers.llm_rollout import (LLMRolloutConfig, compute_log_probs,
                                                   generate_sequences)
from vla_rft_tpu_torch.workers.prime_rm import PRIMERewardWorker, PRIMERMConfig
from vla_rft_tpu_torch.workers.reward_manager import NaiveRewardManager


def _sync(device: torch.device) -> None:
    """The end of a stage: wait for the device."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class PPOTrainer:
    def __init__(
        self,
        config: Config,
        llm_cfg: TransformerConfig,
        tokenizer,
        dataset,
        critic_cfg: Optional[TransformerConfig] = None,
        reward_manager: Optional[NaiveRewardManager] = None,
        rm_cfg: Optional[TransformerConfig] = None,
        seed: int = 0,
        *,
        device="cuda",
    ):
        self.config = config
        self.world = pd.world_size()
        mesh_cfg = resolve_mesh(config, self.world)
        self.device = resolve_device(device)
        if self.world > 1 and self.device.type == "cuda" and self.device.index is None:
            self.device = pd.rank_device("cuda")
        self.mesh = pm.make_mesh(mesh_cfg, self.device.type) if self.world > 1 else None
        self.ranks = pm.DataRanks(self.mesh)
        self.is_rank0 = pd.rank() == 0
        self.tokenizer = tokenizer
        self.dataset = dataset
        self.reward_manager = reward_manager or NaiveRewardManager(tokenizer)
        self.use_critic = config.algorithm.adv_estimator == "gae"

        roll = config.actor_rollout_ref.rollout
        self.roll_cfg = LLMRolloutConfig(
            response_length=roll.response_length,
            temperature=roll.temperature,
            top_k=roll.get("top_k", -1),
            top_p=roll.get("top_p", 1.0),
            do_sample=roll.get("do_sample", True),
            eos_token_id=config.processor.get("eos_token_id", 2),
            pad_token_id=config.processor.get("pad_token_id", 0),
        )
        # the n rollouts of each prompt share its prefilled KV (rows are
        # repeat-contiguous) with rollout.prefix_share
        self.share_n = roll.n if roll.get("prefix_share", False) else 1
        self.global_steps = 0
        self._seed = seed

        self.llm = build_decoder(llm_cfg, device=self.device, seed=seed)
        self.ref = copy.deepcopy(self.llm).requires_grad_(False).eval()
        self.critic = None
        if self.use_critic:
            with torch.device(self.device):
                self.critic = CriticModel(critic_cfg or llm_cfg)
            init_random_(self.critic, seed + 1).train()
        # the reward models: the value-head RM scores every row, rule scorers
        # keep precedence (verl's RewardModelWorker, naive manager); PRIME's RM
        # starts from the starting policy, its reference is the frozen
        # reference policy
        self.rm = self.prime_rm = None
        rm_on = bool(config.get_path("reward_model.enable", False))
        prime = rm_on and config.get_path("reward_model.rm_type", "value_head") == "prime"
        prime_model = copy.deepcopy(self.llm) if prime else None
        if rm_on and not prime:
            with torch.device(self.device):
                self.rm = SequenceRewardModel(rm_cfg or llm_cfg)
            init_random_(self.rm, seed + 2).requires_grad_(False).eval()
        for m in (self.llm, self.ref, self.critic, self.rm, prime_model):
            if m is not None:
                pm.shard_params_fsdp(self.mesh, m, reshard_after_forward=False)
        self.actor_params = list(self.llm.parameters())
        self._init_actor_optimizer()
        if self.critic is not None:
            self.critic_params = list(self.critic.parameters())
            self.critic_opt = AdamW([pm.local(p) for p in self.critic_params],
                                    config.critic.optim.get("lr", 1e-5))
        if prime:
            rmc = config.reward_model
            self.prime_rm = PRIMERewardWorker(
                prime_model, self.ref, PRIMERMConfig(
                    response_length=self.roll_cfg.response_length,
                    beta=rmc.get("beta_train", 0.05),
                    granularity=rmc.get("prime_granularity", "token"),
                    norm_mode=rmc.get("prime_norm", "batch_norm"),
                    loss_type=rmc.get("loss_type", "ce"),
                    bon_mode=rmc.get("bon_mode", "none"),
                    lr=rmc.get("lr", 1e-6),
                    n_samples=roll.n,
                    score_micro_batch=roll.get("log_prob_micro_batch_size_per_gpu"),
                    ref_micro_batch=config.actor_rollout_ref.ref.get(
                        "log_prob_micro_batch_size_per_gpu"),
                    update_micro_batch=config.actor_rollout_ref.actor.ppo_mini_batch_size),
                ranks=self.ranks)

    def _init_actor_optimizer(self) -> None:
        optim = self.config.actor_rollout_ref.actor.optim
        self.actor_opt = AdamW([pm.local(p) for p in self.actor_params], optim.get("lr", 1e-6),
                               weight_decay=optim.get("weight_decay", 0.01))

    def _generator(self, seed: int) -> torch.Generator:
        """A sampling stream on the device: `seed` itself on the first data
        rank, with the rank's data index folded in on the others."""
        if self.ranks.index:
            seed = int(np.random.SeedSequence([seed, self.ranks.index]).generate_state(1)[0])
        return torch.Generator(device=self.device).manual_seed(seed)

    @torch.no_grad()
    def load_actor(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """The policy's weights from a `Decoder` state dict (on every rank,
        into its placed trees).  The reference policy gets its own copy of
        the same weights (never an alias of the parameters the optimizer
        updates), and the optimizer starts afresh; so does PRIME's RM, which
        starts from the policy."""
        pm.load_full_state_dict(self.llm, state_dict)
        pm.load_full_state_dict(self.ref, state_dict)
        self._init_actor_optimizer()
        if self.prime_rm is not None:
            self.prime_rm.load(state_dict)

    # ------------------------------------------------------------- stages
    def _gen(self, prompts: torch.Tensor, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        return generate_sequences(self.llm, gen, prompts, self.roll_cfg,
                                  prefix_share_n=self.share_n)

    def _gen_greedy(self, prompts: torch.Tensor, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """ReMax's baseline: the greedy rollout of the same prompts."""
        return generate_sequences(self.llm, gen, prompts,
                                  dataclasses.replace(self.roll_cfg, do_sample=False))

    def _on_rows(self, fn, g: Dict[str, torch.Tensor], *models) -> torch.Tensor:
        """fn(this rank's rows of the global rollout `g`) with `models` held
        whole (one all-gather of each), its rows gathered over the data
        ranks: the global (B, ...) result."""
        with pm.gathered(*models):
            return self.ranks.gather(fn(self.ranks.rows(g)))

    def _logp(self, model, g: Dict[str, torch.Tensor], chunk: Optional[int]) -> torch.Tensor:
        """Log-probs of the responses under `model`, `chunk` rows a call."""
        def fn(g):
            B = g["input_ids"].shape[0]
            c = chunk or B
            return torch.cat([
                compute_log_probs(model, g["input_ids"][i:i + c], g["attention_mask"][i:i + c],
                                  g["position_ids"][i:i + c], self.roll_cfg.response_length,
                                  self.roll_cfg.temperature)[0]
                for i in range(0, B, c)])

        return self._on_rows(fn, g, model)

    @torch.no_grad()
    def _rm_score(self, g: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The value-head RM's (B, R) scores (each row's at its last valid
        token), in row chunks of rollout.log_prob_micro_batch_size_per_gpu
        (rows are independent: the reference's one call gives the same)."""
        def fn(g):
            B = g["input_ids"].shape[0]
            c = self.config.actor_rollout_ref.rollout.get("log_prob_micro_batch_size_per_gpu") or B
            return torch.cat([
                compute_rm_score(self.rm, g["input_ids"][i:i + c], g["attention_mask"][i:i + c],
                                 g["position_ids"][i:i + c], self.roll_cfg.response_length)
                for i in range(0, B, c)])

        return self._on_rows(fn, g, self.rm)

    @torch.no_grad()
    def _values(self, g: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self._on_rows(lambda g: compute_values(
            self.critic, g["input_ids"], g["attention_mask"], g["position_ids"],
            self.roll_cfg.response_length), g, self.critic)

    def _share(self, mb: Dict[str, torch.Tensor]):
        """This rank's rows of a global mini-batch and their shares of its
        valid tokens and of its valid rows (1 and 1 at one rank)."""
        mine = self.ranks.rows(mb)
        if self.ranks.count == 1:
            return mine, (1.0, 1.0)
        m_g, m_l = mb["response_mask"].float(), mine["response_mask"].float()
        tokens = float(m_l.sum()) / max(float(m_g.sum()), 1.0)
        rows = float((m_l.sum(-1) > 0).sum()) / max(float((m_g.sum(-1) > 0).sum()), 1.0)
        return mine, (tokens, rows)

    def _summed(self, metrics: Dict[str, torch.Tensor], weights: Dict[str, float]):
        """Each metric times its weight, summed over the data ranks."""
        keys = list(metrics)
        t = self.ranks.sum(torch.stack([metrics[k].float() * weights[k] for k in keys]))
        return {k: float(v) for k, v in zip(keys, t.tolist())}

    def actor_loss(self, mb: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The PPO loss of a mini-batch: the policy-gradient loss minus
        entropy_coeff x entropy, plus kl_loss_coef x KL(policy || ref) with
        use_kl_loss; and its metrics (detached)."""
        a = self.config.actor_rollout_ref.actor
        lp, ent = compute_log_probs(self.llm, mb["input_ids"], mb["attention_mask"],
                                    mb["position_ids"], self.roll_cfg.response_length,
                                    self.roll_cfg.temperature, grad=True)
        mask = mb["response_mask"].float()
        pg_loss, clipfrac, ppo_kl, _ = core_algos.compute_policy_loss(
            mb["old_log_probs"], lp, mb["advantages"], mask, cliprange=a.clip_ratio,
            cliprange_low=a.get("clip_ratio_low", None) or a.clip_ratio,
            cliprange_high=a.get("clip_ratio_high", None) or a.clip_ratio,
            clip_ratio_c=a.get("clip_ratio_c", 3.0), loss_agg_mode=a.loss_agg_mode)
        ent_loss = core_algos.agg_loss(ent, mask, a.loss_agg_mode)
        loss = pg_loss - a.entropy_coeff * ent_loss
        if a.get("use_kl_loss", False):
            kld = core_algos.kl_penalty(lp, mb["ref_log_probs"], a.kl_loss_type)
            loss = loss + a.kl_loss_coef * core_algos.agg_loss(kld, mask, a.loss_agg_mode)
        return loss, {"actor/pg_loss": pg_loss.detach(), "actor/entropy": ent_loss.detach(),
                      "actor/pg_clipfrac": clipfrac, "actor/ppo_kl": ppo_kl.detach()}

    def _actor_update(self, mb: Dict[str, torch.Tensor], share=(1.0, 1.0)) -> Dict[str, float]:
        """One AdamW step on a mini-batch: `mb` is this rank's rows of it and
        `share` their shares of its valid tokens and rows (`_share`).  The
        loss and the metrics are weighted so that the ranks' sum is the
        mini-batch's: pg_loss and entropy as loss_agg_mode divides (tokens
        for token-mean, rows for the seq-mean modes), pg_clipfrac and
        ppo_kl, token means, by tokens."""
        a = self.config.actor_rollout_ref.actor
        tokens, rows = share
        w = tokens if a.loss_agg_mode == "token-mean" else rows
        loss, metrics = self.actor_loss(mb)
        self.ranks.backward(loss * w)
        out = self._summed(metrics, {"actor/pg_loss": w, "actor/entropy": w,
                                     "actor/pg_clipfrac": tokens, "actor/ppo_kl": tokens})
        out["actor/grad_norm"] = float(self.ranks.step(self.actor_params, [self.actor_opt],
                                                       a.grad_clip))  # before clipping
        return out

    def critic_loss(self, mb: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        vpreds = compute_values(self.critic, mb["input_ids"], mb["attention_mask"],
                                mb["position_ids"], self.roll_cfg.response_length)
        vf_loss, vf_clipfrac = core_algos.compute_value_loss(
            vpreds, mb["returns"], mb["values"], mb["response_mask"].float(),
            self.config.critic.get("cliprange_value", 0.5))
        return vf_loss, {"critic/vf_loss": vf_loss.detach(), "critic/vf_clipfrac": vf_clipfrac}

    def _critic_update(self, mb: Dict[str, torch.Tensor], share=(1.0, 1.0)) -> Dict[str, float]:
        """One AdamW step of the critic on this rank's rows of a mini-batch,
        the value loss and its clip fraction (token means) weighted by the
        rows' share of the valid tokens."""
        tokens = share[0]
        loss, metrics = self.critic_loss(mb)
        self.ranks.backward(loss * tokens)
        out = self._summed(metrics, dict.fromkeys(metrics, tokens))
        self.ranks.step(self.critic_params, [self.critic_opt],
                        self.config.critic.get("grad_clip", 1.0))
        return out

    # ---------------------------------------------------------------- step
    def _rollout(self, fn, prompts: torch.Tensor, gen: torch.Generator,
                 n: int = 1) -> Dict[str, torch.Tensor]:
        """`fn` (`_gen` or `_gen_greedy`) on this rank's share of the global
        unique `prompts`, each repeated `n` times on the rank, with the
        policy held whole; the rollout's rows gathered over the data ranks."""
        with pm.gathered(self.llm):
            g = fn(self.ranks.rows(prompts).repeat_interleave(n, dim=0), gen)
        return {k: self.ranks.gather(v) for k, v in g.items()}

    def _advantages(self, batch, gen, token_level_rewards, values, mask, B: int, n: int,
                    token_level_scores=None, prime_scores=None):
        algo = self.config.algorithm
        est = algo.adv_estimator
        if est == "prime":
            # RLOO of the process scores and of the outcome (the summed
            # verifier score), reward_dpo_coef / reward_gt_coef
            return prime_core.compute_prime_advantage(
                mask, n, rm_scores=prime_scores, acc=token_level_scores.sum(-1),
                reward_dpo_coef=algo.get("reward_dpo_coef", 5.0),
                reward_gt_coef=algo.get("reward_gt_coef", 5.0))
        if est == "gae":
            return core_algos.compute_gae_advantage_return(
                token_level_rewards, values, mask, algo.gamma, algo.lam)
        gids = torch.arange(B, dtype=torch.int32, device=self.device).repeat_interleave(n)
        if est == "grpo":
            return core_algos.compute_grpo_outcome_advantage(
                token_level_rewards, mask, gids, B, uniform_std=algo.uniform_std)
        if est == "rloo":
            return core_algos.compute_rloo_outcome_advantage(token_level_rewards, mask, gids, B)
        if est == "reinforce_plus_plus":
            return core_algos.compute_reinforce_plus_plus_outcome_advantage(
                token_level_rewards, mask, algo.gamma)
        if est == "remax":
            # the greedy rollout of each UNIQUE prompt, its score repeated n times
            base = self._rollout(self._gen_greedy, torch.as_tensor(
                np.asarray(batch["input_ids"]), device=self.device), gen)
            bscores = self.reward_manager(
                base["responses"].cpu().numpy(), base["response_mask"].cpu().numpy(),
                list(batch["data_sources"]), list(batch["ground_truths"]))
            baselines = torch.as_tensor(bscores, device=self.device).sum(-1).repeat_interleave(n)
            return core_algos.compute_remax_outcome_advantage(token_level_rewards, baselines,
                                                              mask)
        raise NotImplementedError(est)

    def _scores(self, g: Dict[str, torch.Tensor], sources: List[str], gts: List[str],
                timing: Dict[str, float]) -> torch.Tensor:
        """(B, R) token-level scores: the reward manager's; with the value-head
        RM, the RM's for every row and the reward manager's for the rows
        whose data source has a rule scorer."""
        resp, resp_mask = g["responses"].cpu().numpy(), g["response_mask"].cpu().numpy()
        if self.rm is None:
            return torch.as_tensor(self.reward_manager(resp, resp_mask, sources, gts),
                                   device=self.device)
        with timer("rm_score", timing):
            scores = self._rm_score(g).cpu().numpy()
        rule_rows = [i for i, s in enumerate(sources) if has_scorer(s)]
        if rule_rows:
            idx = np.asarray(rule_rows)
            scores[idx] = self.reward_manager(resp[idx], resp_mask[idx],
                                              [sources[i] for i in rule_rows],
                                              [gts[i] for i in rule_rows])
        return torch.as_tensor(scores, device=self.device)

    def _prime(self, g: Dict[str, torch.Tensor], acc: torch.Tensor, ref_logp: torch.Tensor,
               timing: Dict[str, float]) -> Tuple[torch.Tensor, Dict[str, float]]:
        """PRIME's process scores and its RM's update metrics, scoring and
        updating in the order reward_model.update gives (`after`: the scores
        of the weights before the update).  Both take one set of reference
        log-probs (the RM's weights do not change them): the reference
        policy's `ref_logp` at rollout temperature 1, else PRIME's own
        forward of the same module at temperature 1."""
        pr, dev = self.prime_rm, self.device
        seqs = (g["input_ids"], g["attention_mask"], g["position_ids"])
        ref_lp = ref_logp
        if self.roll_cfg.temperature != 1.0:
            with timer("rm_ref_log_prob", timing):
                ref_lp = pr.ref_log_probs(*seqs)
                _sync(dev)

        def score():
            with timer("rm_score", timing):
                out = pr.compute_rm_score(*seqs, ref_log_probs=ref_lp)
                _sync(dev)
            return out

        def update():
            with timer("rm_update", timing):
                out = pr.update_rm({"input_ids": seqs[0], "attention_mask": seqs[1],
                                    "position_ids": seqs[2], "acc": acc,
                                    "ref_log_probs": ref_lp})
                _sync(dev)
            return out

        if self.config.reward_model.get("update", "after") == "before":
            metrics = update()
            return score(), metrics
        scores = score()
        return scores, update()

    def training_step(self, batch: Dict[str, Any], gen: torch.Generator) -> Dict[str, float]:
        """One PPO step on a global batch of prompts (every rank passes the
        same batch; `gen` is this rank's sampling stream)."""
        cfg = self.config
        algo = cfg.algorithm
        n = cfg.actor_rollout_ref.rollout.n
        dev = self.device
        metrics: Dict[str, Any] = {}
        timing: Dict[str, float] = {}

        with timer("step", timing):
            prompts = torch.as_tensor(np.asarray(batch["input_ids"]), device=dev).to(torch.int32)
            B = prompts.shape[0]
            with timer("gen", timing):
                g = self._rollout(self._gen, prompts, gen, n)
                _sync(dev)

            with timer("old_log_prob", timing):
                old_logp = self._logp(
                    self.llm, g, cfg.actor_rollout_ref.rollout.get("log_prob_micro_batch_size_per_gpu"))
                ref_logp = self._logp(
                    self.ref, g, cfg.actor_rollout_ref.ref.get("log_prob_micro_batch_size_per_gpu"))
                _sync(dev)

            values = None
            if self.use_critic:
                with timer("values", timing):
                    values = self._values(g)
                    _sync(dev)

            with timer("reward", timing):
                sources = [s for s in batch["data_sources"] for _ in range(n)]
                gts = [t for t in batch["ground_truths"] for _ in range(n)]
                token_level_scores = self._scores(g, sources, gts, timing)
                prime_scores = None
                if self.prime_rm is not None:
                    # the outcome is the verifier's summed score
                    prime_scores, prime_metrics = self._prime(g, token_level_scores.sum(-1),
                                                              ref_logp, timing)
                    metrics.update(prime_metrics)
                if algo.use_kl_in_reward:
                    kld = core_algos.kl_penalty(old_logp, ref_logp, algo.kl_penalty)
                    token_level_rewards = token_level_scores - algo.kl_ctrl.kl_coef * kld
                else:
                    token_level_rewards = token_level_scores

            with timer("adv", timing):
                mask = g["response_mask"].float()
                advantages, returns = self._advantages(batch, gen, token_level_rewards, values,
                                                       mask, B, n, token_level_scores,
                                                       prime_scores)
                _sync(dev)

            data = {"input_ids": g["input_ids"], "attention_mask": g["attention_mask"],
                    "position_ids": g["position_ids"], "response_mask": g["response_mask"],
                    "old_log_probs": old_logp, "ref_log_probs": ref_logp,
                    "advantages": advantages, "returns": returns}
            if values is not None:
                data["values"] = values
            del g

            if cfg.trainer.get("balance_batch", False) and self.ranks.count > 1:
                # contiguous blocks of the dp x fsdp ranks with near-equal
                # token sums (ray_trainer._balance_batch); a no-op at one
                from vla_rft_tpu_torch.utils.seqlen_balancing import (
                    get_seqlen_balanced_partitions, log_seqlen_unbalance)

                seqlens = data["attention_mask"].sum(-1).cpu().numpy().astype(int).tolist()
                parts = get_seqlen_balanced_partitions(seqlens, self.ranks.count,
                                                       equal_size=True)
                order = torch.as_tensor([j for p in parts for j in p], device=dev)
                data = {k: v[order] for k, v in data.items()}
                metrics.update(log_seqlen_unbalance(seqlens, parts, "global_seqlen"))

            actor_cfg = cfg.actor_rollout_ref.actor
            mini = actor_cfg.ppo_mini_batch_size
            total = data["input_ids"].shape[0]
            acc: Dict[str, List[float]] = {}
            with timer("update", timing):
                for _ in range(actor_cfg.ppo_epochs):
                    for i in range(0, total, mini):
                        mb, share = self._share({k: v[i:i + mini] for k, v in data.items()})
                        if self.use_critic:
                            append_to_dict(acc, self._critic_update(mb, share))
                        if cfg.trainer.critic_warmup <= self.global_steps:
                            append_to_dict(acc, self._actor_update(mb, share))
                _sync(dev)
            metrics.update(reduce_metrics(acc))
            metrics["critic/score/mean"] = float(token_level_scores.sum(-1).mean())
            metrics["critic/rewards/mean"] = float(token_level_rewards.sum(-1).mean())
            metrics["critic/advantages/mean"] = float(advantages.mean())
            metrics["response_length/mean"] = float(mask.sum(-1).mean())

        metrics.update(timing_metrics(timing))
        return metrics

    # ------------------------------------------------------------ validate
    @torch.no_grad()
    def validate(self, gen: Optional[torch.Generator] = None) -> Dict[str, float]:
        """The reference's _validate: val_batch_size prompts of the dataset,
        each sampled val_kwargs.n times, scored by the rule scorers, and the
        bootstrap best / worst-of-n and majority-vote families per data
        source.  (The reference also reads a `val_dataset` attribute that
        nothing sets; the port has none.)  Over ranks each data rank samples
        its share of the prompts and every rank scores the gathered rows."""
        from vla_rft_tpu_torch.trainer.metric_utils import (flatten_validation_metrics,
                                                            process_validation_metrics)
        from vla_rft_tpu_torch.utils.reward_score import compute_score_with_info, has_scorer

        cfg = self.config
        vk = cfg.actor_rollout_ref.rollout.get("val_kwargs", None)
        n = int(vk.get("n", 1)) if vk is not None else 1
        if gen is None:
            gen = self._generator(self._seed + 99)

        batch = self.dataset.sample_batch(cfg.data.get("val_batch_size",
                                                       cfg.data.train_batch_size))
        prompts = torch.as_tensor(np.asarray(batch["input_ids"]), device=self.device)
        g = self._rollout(self._gen, prompts.to(torch.int32), gen, n)
        resp = g["responses"].cpu().numpy()
        resp_mask = g["response_mask"].cpu().numpy()

        sources = [s for s in batch["data_sources"] for _ in range(n)]
        gts = [t for t in batch["ground_truths"] for _ in range(n)]
        sample_inputs = [self.tokenizer.decode(np.asarray(ids).tolist())
                         for ids in batch["input_ids"] for _ in range(n)]
        infos: Dict[str, list] = {"score": [], "pred": []}
        for i in range(len(sources)):
            nv = int(resp_mask[i].sum())
            text = self.tokenizer.decode(resp[i, :nv].tolist()) if nv else ""
            if has_scorer(sources[i]):
                score, info = compute_score_with_info(sources[i], text, gts[i])
            else:
                score, info = 0.0, {}
            infos["score"].append(score)
            infos["pred"].append(info.get("pred", text.strip()[-40:]))
        out = flatten_validation_metrics(process_validation_metrics(sources, sample_inputs, infos))
        out["val/test_score/mean"] = float(np.mean(infos["score"]))
        return out

    def fit(self, logger: Optional[Tracking] = None) -> None:
        """trainer.total_training_steps steps of data.train_batch_size
        prompts, validating every trainer.test_freq steps; only rank 0
        logs."""
        cfg = self.config
        logger = logger or Tracking(cfg.trainer.project_name, cfg.trainer.experiment_name,
                                    cfg.trainer.logger if self.is_rank0 else [])
        gen = self._generator(self._seed + 7)
        test_freq = cfg.trainer.get("test_freq", -1)
        self.global_steps = 1
        while self.global_steps <= cfg.trainer.total_training_steps:
            batch = self.dataset.sample_batch(cfg.data.train_batch_size)
            metrics = self.training_step(batch, gen)
            if test_freq > 0 and self.global_steps % test_freq == 0:
                metrics.update(self.validate())
            logger.log(metrics, self.global_steps)
            self.global_steps += 1
        logger.finish()
