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
                responses (host), minus kl_coef x KL(old || ref) with
                algorithm.use_kl_in_reward
  adv           gae / grpo / rloo / reinforce_plus_plus / remax (the greedy
                rollout of the unique prompts as the baseline)
  update        ppo_epochs x mini-batches of ppo_mini_batch_size rows: the
                critic's update (gae), then the actor's once critic_warmup
                steps have passed; each a forward and a backward through
                left-padded rows (#1, then #2 and #3 per layer)

Each stage ends in a device synchronize, so `timing_s/*` is what the stage
took.  Sampling draws from the caller's `torch.Generator`.  The reference's
mesh is not ported: `trainer.balance_batch` reorders rows over
`torch.distributed`'s world size (1 when it is not initialised, where the
reorder is a no-op, as the reference's is at dp x fsdp = 1).  Not ported
yet, refused by name: the reward models (`reward_model.enable`,
models/reward_model.py) and PRIME (`adv_estimator=prime` or
`reward_model.rm_type=prime`: trainer/prime_core.py, workers/prime_rm.py).
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
from vla_rft_tpu_torch.models.transformer import TransformerConfig
from vla_rft_tpu_torch.trainer import core_algos
from vla_rft_tpu_torch.trainer.optim import AdamW, clip_by_global_norm
from vla_rft_tpu_torch.utils.timers import timer, timing_metrics
from vla_rft_tpu_torch.utils.tracking import Tracking, append_to_dict, reduce_metrics
from vla_rft_tpu_torch.workers.llm_rollout import (LLMRolloutConfig, compute_log_probs,
                                                   generate_sequences)
from vla_rft_tpu_torch.workers.reward_manager import NaiveRewardManager


def refuse_unported(config: Config) -> None:
    """NotImplementedError for the settings whose modules are not ported."""
    prime = (config.algorithm.adv_estimator == "prime"
             or (config.get_path("reward_model.enable", False)
                 and config.get_path("reward_model.rm_type", "value_head") == "prime"))
    if prime:
        raise NotImplementedError(
            "PRIME (adv_estimator=prime / reward_model.rm_type=prime) needs "
            "trainer/prime_core.py and workers/prime_rm.py, not ported yet")
    if config.get_path("reward_model.enable", False):
        raise NotImplementedError(
            "reward_model.enable needs models/reward_model.py (the model-based reward), "
            "not ported yet")


def _sync(device: torch.device) -> None:
    """The end of a stage: wait for the device."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def _grads(loss: torch.Tensor, params: List[torch.nn.Parameter]) -> List[torch.Tensor]:
    """d loss / d params; zeros for a parameter the loss does not reach (as
    `jax.value_and_grad` gives them)."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]


class PPOTrainer:
    def __init__(
        self,
        config: Config,
        llm_cfg: TransformerConfig,
        tokenizer,
        dataset,
        critic_cfg: Optional[TransformerConfig] = None,
        reward_manager: Optional[NaiveRewardManager] = None,
        seed: int = 0,
        *,
        device="cuda",
    ):
        refuse_unported(config)
        self.config = config
        self.device = resolve_device(device)
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
        self.actor_params = list(self.llm.parameters())
        self._init_actor_optimizer()
        self.critic = None
        if self.use_critic:
            with torch.device(self.device):
                self.critic = CriticModel(critic_cfg or llm_cfg)
            init_random_(self.critic, seed + 1).train()
            self.critic_params = list(self.critic.parameters())
            self.critic_opt = AdamW(self.critic_params, config.critic.optim.get("lr", 1e-5))

    def _init_actor_optimizer(self) -> None:
        optim = self.config.actor_rollout_ref.actor.optim
        self.actor_opt = AdamW(self.actor_params, optim.get("lr", 1e-6),
                               weight_decay=optim.get("weight_decay", 0.01))

    @torch.no_grad()
    def load_actor(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """The policy's weights from a `Decoder` state dict.  The reference
        policy gets its own copy of the same weights (never an alias of the
        parameters the optimizer updates), and the optimizer starts afresh."""
        self.llm.load_state_dict(state_dict)
        self.ref.load_state_dict(state_dict)
        self._init_actor_optimizer()

    # ------------------------------------------------------------- stages
    def _gen(self, prompts: torch.Tensor, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        return generate_sequences(self.llm, gen, prompts, self.roll_cfg,
                                  prefix_share_n=self.share_n)

    def _gen_greedy(self, prompts: torch.Tensor, gen: torch.Generator) -> Dict[str, torch.Tensor]:
        """ReMax's baseline: the greedy rollout of the same prompts."""
        return generate_sequences(self.llm, gen, prompts,
                                  dataclasses.replace(self.roll_cfg, do_sample=False))

    def _logp(self, model, g: Dict[str, torch.Tensor], chunk: Optional[int]) -> torch.Tensor:
        """Log-probs of the responses under `model`, `chunk` rows a call."""
        B = g["input_ids"].shape[0]
        chunk = chunk or B
        return torch.cat([
            compute_log_probs(model, g["input_ids"][i:i + chunk], g["attention_mask"][i:i + chunk],
                              g["position_ids"][i:i + chunk], self.roll_cfg.response_length,
                              self.roll_cfg.temperature)[0]
            for i in range(0, B, chunk)])

    @torch.no_grad()
    def _values(self, g: Dict[str, torch.Tensor]) -> torch.Tensor:
        return compute_values(self.critic, g["input_ids"], g["attention_mask"],
                              g["position_ids"], self.roll_cfg.response_length)

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

    def _actor_update(self, mb: Dict[str, torch.Tensor]) -> Dict[str, float]:
        loss, metrics = self.actor_loss(mb)
        grads, norm = clip_by_global_norm(_grads(loss, self.actor_params),
                                          self.config.actor_rollout_ref.actor.grad_clip)
        self.actor_opt.step(grads)
        metrics["actor/grad_norm"] = norm  # before clipping
        return {k: float(v) for k, v in metrics.items()}

    def critic_loss(self, mb: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        vpreds = compute_values(self.critic, mb["input_ids"], mb["attention_mask"],
                                mb["position_ids"], self.roll_cfg.response_length)
        vf_loss, vf_clipfrac = core_algos.compute_value_loss(
            vpreds, mb["returns"], mb["values"], mb["response_mask"].float(),
            self.config.critic.get("cliprange_value", 0.5))
        return vf_loss, {"critic/vf_loss": vf_loss.detach(), "critic/vf_clipfrac": vf_clipfrac}

    def _critic_update(self, mb: Dict[str, torch.Tensor]) -> Dict[str, float]:
        loss, metrics = self.critic_loss(mb)
        grads, _ = clip_by_global_norm(_grads(loss, self.critic_params),
                                       self.config.critic.get("grad_clip", 1.0))
        self.critic_opt.step(grads)
        return {k: float(v) for k, v in metrics.items()}

    # ---------------------------------------------------------------- step
    def _advantages(self, batch, gen, token_level_rewards, values, mask, B: int, n: int):
        algo = self.config.algorithm
        est = algo.adv_estimator
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
            base = self._gen_greedy(
                torch.as_tensor(np.asarray(batch["input_ids"]), device=self.device), gen)
            bscores = self.reward_manager(
                base["responses"].cpu().numpy(), base["response_mask"].cpu().numpy(),
                list(batch["data_sources"]), list(batch["ground_truths"]))
            baselines = torch.as_tensor(bscores, device=self.device).sum(-1).repeat_interleave(n)
            return core_algos.compute_remax_outcome_advantage(token_level_rewards, baselines,
                                                              mask)
        raise NotImplementedError(est)

    def training_step(self, batch: Dict[str, Any], gen: torch.Generator) -> Dict[str, float]:
        cfg = self.config
        algo = cfg.algorithm
        n = cfg.actor_rollout_ref.rollout.n
        dev = self.device
        metrics: Dict[str, Any] = {}
        timing: Dict[str, float] = {}

        with timer("step", timing):
            prompts = torch.as_tensor(np.asarray(batch["input_ids"]), device=dev).to(torch.int32)
            B = prompts.shape[0]
            prompts = prompts.repeat_interleave(n, dim=0)
            with timer("gen", timing):
                g = self._gen(prompts, gen)
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
                scores = self.reward_manager(g["responses"].cpu().numpy(),
                                             g["response_mask"].cpu().numpy(), sources, gts)
                token_level_scores = torch.as_tensor(scores, device=dev)
                if algo.use_kl_in_reward:
                    kld = core_algos.kl_penalty(old_logp, ref_logp, algo.kl_penalty)
                    token_level_rewards = token_level_scores - algo.kl_ctrl.kl_coef * kld
                else:
                    token_level_rewards = token_level_scores

            with timer("adv", timing):
                mask = g["response_mask"].float()
                advantages, returns = self._advantages(batch, gen, token_level_rewards, values,
                                                       mask, B, n)
                _sync(dev)

            data = {"input_ids": g["input_ids"], "attention_mask": g["attention_mask"],
                    "position_ids": g["position_ids"], "response_mask": g["response_mask"],
                    "old_log_probs": old_logp, "ref_log_probs": ref_logp,
                    "advantages": advantages, "returns": returns}
            if values is not None:
                data["values"] = values
            del g

            if cfg.trainer.get("balance_batch", False):
                # contiguous rank blocks with near-equal token sums
                # (ray_trainer._balance_batch); a no-op on one process
                from vla_rft_tpu_torch.utils.seqlen_balancing import (
                    get_seqlen_balanced_partitions, log_seqlen_unbalance)

                world = _world_size()
                if world > 1:
                    seqlens = data["attention_mask"].sum(-1).cpu().numpy().astype(int).tolist()
                    parts = get_seqlen_balanced_partitions(seqlens, world, equal_size=True)
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
                        mb = {k: v[i:i + mini] for k, v in data.items()}
                        if self.use_critic:
                            append_to_dict(acc, self._critic_update(mb))
                        if cfg.trainer.critic_warmup <= self.global_steps:
                            append_to_dict(acc, self._actor_update(mb))
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
        nothing sets; the port has none.)"""
        from vla_rft_tpu_torch.trainer.metric_utils import (flatten_validation_metrics,
                                                            process_validation_metrics)
        from vla_rft_tpu_torch.utils.reward_score import compute_score_with_info, has_scorer

        cfg = self.config
        vk = cfg.actor_rollout_ref.rollout.get("val_kwargs", None)
        n = int(vk.get("n", 1)) if vk is not None else 1
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(self._seed + 99)

        batch = self.dataset.sample_batch(cfg.data.get("val_batch_size",
                                                       cfg.data.train_batch_size))
        prompts = torch.as_tensor(np.asarray(batch["input_ids"]), device=self.device)
        g = self._gen(prompts.to(torch.int32).repeat_interleave(n, dim=0), gen)
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
        prompts, validating every trainer.test_freq steps."""
        cfg = self.config
        logger = logger or Tracking(cfg.trainer.project_name, cfg.trainer.experiment_name,
                                    cfg.trainer.logger)
        gen = torch.Generator(device=self.device).manual_seed(self._seed + 7)
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
