"""VLA-RFT GRPO trainer on one device (port of vla_rft_tpu/trainer/grpo_trainer.py).

The reference runs every stage as a jitted SPMD program over a mesh; here
each stage is eager PyTorch on one device (no mesh, no sharding), and the
reference's `_sync` at a stage boundary is a device synchronize, so the
`timing` dict means what it means there.  One `training_step`:

  encode_context  one frozen-VLM context forward per unique sample
  ac_rollout      sample_noisy_actions (after repeating each sample n times),
                  the stochastic flow rollout with the sigma net
  log_prob        the old log-probs of the chain (and the reference expert's
                  with use_kl_loss)
  process         tokenize each sample's frames once, the ctx_msp sequences
                  of every rollout and the gt action tokens
  wm_rollout      one shared-prefix WM rollout over each chunk of rollout
                  groups: each sample's n policy rows, then its gt-action row
                  (gt_branch_per_sample), its decode calls on the card
                  through kernel #4 ('hd' KV cache, the default) or #6
                  (world_model_rollout.rollout.kv_layout=heads); with
                  weights_int8 the int8 WM, whose 'hd' decode calls run
                  kernels #8, #4 and #9 (a 'heads' cache takes the
                  unfused int8 route, as in the reference)
  adv             context features and gt frames decoded once per sample,
                  the MSP reward (MAE + LPIPS) per reward chunk
  (advantage)     GRPO over the n rollouts of each sample
  update_actor    dual-clip PPO over mini-batches of micro-batches, per
                  module clipping, two-group AdamW, skip on non-finite

The stage compositions of the reward path (`process_stage`, `wm_rows`,
`wm_rollout_stage`, `reward_stage`) are module functions over a bundle, so
a caller holding only the WM-side models can drive them too.

Random draws: each step's generators are seeded from (seed, step, stream)
(the reference folds its key with the step, so a resumed run replays the
same draws); the WM gets one generator per chunk, as the reference folds in
the chunk index.  `training_step(..., pinned=...)` takes the noise dict,
the flow rollout's Gaussian draws and the PPO order from a caller instead
(a test hands it JAX's).  Not ported yet (they raise): REMAX advantages,
the action-space reward (use_ac_reward), the wm_logprob reward,
`validate()` and speculative WM decoding.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from vla_rft_tpu_torch import resolve_device
from vla_rft_tpu_torch.config import Config
from vla_rft_tpu_torch.data.synthetic import (SyntheticVLAConfig, SyntheticVLADataset,
                                              default_action_ranges, load_action_ranges)
from vla_rft_tpu_torch.models.action_head import sample_noisy_actions
from vla_rft_tpu_torch.models.factory import ModelBundle, build_models
from vla_rft_tpu_torch.models.transformer import Decoder, quantize_decoder_params
from vla_rft_tpu_torch.trainer import core_algos
from vla_rft_tpu_torch.trainer.config_check import validate_config
from vla_rft_tpu_torch.trainer.metric_utils import compute_throughput_metrics
from vla_rft_tpu_torch.trainer.optim import apply_updates_with_skip, make_optimizer
from vla_rft_tpu_torch.utils.checkpoint import CheckpointManager, should_save
from vla_rft_tpu_torch.utils.timers import timer, timing_metrics
from vla_rft_tpu_torch.utils.tracking import Tracking, reduce_metrics
from vla_rft_tpu_torch.workers import flow_actor
from vla_rft_tpu_torch.workers.processor import (add_context_frame, ctx_msp_process,
                                                 discretize_actions)
from vla_rft_tpu_torch.workers.reward import detokenize_response_frames, msp_reward
from vla_rft_tpu_torch.workers.wm_rollout import generate_sequences

STREAMS = {"noise": 0, "roll": 1, "wm": 2, "shuffle": 3}


def _sync(device: torch.device) -> None:
    """The end of a stage: wait for the device."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------ stage functions
@torch.no_grad()
def process_stage(b, action_ranges: torch.Tensor, raw_pixels_u8: torch.Tensor,
                  pred_actions: torch.Tensor, gt_actions: torch.Tensor, n_rep: int,
                  use_gt_ac: bool) -> Dict[str, torch.Tensor]:
    """The tokenizer worker's process (fsdp_workers.py:1841-1870) with each
    sample's frames tokenized once: raw pixels (B, T, H, W, C) uint8 per
    sample, predicted actions (B * n_rep, T-1, A) per rollout, gt actions
    (B, T-1, A) -> the ctx_msp fields of every rollout row, plus
    gt_action_ids (use_gt_ac) or the sample's frames with the context frame
    (pixels_w_ctx_unique, for a reward against real frames)."""
    pc = b.proc_cfg
    pixels, _ = add_context_frame(raw_pixels_u8.float() / 255.0, gt_actions)
    idx_c, idx_d = b.tokenizer.tokenize(pixels)
    idx_c, idx_d = idx_c.repeat_interleave(n_rep, 0), idx_d.repeat_interleave(n_rep, 0)
    pad = lambda a: torch.cat([a[:, :1], a, a[:, -1:]], dim=1)  # [a0, a, aT]
    out = ctx_msp_process(pc, idx_c, idx_d, pad(pred_actions), action_ranges)
    if use_gt_ac:
        gt_w = pad(gt_actions.repeat_interleave(n_rep, 0))
        out["gt_action_ids"] = (discretize_actions(gt_w[:, 1:], action_ranges, pc.action_bins)
                                + 2 * pc.visual_token_num).to(torch.int32)
    else:
        out["pixels_w_ctx_unique"] = pixels
    return out


@dataclasses.dataclass
class WMRows:
    """The rows of the step's WM rollout, in call order: the unique prompt
    heads, each row's prefix index, prompt tail and action tokens, the size
    of a prefix group, and `order` (call row i is the step's row order[i];
    the policy rows are 0..total-1, then the gt rows)."""
    prefixes: torch.Tensor
    prefix_map: np.ndarray
    tails: torch.Tensor
    actions: torch.Tensor
    group: int
    order: np.ndarray
    total: int


def wm_rows(b, wm_inputs: Dict[str, torch.Tensor], n_wm: int, use_gt_ac: bool,
            gt_per_sample: bool) -> WMRows:
    """The prompt head (everything before the first frame's action tokens)
    is shared by a sample's rows and prefilled once per sample.  With
    gt_per_sample each sample's gt-action row rides right after its n
    policy rows (groups of n + 1); with a gt row per rollout the gt rows
    follow all policy rows."""
    rc = b.roll_cfg
    prompt = wm_inputs["input_ids"][:, : rc.prompt_length]
    total = prompt.shape[0]
    dev = prompt.device
    p0 = rc.prompt_length - b.proc_cfg.action_dim
    pm = np.arange(total // n_wm).repeat(n_wm)
    tails, actions = prompt[:, p0:], wm_inputs["action_ids"]
    if gt_per_sample:
        B_u = total // n_wm
        gt_u = wm_inputs["gt_action_ids"][::n_wm]  # (B_u, T, A)
        order = np.concatenate([np.concatenate([np.arange(s * n_wm, (s + 1) * n_wm),
                                                [total + s]]) for s in range(B_u)])
        o = torch.as_tensor(order, device=dev)
        return WMRows(prompt[::n_wm, :p0], np.concatenate([pm, np.arange(B_u)])[order],
                      torch.cat([tails, gt_u[:, 0]])[o], torch.cat([actions, gt_u])[o],
                      n_wm + 1, order, total)
    if use_gt_ac:
        return WMRows(prompt[::n_wm, :p0], np.concatenate([pm, pm]), torch.cat([tails, tails]),
                      torch.cat([actions, wm_inputs["gt_action_ids"]]), n_wm,
                      np.arange(2 * total), total)
    return WMRows(prompt[::n_wm, :p0], pm, tails, actions, n_wm, np.arange(total), total)


def wm_rollout_stage(b, wm: Decoder, rows: WMRows, rows_per_call: int,
                     chunk_generator: Callable[[int], torch.Generator]):
    """The WM rollout of `rows`, chunked on group boundaries into calls of
    at most `rows_per_call` rows, call ci sampling from chunk_generator(ci).
    Returns (responses of the policy rows, of the gt rows or None)."""
    dev = rows.tails.device
    step_rows = max(rows.group, (rows_per_call // rows.group) * rows.group)
    outs = []
    for ci, i in enumerate(range(0, rows.tails.shape[0], step_rows)):
        sl = slice(i, i + step_rows)
        uniq, local = np.unique(rows.prefix_map[sl], return_inverse=True)
        outs.append(generate_sequences(
            wm, chunk_generator(ci), rows.tails[sl], rows.actions[sl], b.roll_cfg,
            shared_prefix=rows.prefixes[torch.as_tensor(uniq, device=dev)],
            prefix_map=torch.as_tensor(local, dtype=torch.int32, device=dev)))
    both = torch.cat(outs, dim=0)[torch.as_tensor(np.argsort(rows.order), device=dev)]
    gt = both[rows.total:] if both.shape[0] > rows.total else None
    return both[:rows.total], gt


@torch.no_grad()
def reward_stage(b, wm_inputs: Dict[str, torch.Tensor], responses: torch.Tensor,
                 gt_responses: Optional[torch.Tensor], n_wm: int, use_gt_ac: bool,
                 gt_per_sample: bool, rows_per_chunk: int):
    """The MSP reward of every row: the context frame's features decoded
    once per sample, the gt rollouts decoded to frames once per sample
    (gt_per_sample), then msp_reward per chunk of `rows_per_chunk` rows.
    Returns (rewards (rows, response_length) f32, metrics as floats)."""
    pc = b.proc_cfg
    total = responses.shape[0]
    dev = responses.device
    pm_branch = np.arange(total // n_wm).repeat(n_wm)
    _, ctx_feats = b.tokenizer.ctx_decode(wm_inputs["ctx_tokens"][::n_wm] - pc.visual_token_num)
    gt_frames = None
    if gt_per_sample:
        B_u = gt_responses.shape[0]
        gt_frames = detokenize_response_frames(b.tokenizer, pc, b.reward_cfg.num_frames,
                                               gt_responses, ctx_feats,
                                               torch.arange(B_u, device=dev))
    chunks, acc = [], {}
    for i in range(0, total, rows_per_chunk):
        sl = slice(i, i + rows_per_chunk)
        cmap = torch.as_tensor(pm_branch[sl], dtype=torch.int32, device=dev)
        kw = dict(ctx_feats=ctx_feats, ctx_map=cmap)
        if gt_per_sample:
            kw["real_frames"] = gt_frames[cmap.long()]
        elif use_gt_ac:
            kw["gt_responses"] = gt_responses[sl]
        else:
            kw["real_frames"] = wm_inputs["pixels_w_ctx_unique"][:, 2:][cmap.long()]
        r, m = msp_reward(b.tokenizer, b.lpips, pc, b.reward_cfg, responses[sl], **kw)
        chunks.append(r)
        for k, v in m.items():
            acc.setdefault(k, []).append(v)
    metrics = {k: float(torch.stack(v).float().mean()) for k, v in acc.items()}
    return torch.cat(chunks, dim=0), metrics


# ------------------------------------------------------------------- trainer
class VLARFTGRPOTrainer:
    def __init__(self, config: Config, preset: str = "libero", dataset=None,
                 action_ranges: Optional[np.ndarray] = None,
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
                 seed: Optional[int] = None, device="cuda"):
        """`params` maps some of vla / expert / wm / tokenizer / lpips to
        state dicts that replace the seeded random weights (a converted
        checkpoint, or a test's)."""
        self.config = config
        self.device = resolve_device(device)
        self._seed = seed if seed is not None else config.trainer.get("seed", 0)
        _refuse_unported(config)
        self.bundle: ModelBundle = build_models(config, preset, device=self.device,
                                                seed=self._seed)
        b = self.bundle
        self.dataset = dataset or SyntheticVLADataset(SyntheticVLAConfig(
            batch_size=config.data.train_batch_size, seq_len=b.policy_seq_len,
            num_action_tokens=b.vla_cfg.num_tokens, policy_image_size=b.policy_image_size,
            wm_image_size=b.image_size, num_frames=b.num_raw_frames,
            action_chunk=b.expert_cfg.num_actions_chunk, action_dim=b.expert_cfg.action_dim,
            proprio_dim=b.vla_cfg.proprio_dim, num_images=b.vla_cfg.num_images,
            seed=config.trainer.get("seed", 0)))
        if action_ranges is None:
            path = config.processor.get("action_ranges_path", None)
            action_ranges = (load_action_ranges(path) if path
                             else default_action_ranges(b.expert_cfg.action_dim))
        self.action_ranges = torch.as_tensor(action_ranges, device=self.device)
        self.ckpt = CheckpointManager(config.trainer.default_local_dir)
        self.global_steps = 0
        self._prefetched_batch = None
        self.total_training_steps = config.trainer.total_training_steps
        for problem in validate_config(config, 1):
            print(f"[config] WARNING: {problem}")
        self._use_wm_int8 = bool(config.world_model_rollout.rollout.get("weights_int8", False))
        self._wm_q, self._wm_q_src = None, None
        self._init_state(params)

    # ------------------------------------------------------------------ state
    @torch.no_grad()
    def _init_state(self, params):
        b = self.bundle
        for name, sd in (params or {}).items():
            getattr(b, name).load_state_dict({k: v.to(self.device) for k, v in sd.items()},
                                             strict=True)
        actor = self.config.actor_rollout_ref.actor
        self.expert_params = dict(b.expert.named_parameters())
        self.opt = make_optimizer(self.expert_params.items(), actor.optim,
                                  self.total_training_steps)
        self.ref_expert = (copy.deepcopy(b.expert).requires_grad_(False)
                           if actor.use_kl_loss else None)

    def _wm_gen_model(self) -> Decoder:
        """The WM the rollout decodes with: with weights_int8 an int8 copy,
        quantised (lazily) from the bf16 WM whenever its weights changed;
        else the bf16 WM itself."""
        wm = self.bundle.wm
        if not self._use_wm_int8:
            return wm
        src = tuple(p._version for p in wm.parameters())
        if self._wm_q is None or self._wm_q_src != src:
            cfg = dataclasses.replace(wm.cfg, weights_int8=True)
            with torch.device(self.device):
                q = Decoder(cfg)
            q.load_state_dict(quantize_decoder_params(wm.state_dict(), cfg), strict=True)
            self._wm_q, self._wm_q_src = q.eval().requires_grad_(False), src
        return self._wm_q

    def _generator(self, step: int, stream: str, chunk: int = 0) -> torch.Generator:
        seed = np.random.SeedSequence([self._seed + 1, step, STREAMS[stream], chunk])
        return torch.Generator(device=self.device).manual_seed(int(seed.generate_state(1)[0]))

    def put_batch(self, batch_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch_np.items()}

    # ---------------------------------------------------------------- stages
    @torch.no_grad()
    def encode(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        enc = {"input_ids": batch["input_ids"], "attention_mask": batch["attention_mask"],
               "labels": batch["labels"], "pixels": batch["pixel_values"]}
        return flow_actor.encode_context(self.bundle.vla, enc)

    @torch.no_grad()
    def _chunked_logp(self, expert, hidden, x_chain, proprio, size: Optional[int]):
        B = hidden.shape[0]
        size = B if not size or size >= B else size
        return torch.cat([flow_actor.logp_from_hidden(expert, hidden[i:i + size],
                                                      x_chain[i:i + size], proprio[i:i + size])
                          for i in range(0, B, size)], dim=0)

    def advantage(self, token_level_rewards, group_ids, num_groups: int):
        """compute_advantage for the VLA loop over the all-ones (B, chunk *
        action_dim) response mask."""
        cfg = self.config.algorithm
        b = self.bundle
        chunk_dims = b.expert_cfg.num_actions_chunk * b.expert_cfg.action_dim
        mask = torch.ones((token_level_rewards.shape[0], chunk_dims), dtype=torch.float32,
                          device=token_level_rewards.device)
        est = cfg.adv_estimator
        if est == "grpo":
            return core_algos.compute_grpo_outcome_advantage(
                token_level_rewards, mask, group_ids, num_groups, uniform_std=cfg.uniform_std)
        if est == "rloo":
            return core_algos.compute_rloo_outcome_advantage(token_level_rewards, mask,
                                                             group_ids, num_groups)
        if est == "reinforce_plus_plus_baseline":
            return core_algos.compute_reinforce_plus_plus_baseline_outcome_advantage(
                token_level_rewards, mask, group_ids, num_groups)
        if est == "reinforce_plus_plus":
            adv, ret = core_algos.compute_reinforce_plus_plus_outcome_advantage(
                token_level_rewards, torch.ones_like(token_level_rewards), cfg.gamma)
            reps = chunk_dims // adv.shape[-1]
            return adv.repeat_interleave(reps, -1), ret.repeat_interleave(reps, -1)
        raise NotImplementedError(est)

    def _update(self, stacked: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One PPO mini-batch: gradients accumulated over its M micro-batches
        (each divided by M, in f32), then one clipped, guarded step."""
        actor = self.config.actor_rollout_ref.actor
        expert = self.bundle.expert
        names = list(self.expert_params)
        params = [self.expert_params[n] for n in names]
        M = stacked["x_chain"].shape[0]
        g_acc = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        per_micro = []
        for m in range(M):
            mb = {k: v[m] for k, v in stacked.items()}
            loss, metrics = flow_actor.policy_loss_fn(expert, mb["hidden"].detach(), mb, actor)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            for acc, g in zip(g_acc, grads):
                if g is not None:
                    acc.add_(g.float() / M)
            per_micro.append({k: v.detach() for k, v in metrics.items()})
        grad_norm = apply_updates_with_skip(self.opt, dict(zip(names, g_acc)), actor.grad_clip)
        out = {k: torch.stack([m[k] for m in per_micro]).float().mean()
               for k in per_micro[0]}
        out["actor/grad_norm"] = grad_norm
        return out

    def _ppo_update(self, actor_batch: Dict[str, torch.Tensor], gen: torch.Generator,
                    order: Optional[np.ndarray] = None) -> Dict[str, float]:
        actor = self.config.actor_rollout_ref.actor
        select = ["x_chain", "advantages", "hidden", "old_log_probs", "proprio",
                  "predicted_actions", "gt_actions"]
        if actor.use_kl_loss:
            select.append("ref_log_probs")
        if actor.use_mse_loss or actor.get("log_mse_loss", False):
            select += ["flow", "gt_noisy_actions", "gt_timesteps"]
        data = {k: actor_batch[k] for k in select}
        total = data["x_chain"].shape[0]
        mini = actor.ppo_mini_batch_size
        micro = min(actor.ppo_micro_batch_size_per_gpu, mini)
        acc: Dict[str, list] = {}
        for epoch in range(actor.ppo_epochs):
            if order is not None:
                epoch_order = np.asarray(order)
            elif actor.get("shuffle", False):
                epoch_order = torch.randperm(total, generator=gen, device=gen.device).cpu().numpy()
            else:
                epoch_order = np.arange(total)
            for i in range(0, total, mini):
                idx = epoch_order[i: i + mini]
                # a short mini-batch is filled up to whole micro-batches with
                # repeats of its first row, weighted 0 by mb_mask
                pad = (-len(idx)) % micro
                mask = np.ones(len(idx) + pad, np.float32)
                if pad:
                    idx = np.concatenate([idx, np.repeat(idx[:1], pad)])
                    mask[-pad:] = 0.0
                it = torch.as_tensor(idx, device=self.device)
                mb = {k: v[it] for k, v in data.items()}
                mb["mb_mask"] = torch.as_tensor(mask, device=self.device)
                M = len(idx) // micro
                stacked = {k: v.reshape(M, micro, *v.shape[1:]) for k, v in mb.items()}
                for k, v in self._update(stacked).items():
                    acc.setdefault(k, []).append(v)
        return reduce_metrics({k: [float(x) for x in vs] for k, vs in acc.items()})

    # ----------------------------------------------------------- training step
    def training_step(self, batch_np: Dict[str, Any], step: int = 0,
                      next_batch_np: Optional[Dict[str, Any]] = None,
                      pinned: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """One GRPO step on a batch (numpy, or tensors already on the
        device).  `step` seeds the step's generators.  `pinned` may hold
        "noise" (the sample_noisy_actions dict of the B*n rollout rows),
        "flow_eps" ((K, B*n, C, A) Gaussian draws of the flow rollout),
        "rollout" (its result: predicted_actions and x_chain) and
        "ppo_order" (the row order of the PPO epoch), replacing the draws."""
        cfg, b, dev = self.config, self.bundle, self.device
        pinned = pinned or {}
        actor = cfg.actor_rollout_ref.actor
        n = cfg.actor_rollout_ref.rollout.n
        roll = cfg.world_model_rollout.rollout
        use_gt_ac = bool(roll.w_gt_ac and cfg.processor.use_img_gt_ac)
        gt_per_sample = use_gt_ac and bool(roll.get("gt_branch_per_sample", True))
        expert = b.expert
        metrics: Dict[str, Any] = {}
        timing: Dict[str, float] = {}

        with timer("step", timing):
            batch = (batch_np if all(isinstance(v, torch.Tensor) for v in batch_np.values())
                     else self.put_batch(batch_np))
            gt_actions = batch["actions"]
            B = gt_actions.shape[0]
            # 0 --- one frozen-VLM context encode per unique sample
            with timer("encode_context", timing):
                hidden_unique = self.encode(batch)
                _sync(dev)
            hidden = hidden_unique.repeat_interleave(n, 0)
            # 1 --- noise after repeating each sample n times
            gt_rep = gt_actions.repeat_interleave(n, 0)
            noise_dict = pinned.get("noise") or sample_noisy_actions(
                self._generator(step, "noise"), gt_rep, b.expert_cfg)
            proprio_rep = batch["proprio"].repeat_interleave(n, 0)
            actor_batch = {"hidden": hidden, "proprio": proprio_rep, "noise": noise_dict["noise"]}
            # 2 --- stochastic action rollout
            with timer("ac_rollout", timing):
                out = pinned.get("rollout") or flow_actor.rollout_from_hidden(
                    expert, self._generator(step, "roll"), hidden, noise_dict["noise"],
                    proprio_rep, b.expert_cfg.num_flow_steps, eps=pinned.get("flow_eps"))
                _sync(dev)
            actor_batch.update(out)
            actor_batch["gt_actions"] = gt_rep
            actor_batch.update({k: noise_dict[k] for k in ("flow", "gt_noisy_actions",
                                                           "gt_timesteps")})
            # 3 --- old (and reference) log-probs
            with timer("log_prob", timing):
                lp = cfg.actor_rollout_ref.rollout.get("log_prob_micro_batch_size_per_gpu", None)
                args = (hidden, actor_batch["x_chain"], proprio_rep, lp)
                actor_batch["old_log_probs"] = self._chunked_logp(expert, *args)
                if self.ref_expert is not None:
                    actor_batch["ref_log_probs"] = self._chunked_logp(self.ref_expert, *args)
                _sync(dev)
            if next_batch_np is not None:
                self._prefetched_batch = self.put_batch(next_batch_np)
            # 4 --- tokenize
            with timer("process", timing):
                wm_inputs = process_stage(b, self.action_ranges, batch["raw_pixel_values"],
                                          actor_batch["predicted_actions"], gt_actions, n,
                                          use_gt_ac)
                _sync(dev)
            # 5 --- WM rollout (+ the gt branch), chunked on group boundaries
            with timer("wm_rollout", timing):
                rows = wm_rows(b, wm_inputs, n, use_gt_ac, gt_per_sample)
                responses, gt_responses = wm_rollout_stage(
                    b, self._wm_gen_model(), rows,
                    int(roll.get("micro_batch_size", 16) or 16),
                    lambda ci: self._generator(step, "wm", ci))
                _sync(dev)
            # 6 --- reward per chunk of tokenizer_micro_batch_size rows
            with timer("adv", timing):
                rw = int(cfg.processor.get("tokenizer_micro_batch_size", 8) or 8)
                token_level_rewards, r_metrics = reward_stage(
                    b, wm_inputs, responses, gt_responses, n, use_gt_ac, gt_per_sample, rw)
                _sync(dev)
                metrics.update(r_metrics)
            # 7 --- advantage over the groups of n rollouts
            group_ids = torch.arange(B, device=dev).repeat_interleave(n)
            advantages, returns = self.advantage(token_level_rewards, group_ids, B)
            actor_batch["advantages"] = advantages
            # 8 --- PPO update
            with timer("update_actor", timing):
                metrics.update(self._ppo_update(actor_batch, self._generator(step, "shuffle"),
                                                pinned.get("ppo_order")))
                _sync(dev)
            r = token_level_rewards.float().sum(-1)
            a, rt = advantages.float(), returns.float()
            stats = {"critic/rewards/mean": r.mean(), "critic/rewards/max": r.max(),
                     "critic/rewards/min": r.min(), "critic/advantages/mean": a.mean(),
                     "critic/advantages/max": a.max(), "critic/advantages/min": a.min(),
                     "critic/returns/mean": rt.mean(), "critic/returns/max": rt.max(),
                     "critic/returns/min": rt.min(),
                     "actor/old_log_prob_mean": actor_batch["old_log_probs"].float().mean(),
                     "actor/predicted_action_abs_mean":
                         actor_batch["predicted_actions"].float().abs().mean()}
            metrics.update({k: float(v) for k, v in stats.items()})
        metrics.update(timing_metrics(timing))
        metrics.update(compute_throughput_metrics(
            timing, B * n, b.roll_cfg.num_frames, 1, step_flops=self._step_flops(B, n),
            peak_flops=self._peak_flops()))
        return metrics

    def _peak_flops(self) -> float:
        from vla_rft_tpu_torch.utils.flops_counter import device_peak_flops

        if self.device.type != "cuda":
            return 0.0
        return device_peak_flops(torch.cuda.get_device_name(self.device))

    def _step_flops(self, B: int, n: int) -> float:
        """The whole step's FLOPs estimate for perf/mfu."""
        from vla_rft_tpu_torch.utils.flops_counter import vla_rft_step_flops

        cfg, b = self.config, self.bundle
        roll = cfg.world_model_rollout.rollout
        return vla_rft_step_flops(
            num_sequences=B * n, num_uniques=B, wm_cfg=b.wm_cfg,
            prompt_len=b.roll_cfg.prompt_length, response_len=b.roll_cfg.response_length,
            num_frames=b.roll_cfg.num_frames,
            num_flow_steps=cfg.actor_rollout_ref.rollout.get("num_flow_steps", 10),
            ppo_epochs=cfg.actor_rollout_ref.actor.ppo_epochs,
            use_gt_branch=bool(roll.w_gt_ac and cfg.processor.use_img_gt_ac),
            gt_branch_per_sample=bool(roll.get("gt_branch_per_sample", True)))

    # ------------------------------------------------------------------- fit
    def fit(self, logger: Optional[Tracking] = None,
            on_step_start: Optional[Callable[[int], None]] = None,
            on_step_end: Optional[Callable[[int, Dict[str, float]], None]] = None):
        """Resume (resume_mode auto), then train to total_training_steps,
        logging each step and saving on the configured cadence.
        `on_step_start(step)` / `on_step_end(step, metrics)` bracket each
        training_step (a caller reading clocks or counters)."""
        cfg = self.config
        logger = logger or Tracking(cfg.trainer.project_name, cfg.trainer.experiment_name,
                                    cfg.trainer.logger)
        self._load_checkpoint()
        self.global_steps += 1
        batch = self.dataset.next_batch()
        self._prefetched_batch = None
        while self.global_steps <= self.total_training_steps:
            # the dataloader state before the prefetch draw: a resume at
            # step N + 1 must draw exactly this iteration's `nxt`
            self._dl_ckpt_state = self.dataset.state_dict()
            nxt = (self.dataset.next_batch() if self.global_steps < self.total_training_steps
                   else None)
            if on_step_start is not None:
                on_step_start(self.global_steps)
            metrics = self.training_step(batch, self.global_steps, next_batch_np=nxt)
            if on_step_end is not None:
                on_step_end(self.global_steps, metrics)
            batch = self._prefetched_batch if nxt is not None else None
            logger.log(metrics, self.global_steps)
            if should_save(self.global_steps, self.total_training_steps, cfg.trainer.save_freq,
                           cfg.trainer.save_last_freq, cfg.trainer.save_last_num):
                self._save_checkpoint()
            self.global_steps += 1
        logger.finish()

    # ------------------------------------------------------------ checkpoints
    def _save_checkpoint(self):
        dl_state = getattr(self, "_dl_ckpt_state", None) or self.dataset.state_dict()
        state = {"expert": self.bundle.expert.state_dict(), "opt_state": self.opt.state_dict(),
                 "step": self.global_steps, "dataloader": dict(dl_state)}
        return self.ckpt.save(self.global_steps, state)

    @torch.no_grad()
    def _load_checkpoint(self):
        if self.config.trainer.resume_mode == "disable":
            return
        step = self.ckpt.latest_step()
        if step is None:
            return
        state = self.ckpt.restore(step, map_location=self.device)
        self.bundle.expert.load_state_dict(state["expert"], strict=True)
        self.opt.load_state_dict(state["opt_state"])
        self.global_steps = int(state["step"])
        self.dataset.load_state_dict({k: int(v) for k, v in state["dataloader"].items()})

    def validate(self, *args, **kwargs):
        raise NotImplementedError("validate() is not ported yet")


NOT_PORTED = {
    "algorithm.adv_estimator=remax": lambda c: c.algorithm.adv_estimator == "remax",
    "trainer.use_ac_reward": lambda c: bool(c.trainer.use_ac_reward),
    "trainer.reward_fn=wm_logprob": lambda c: c.trainer.reward_fn == "wm_logprob",
    "validation (trainer.val_before_train / test_freq)": lambda c: bool(
        c.trainer.get("val_before_train", False)) or c.trainer.get("test_freq", -1) > 0,
    "world_model_rollout.rollout.speculative_k > 0": lambda c: int(
        c.world_model_rollout.rollout.get("speculative_k", 0) or 0) > 0,
}


def _refuse_unported(config: Config) -> None:
    for what, hit in NOT_PORTED.items():
        if hit(config):
            raise NotImplementedError(f"{what} is not ported yet")
