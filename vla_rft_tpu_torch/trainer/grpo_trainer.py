"""VLA-RFT GRPO trainer over config.mesh's ranks (port of
vla_rft_tpu/trainer/grpo_trainer.py).

The reference runs every stage as a jitted SPMD program over a (dp, fsdp,
tp, sp) mesh; here each rank runs the stages eagerly, and the reference's
`_sync` at a stage boundary is a device synchronize, so the `timing` dict
means what it means there.  config.mesh is resolved against the world
(`parallel/mesh.py`, the reference's errors for a mesh that does not fit);
at world size 1 the trainer runs on one device as before.  Over ranks:

  rows      each rank takes its (dp, fsdp) share of the global batch's
            unique samples and repeats each n times, so a GRPO group stays
            on one rank; tp and sp ranks replicate (as in the reference's
            trainer, where shard_params_fsdp ignores them)
  params    the frozen towers, the WM and the trained expert are placed by
            `shard_params_fsdp` (FSDP2 at fsdp > 1, replicated at 1); a
            frozen tower is held whole for the stage that uses it
  draws     the flow noise, its eps, the ReMax baseline's noise and the PPO
            order are drawn for the global rows and sliced; each rank's WM
            and validation streams are its own
  reduced   rewards (and the ReMax baselines) are gathered, so advantages
            and the critic/* metrics are the global batch's; the update
            gathers the actor batch and walks the global mini-batches: each
            is one optimizer step on every rank, a rank taking its slice
            of each global micro-batch of ppo_micro_batch_size_per_gpu x
            (dp x fsdp) rows; its loss is weighted by its share of the
            micro-batch's valid rows (the token-mean denominator), the
            gradients summed over the ranks (FSDP2's reduce-scatter over
            fsdp, an all-reduce over dp and for replicated leaves), the
            clipping norm taken over the whole gradient, the actor/*
            metrics the micro-batch's
Only rank 0 logs, saves validation frames and writes checkpoints (the full
state, gathered from FSDP2); every rank loads one.  One `training_step`:

  encode_context  one frozen-VLM context forward per unique sample
  ac_rollout      sample_noisy_actions (after repeating each sample n times),
                  the stochastic flow rollout with the sigma net; with ReMax
                  also the deterministic Euler chain per unique sample (the
                  greedy baseline, from its own noise)
  log_prob        the old log-probs of the chain (and the reference expert's
                  with use_kl_loss)
  ac_reward       with trainer.use_ac_reward: the action-space reward (l1 /
                  mse / huber), and no process / WM / adv stage
  process         tokenize each sample's frames once, the ctx_msp sequences
                  of every rollout (with ReMax each sample's baseline row
                  after its n rollouts: groups of n + 1) and the gt action
                  tokens
  wm_rollout      one shared-prefix WM rollout over each chunk of rollout
                  groups: each sample's n (n + 1 with ReMax) policy rows,
                  then its gt-action row (gt_branch_per_sample; under
                  speculation the gt rows follow all policy rows), its
                  decode calls on the card through kernel #4 ('hd' KV
                  cache, the default) or #6
                  (world_model_rollout.rollout.kv_layout=heads); with
                  weights_int8 the int8 WM, whose 'hd' decode calls run
                  kernels #8, #4 and #9 (a 'heads' cache and speculative
                  decoding take the unfused int8 route, as in the
                  reference; a verify call runs #4 / #6 at Sq = 1 + k).
                  With trainer.reward_fn=wm_logprob this stage is one
                  teacher-forced WM forward (kernel #1) that gives the
                  reward, and there is no rollout
  adv             context features and gt frames decoded once per sample,
                  the MSP reward (MAE + LPIPS) per reward chunk; ReMax
                  strips the baseline rows after it
  (advantage)     GRPO over the n rollouts of each sample (or another
                  algorithm.adv_estimator; ReMax against the baseline)
  update_actor    dual-clip PPO over mini-batches of micro-batches, per
                  module clipping, two-group AdamW, skip on non-finite

The stage compositions of the reward path (`process_stage`, `wm_rows`,
`wm_rollout_stage`, `reward_stage`) are module functions over a bundle, so
a caller holding only the WM-side models can drive them too.  `validate()`
runs the rollout, the WM and the reward on the val stream without an
update; `fit` calls it with trainer.val_before_train (val_only stops there)
and every trainer.test_freq steps.

Random draws: each step's generators are seeded from (seed, step, stream)
(the reference folds its key with the step, so a resumed run replays the
same draws); the WM gets one generator per chunk, as the reference folds in
the chunk index.  `training_step(..., pinned=...)` takes the noise dict,
the flow rollout's Gaussian draws, the ReMax baseline's start and the PPO
order from a caller instead (a test hands it JAX's).  The trainer refuses a
speculative_k above 7 (config_check).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from vla_rft_tpu_torch import resolve_device
from vla_rft_tpu_torch.config import Config
from vla_rft_tpu_torch.data.synthetic import (SyntheticVLAConfig, SyntheticVLADataset,
                                              default_action_ranges, load_action_ranges)
from vla_rft_tpu_torch.models.action_head import sample_noisy_actions
from vla_rft_tpu_torch.models.factory import ModelBundle, build_models
from vla_rft_tpu_torch.models.transformer import Decoder, quantize_decoder_params
from vla_rft_tpu_torch.parallel import distributed as pd
from vla_rft_tpu_torch.parallel import mesh as pm
from vla_rft_tpu_torch.trainer import core_algos
from vla_rft_tpu_torch.trainer.config_check import (resolve_mesh, speculative_k_problem,
                                                    validate_config)
from vla_rft_tpu_torch.trainer.metric_utils import compute_throughput_metrics
from vla_rft_tpu_torch.trainer.optim import apply_updates_with_skip, make_optimizer
from vla_rft_tpu_torch.utils.checkpoint import CheckpointManager, should_save
from vla_rft_tpu_torch.utils.generations_logger import save_frame_grid
from vla_rft_tpu_torch.utils.timers import timer, timing_metrics
from vla_rft_tpu_torch.utils.tracking import Tracking, reduce_metrics
from vla_rft_tpu_torch.workers import flow_actor
from vla_rft_tpu_torch.workers.processor import (add_context_frame, ctx_msp_process,
                                                 discretize_actions, split_response_tokens)
from vla_rft_tpu_torch.workers.reward import (ac_reward, detokenize_response_frames, msp_reward,
                                              wm_logprob_reward)
from vla_rft_tpu_torch.workers.wm_rollout import generate_sequences

STREAMS = {"noise": 0, "roll": 1, "wm": 2, "shuffle": 3, "val": 4}
# the chunk index of the ReMax baseline's noise generator on the "noise"
# stream (the reference's fold_in(r_noise, 1_000_003))
REMAX_BASELINE_CHUNK = 1_000_003


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
            gt_per_sample: bool, interleave_gt: bool = True) -> WMRows:
    """The prompt head (everything before the first frame's action tokens)
    is shared by a sample's rows and prefilled once per sample.  With
    gt_per_sample each sample's gt-action row rides right after its n_wm
    policy rows (groups of n_wm + 1), or with `interleave_gt` off (the
    speculative rollout's layout in the reference) after all policy rows
    (groups of n_wm); with a gt row per rollout the gt rows follow all
    policy rows."""
    rc = b.roll_cfg
    prompt = wm_inputs["input_ids"][:, : rc.prompt_length]
    total = prompt.shape[0]
    dev = prompt.device
    p0 = rc.prompt_length - b.proc_cfg.action_dim
    prefix_map = np.arange(total // n_wm).repeat(n_wm)
    tails, actions = prompt[:, p0:], wm_inputs["action_ids"]
    if gt_per_sample:
        B_u = total // n_wm
        gt_u = wm_inputs["gt_action_ids"][::n_wm]  # (B_u, T, A)
        if interleave_gt:
            order = np.concatenate([np.concatenate([np.arange(s * n_wm, (s + 1) * n_wm),
                                                    [total + s]]) for s in range(B_u)])
        else:
            order = np.arange(total + B_u)
        o = torch.as_tensor(order, device=dev)
        return WMRows(prompt[::n_wm, :p0],
                      np.concatenate([prefix_map, np.arange(B_u)])[order],
                      torch.cat([tails, gt_u[:, 0]])[o], torch.cat([actions, gt_u])[o],
                      n_wm + 1 if interleave_gt else n_wm, order, total)
    if use_gt_ac:
        return WMRows(prompt[::n_wm, :p0], np.concatenate([prefix_map, prefix_map]),
                      torch.cat([tails, tails]),
                      torch.cat([actions, wm_inputs["gt_action_ids"]]), n_wm,
                      np.arange(2 * total), total)
    return WMRows(prompt[::n_wm, :p0], prefix_map, tails, actions, n_wm, np.arange(total),
                  total)


def wm_rollout_stage(b, wm: Decoder, rows: WMRows, rows_per_call: int,
                     chunk_generator: Callable[[int], torch.Generator],
                     stats: Optional[dict] = None):
    """The WM rollout of `rows`, chunked on group boundaries into calls of
    at most `rows_per_call` rows, call ci sampling from chunk_generator(ci);
    `stats` sums every call's counts (generate_sequences).  Returns
    (responses of the policy rows, of the gt rows or None)."""
    dev = rows.tails.device
    step_rows = max(rows.group, (rows_per_call // rows.group) * rows.group)
    outs = []
    for ci, i in enumerate(range(0, rows.tails.shape[0], step_rows)):
        sl = slice(i, i + step_rows)
        uniq, local = np.unique(rows.prefix_map[sl], return_inverse=True)
        outs.append(generate_sequences(
            wm, chunk_generator(ci), rows.tails[sl], rows.actions[sl], b.roll_cfg,
            shared_prefix=rows.prefixes[torch.as_tensor(uniq, device=dev)],
            prefix_map=torch.as_tensor(local, dtype=torch.int32, device=dev), stats=stats))
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
                 seed: Optional[int] = None, device="cuda", val_dataset=None):
        """`params` maps some of vla / expert / wm / tokenizer / lpips to
        state dicts that replace the seeded random weights (a converted
        checkpoint, or a test's).  `validate()` draws from `val_dataset`;
        with neither dataset given it is a second synthetic stream on seed
        trainer.seed + 99991 (held out: never trained on), and with only a
        training dataset it is that one (val/on_train_stream = 1).  Over
        ranks (a process group is up) config.mesh places the models."""
        self.config = config
        self.world = pd.world_size()
        mesh_cfg = resolve_mesh(config, self.world)
        self.device = resolve_device(device)
        if self.world > 1 and self.device.type == "cuda" and self.device.index is None:
            self.device = pd.rank_device("cuda")
        self.mesh = pm.make_mesh(mesh_cfg, self.device.type) if self.world > 1 else None
        self.ranks = pm.DataRanks(self.mesh)
        self.data_index, self.data_count = self.ranks.index, self.ranks.count
        self.is_rank0 = pd.rank() == 0
        self._sharded = set()  # the expert's FSDP-sharded parameter names
        self._seed = seed if seed is not None else config.trainer.get("seed", 0)
        _refuse(config)
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
        if val_dataset is None and dataset is None:
            val_dataset = SyntheticVLADataset(dataclasses.replace(
                self.dataset.cfg, seed=config.trainer.get("seed", 0) + 99991))
        self.val_dataset = val_dataset if val_dataset is not None else self.dataset
        self._val_on_train_stream = val_dataset is None
        if action_ranges is None:
            path = config.processor.get("action_ranges_path", None)
            action_ranges = (load_action_ranges(path) if path
                             else default_action_ranges(b.expert_cfg.action_dim))
        self.action_ranges = torch.as_tensor(action_ranges, device=self.device)
        self.ckpt = CheckpointManager(config.trainer.default_local_dir)
        self.global_steps = 0
        self._prefetched_batch = None
        self.total_training_steps = config.trainer.total_training_steps
        for problem in validate_config(config, self.data_count):
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
        self.ref_expert = (copy.deepcopy(b.expert).requires_grad_(False)
                           if actor.use_kl_loss else None)
        if self.mesh is not None:
            self._place()
        self.expert_params = dict(b.expert.named_parameters())
        # over FSDP the optimizer steps each rank's shards in place
        self.opt = make_optimizer([(n, pm.local(p)) for n, p in self.expert_params.items()],
                                  actor.optim, self.total_training_steps)

    def _place(self):
        """The reference's shard_params_fsdp of every tree: the frozen towers
        and the WM held whole only inside the stage that uses them
        (`_whole`), the expert through FSDP2's hooks on its two forward
        methods."""
        from torch.distributed.tensor import DTensor

        b, mesh = self.bundle, self.mesh
        for name in ("vla", "wm", "tokenizer", "lpips"):
            pm.shard_params_fsdp(mesh, getattr(b, name), reshard_after_forward=False)
        pm.shard_params_fsdp(mesh, b.expert)
        if pm.is_sharded(b.expert):
            from torch.distributed.fsdp import register_fsdp_forward_method

            for method in ("predict_flow", "predict_std"):
                register_fsdp_forward_method(b.expert, method)
        self._sharded = {n for n, p in b.expert.named_parameters() if isinstance(p, DTensor)}

    def _whole(self, *names: str):
        """Hold the named frozen trees whole (no-op unless FSDP-sharded)."""
        return pm.gathered(*(getattr(self.bundle, n) for n in names))

    def _wm_gen_model(self) -> Decoder:
        """The WM the rollout decodes with: with weights_int8 an int8 copy,
        quantised (lazily) from the bf16 WM whenever its weights changed;
        else the bf16 WM itself."""
        wm = self.bundle.wm
        if not self._use_wm_int8:
            return wm
        src = tuple(pm.local(p)._version for p in wm.parameters())
        if self._wm_q is None or self._wm_q_src != src:
            cfg = dataclasses.replace(wm.cfg, weights_int8=True)
            with torch.device(self.device):
                q = Decoder(cfg)
            # the int8 copy is whole on every rank (its products are buffers)
            q.load_state_dict(quantize_decoder_params(pm.full_state_dict(wm), cfg), strict=True)
            self._wm_q, self._wm_q_src = q.eval().requires_grad_(False), src
        return self._wm_q

    def _generator(self, step: int, stream: str, chunk: int = 0) -> torch.Generator:
        key = [self._seed + 1, step, STREAMS[stream], chunk]
        if stream in ("wm", "val") and self.data_index:
            key.append(self.data_index)  # each rank's rows draw their own stream
        seed = np.random.SeedSequence(key)
        return torch.Generator(device=self.device).manual_seed(int(seed.generate_state(1)[0]))

    # ------------------------------------------------------------------ ranks
    def _rows(self, x):
        """This rank's (dp, fsdp) share of a global tensor's rows."""
        return self.ranks.rows(x)

    def put_batch(self, batch_np: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch_np.items()}

    # ---------------------------------------------------------------- stages
    @torch.no_grad()
    def encode(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        enc = {"input_ids": batch["input_ids"], "attention_mask": batch["attention_mask"],
               "labels": batch["labels"], "pixels": batch["pixel_values"]}
        with self._whole("vla"):
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

    def advantage_remax(self, token_level_rewards, reward_baselines):
        """ReMax for the VLA loop (the reference's extension, grpo_trainer.py
        :663-698): each row's score (its reward sum) at the last entry of the
        (B, chunk * action_dim) grid, minus its sample's greedy baseline."""
        b = self.bundle
        chunk_dims = b.expert_cfg.num_actions_chunk * b.expert_cfg.action_dim
        scores = token_level_rewards.float().sum(-1)
        grid = torch.zeros((scores.shape[0], chunk_dims), dtype=torch.float32,
                           device=scores.device)
        grid[:, -1] = scores
        return core_algos.compute_remax_outcome_advantage(grid, reward_baselines.float(),
                                                          torch.ones_like(grid))

    def _update(self, data: Dict[str, torch.Tensor], idx: np.ndarray,
                mask: np.ndarray) -> Dict[str, torch.Tensor]:
        """One PPO mini-batch: M global micro-batches of the global rows
        `data`; each data rank takes its slice of each, weighted by its share
        w of the micro-batch's valid rows, so that the ranks' summed
        gradients and w-weighted metrics are the whole micro-batch's (every
        mean of the loss is over valid rows: the token-mean denominator is
        rows x C*A; at one rank w = 1).  The f32 parameters' gradients
        accumulate over the micro-batches (each loss divided by M); then one
        clipped, guarded step on gradients summed over the ranks."""
        actor = self.config.actor_rollout_ref.actor
        expert = self.bundle.expert
        D, d = self.data_count, self.data_index
        M, micro = idx.shape
        per = micro // D
        named = dict(expert.named_parameters())
        for p in named.values():
            p.grad = None
        per_micro = []
        for m in range(M):
            mine = slice(d * per, (d + 1) * per)
            w = float(mask[m, mine].sum() / max(mask[m].sum(), 1.0))
            it = torch.as_tensor(idx[m, mine], device=self.device)
            mb = {k: v[it] for k, v in data.items()}
            mb["mb_mask"] = torch.as_tensor(mask[m, mine], device=self.device)
            loss, metrics = flow_actor.policy_loss_fn(
                expert, mb["hidden"].detach(), mb, actor,
                global_mean=lambda x, w=w: self.ranks.sum(x * w))
            # FSDP and the all-reduces below average over the D ranks
            (loss * (w * D / M)).backward()
            per_micro.append({k: v.detach().float() * w for k, v in metrics.items()})
        keys = list(per_micro[0])
        table = torch.stack([torch.stack([row[k] for k in keys]) for row in per_micro])
        table = self.ranks.sum(table)
        grads = dict(zip(named, self.ranks.summed_grads(list(named.values()))))
        grad_norm = apply_updates_with_skip(
            self.opt, grads, actor.grad_clip,
            group_norm=lambda ns: self.ranks.norm([grads[n] for n in ns],
                                                  [named[n] for n in ns]))
        out = {k: table[:, i].mean() for i, k in enumerate(keys)}
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
        # a global micro-batch: ppo_micro_batch_size_per_gpu rows per data rank
        micro = min(actor.ppo_micro_batch_size_per_gpu * self.data_count, mini)
        if micro % self.data_count:
            raise ValueError(f"a micro-batch of {micro} rows does not split over "
                             f"{self.data_count} ranks")
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
                M = len(idx) // micro
                out = self._update(data, idx.reshape(M, micro), mask.reshape(M, micro))
                for k, v in out.items():
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
        "rollout" (its result: predicted_actions and x_chain), with ReMax
        "base_noise" ((B, C, A), the baseline chain's start) or
        "base_actions" (its result), and "ppo_order" (the row order of the
        PPO epoch), replacing the draws; all of them for the global rows
        (over ranks each rank takes its own)."""
        cfg, b, dev = self.config, self.bundle, self.device
        pinned = pinned or {}
        actor = cfg.actor_rollout_ref.actor
        n = cfg.actor_rollout_ref.rollout.n
        roll = cfg.world_model_rollout.rollout
        use_gt_ac = bool(roll.w_gt_ac and cfg.processor.use_img_gt_ac)
        gt_per_sample = use_gt_ac and bool(roll.get("gt_branch_per_sample", True))
        use_remax = cfg.algorithm.adv_estimator == "remax"
        expert = b.expert
        metrics: Dict[str, Any] = {}
        timing: Dict[str, float] = {}

        with timer("step", timing):
            batch = (batch_np if all(isinstance(v, torch.Tensor) for v in batch_np.values())
                     else self.put_batch(batch_np))
            gt_global = batch["actions"]
            B = gt_global.shape[0]  # the global batch's unique samples
            batch = {k: self._rows(v) for k, v in batch.items()}  # this rank's samples
            gt_actions = batch["actions"]
            B_l = gt_actions.shape[0]
            rows = lambda x: self._rows(x.to(dev))  # this rank's rows of a global draw
            # 0 --- one frozen-VLM context encode per unique sample
            with timer("encode_context", timing):
                hidden_unique = self.encode(batch)
                _sync(dev)
            hidden = hidden_unique.repeat_interleave(n, 0)
            # 1 --- noise after repeating each sample n times
            gt_rep = gt_actions.repeat_interleave(n, 0)
            noise_dict = {k: rows(v) for k, v in (pinned.get("noise") or sample_noisy_actions(
                self._generator(step, "noise"), gt_global.repeat_interleave(n, 0),
                b.expert_cfg)).items()}
            proprio_rep = batch["proprio"].repeat_interleave(n, 0)
            actor_batch = {"hidden": hidden, "proprio": proprio_rep, "noise": noise_dict["noise"]}
            # 2 --- stochastic action rollout
            with timer("ac_rollout", timing):
                K = b.expert_cfg.num_flow_steps
                eps = pinned.get("flow_eps")
                if eps is None:  # the K steps' draws for the global rows
                    g = self._generator(step, "roll")
                    shape = (B * n,) + tuple(noise_dict["noise"].shape[1:])
                    eps = torch.stack([torch.randn(shape, generator=g, dtype=torch.float32,
                                                   device=dev) for _ in range(K)])
                eps = self._rows(eps.to(dev).transpose(0, 1)).transpose(0, 1)
                out = pinned.get("rollout")
                out = ({k: rows(v) for k, v in out.items()} if out else
                       flow_actor.rollout_from_hidden(expert, None, hidden, noise_dict["noise"],
                                                      proprio_rep, K, eps=eps))
                base_actions = None
                if use_remax:
                    # the greedy baseline: the deterministic Euler chain per
                    # unique sample from its own noise
                    base_actions = pinned.get("base_actions")
                    if base_actions is None:
                        base_noise = pinned.get("base_noise")
                        if base_noise is None:
                            base_noise = sample_noisy_actions(
                                self._generator(step, "noise", REMAX_BASELINE_CHUNK),
                                gt_global, b.expert_cfg)["noise"]
                        base_actions = flow_actor.rollout_from_hidden(
                            expert, None, hidden_unique, rows(base_noise), batch["proprio"],
                            K, deterministic=True)["predicted_actions"]
                    else:
                        base_actions = rows(base_actions)
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
            baseline_scores = None  # ReMax: the greedy baseline's score per sample (B,)
            if cfg.trainer.use_ac_reward:
                # the action-space reward: no tokenizer or WM stage
                with timer("ac_reward", timing):
                    token_level_rewards, r_metrics = ac_reward(
                        gt_rep, actor_batch["predicted_actions"], cfg.trainer.ac_reward_type)
                    metrics.update(self.ranks.mean(
                        {k: float(v) for k, v in r_metrics.items()}, dev))
                    if use_remax:
                        base_rt, _ = ac_reward(gt_actions, base_actions,
                                               cfg.trainer.ac_reward_type)
                        baseline_scores = base_rt.float().sum(-1)
            else:
                # ReMax: each sample's greedy baseline row rides after its n
                # rollouts (groups of n + 1) through every reward path and is
                # stripped after the reward
                n_wm = n + 1 if use_remax else n
                pa = actor_batch["predicted_actions"]
                wm_actions = (torch.cat([pa.reshape(B_l, n, *pa.shape[1:]),
                                         base_actions[:, None].to(pa.dtype)], dim=1)
                              .reshape(B_l * n_wm, *pa.shape[1:]) if use_remax else pa)
                # 4 --- tokenize
                with timer("process", timing), self._whole("tokenizer"):
                    wm_inputs = process_stage(b, self.action_ranges, batch["raw_pixel_values"],
                                              wm_actions, gt_actions, n_wm, use_gt_ac)
                    _sync(dev)
                if cfg.trainer.reward_fn == "wm_logprob":
                    # one teacher-forced WM forward over the recorded future
                    # replaces the rollout and the detokenise / LPIPS reward
                    with timer("wm_rollout", timing), self._whole("wm"):
                        token_level_rewards, r_metrics = wm_logprob_reward(
                            b.wm, b.proc_cfg, b.reward_cfg, wm_inputs["input_ids"],
                            b.roll_cfg.prompt_length)
                        _sync(dev)
                    with timer("adv", timing):
                        metrics.update(self.ranks.mean(
                            {k: float(v) for k, v in r_metrics.items()}, dev))
                        # the msp path's metric families, for one schema
                        metrics.setdefault("critic/recon_loss/mean", 0.0)
                        metrics.setdefault("critic/perceptual_loss/mean", 0.0)
                else:
                    # 5 --- WM rollout (+ the gt branch), chunked on group boundaries
                    with timer("wm_rollout", timing), self._whole(
                            *(() if self._use_wm_int8 else ("wm",))):
                        wrows = wm_rows(b, wm_inputs, n_wm, use_gt_ac, gt_per_sample,
                                        interleave_gt=b.roll_cfg.speculative_k == 0)
                        wm_stats = {}
                        responses, gt_responses = wm_rollout_stage(
                            b, self._wm_gen_model(), wrows,
                            int(roll.get("micro_batch_size", 16) or 16),
                            lambda ci: self._generator(step, "wm", ci), stats=wm_stats)
                        _sync(dev)
                    keys = sorted(wm_stats)  # the global batch's counts
                    tot = self.ranks.sum(torch.tensor(
                        [float(wm_stats[k]) for k in keys], dtype=torch.float64, device=dev))
                    wm_stats = dict(zip(keys, tot.tolist()))
                    metrics["wm_rollout/rows"] = float(wm_stats["rows"])
                    metrics["wm_rollout/calls"] = float(wm_stats["calls"])
                    if b.roll_cfg.speculative_k:
                        metrics.update({f"wm_rollout/{k}": float(wm_stats[k])
                                        for k in ("verify_calls", "proposed", "accepted")})
                        metrics["wm_rollout/acceptance_rate"] = (
                            wm_stats["accepted"] / max(wm_stats["proposed"], 1))
                    # 6 --- reward per chunk of tokenizer_micro_batch_size rows
                    with timer("adv", timing), self._whole("tokenizer", "lpips"):
                        rw = int(cfg.processor.get("tokenizer_micro_batch_size", 8) or 8)
                        token_level_rewards, r_metrics = reward_stage(
                            b, wm_inputs, responses, gt_responses, n_wm, use_gt_ac,
                            gt_per_sample, rw)
                        _sync(dev)
                        metrics.update(self.ranks.mean(r_metrics, dev))
                if use_remax:  # strip the baseline rows back out
                    tl = token_level_rewards.reshape(B_l, n + 1, -1)
                    baseline_scores = tl[:, -1].float().sum(-1)
                    token_level_rewards = tl[:, :-1].reshape(B_l * n, -1)
            # the global batch's rewards: a group's rows are on one rank,
            # but the advantage estimators and the critic/* metrics read the
            # whole batch
            token_level_rewards = self.ranks.gather(token_level_rewards)
            if baseline_scores is not None:
                baseline_scores = self.ranks.gather(baseline_scores)
            # 7 --- advantage over the groups of n rollouts
            if use_remax:
                advantages, returns = self.advantage_remax(
                    token_level_rewards, baseline_scores.repeat_interleave(n))
                metrics["critic/reward_baseline/mean"] = float(baseline_scores.mean())
            else:
                group_ids = torch.arange(B, device=dev).repeat_interleave(n)
                advantages, returns = self.advantage(token_level_rewards, group_ids, B)
            # 8 --- PPO update over the global rows
            with timer("update_actor", timing):
                actor_batch = {k: self.ranks.gather(v) for k, v in actor_batch.items()}
                actor_batch["advantages"] = advantages
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
            timing, B * n, b.roll_cfg.num_frames, self.data_count,
            step_flops=self._step_flops(B, n), peak_flops=self._peak_flops()))
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
        """Resume (resume_mode auto), validate first with val_before_train
        (and stop there with val_only), then train to total_training_steps,
        logging each step, validating every test_freq steps and saving on
        the configured cadence.  `on_step_start(step)` / `on_step_end(step,
        metrics)` bracket each training_step (a caller reading clocks or
        counters; validation runs outside them)."""
        cfg = self.config
        logger = logger or Tracking(cfg.trainer.project_name, cfg.trainer.experiment_name,
                                    cfg.trainer.logger if self.is_rank0 else [])
        self._load_checkpoint()
        if cfg.trainer.get("val_before_train", False):
            logger.log(self.validate(), self.global_steps)
            if cfg.trainer.get("val_only", False):
                logger.finish()
                return
        test_freq = cfg.trainer.get("test_freq", -1)
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
            if test_freq > 0 and self.global_steps % test_freq == 0:
                metrics.update(self.validate())
            logger.log(metrics, self.global_steps)
            if should_save(self.global_steps, self.total_training_steps, cfg.trainer.save_freq,
                           cfg.trainer.save_last_freq, cfg.trainer.save_last_num):
                self._save_checkpoint()
            self.global_steps += 1
        logger.finish()

    # ------------------------------------------------------------ checkpoints
    def _opt_names(self):
        """{label: the parameter names of that optimizer group, in order}."""
        return {label: [n for n in self.opt.names if self.opt.labels[n] == label]
                for label in self.opt.groups}

    @torch.no_grad()
    def _save_checkpoint(self) -> Optional[str]:
        """Write the full state (expert and optimizer moments gathered from
        their shards; every rank takes part); only rank 0 writes.  Returns
        the path on rank 0, None elsewhere."""
        dl_state = getattr(self, "_dl_ckpt_state", None) or self.dataset.state_dict()
        opt_state = self.opt.state_dict()
        if self._sharded:
            params = self.expert_params
            whole = lambda n, t: pm.whole_like(t, params[n]) if n in self._sharded else t
            for label, names in self._opt_names().items():
                st = opt_state[label]
                st["mu"] = [whole(n, t) for n, t in zip(names, st["mu"])]
                st["nu"] = [whole(n, t) for n, t in zip(names, st["nu"])]
        state = {"expert": pm.full_state_dict(self.bundle.expert), "opt_state": opt_state,
                 "step": self.global_steps, "dataloader": dict(dl_state)}
        path = self.ckpt.save(self.global_steps, state) if self.is_rank0 else None
        if self.world > 1:
            torch.distributed.barrier()
        return path

    @torch.no_grad()
    def _load_checkpoint(self):
        """Every rank reads the checkpoint and keeps its own shards."""
        from torch.distributed.tensor import distribute_tensor

        if self.config.trainer.resume_mode == "disable":
            return
        step = self.ckpt.latest_step()
        if step is None:
            return
        state = self.ckpt.restore(step, map_location=self.device)
        pm.load_full_state_dict(self.bundle.expert, state["expert"], strict=True)
        if self._sharded:
            params = self.expert_params
            mine = lambda n, t: (distribute_tensor(
                t.to(self.device), params[n].device_mesh, params[n].placements,
                src_data_rank=None).to_local() if n in self._sharded else t)
            for label, names in self._opt_names().items():
                st = state["opt_state"][label]
                st["mu"] = [mine(n, t) for n, t in zip(names, st["mu"])]
                st["nu"] = [mine(n, t) for n, t in zip(names, st["nu"])]
        self.opt.load_state_dict(state["opt_state"])
        self.global_steps = int(state["step"])
        self.dataset.load_state_dict({k: int(v) for k, v in state["dataloader"].items()})

    # -------------------------------------------------------------- validate
    @torch.no_grad()
    def validate(self, pinned: Optional[Sequence[Dict[str, Any]]] = None) -> Dict[str, float]:
        """The reference's validate (grpo_trainer.py:1066-1162): val_iters
        batches of the val stream through the flow rollout, one WM rollout
        of all rows (and one of the gt-action rows with use_gt_ac) and the
        MSP reward, no update; the first batch's predicted and real frames
        of row 0 go to trainer.img_save_dir as a PNG grid.  Returns val/*
        metrics averaged over the batches.  `pinned[i]` may hold "noise"
        and "rollout" for batch i, as training_step's does."""
        cfg, b = self.config, self.bundle
        n = cfg.actor_rollout_ref.rollout.n
        roll = cfg.world_model_rollout.rollout
        use_gt_ac = bool(roll.w_gt_ac and cfg.processor.use_img_gt_ac)
        pc, rc = b.proc_cfg, b.roll_cfg
        scores, losses = [], {}
        for it in range(cfg.trainer.val_iters):
            p = pinned[it] if pinned else {}
            gen = lambda k: self._generator(0, "val", 4 * it + k)
            batch = {k: self._rows(v) for k, v in
                     self.put_batch(self.val_dataset.next_batch()).items()}
            hidden = self.encode(batch).repeat_interleave(n, 0)
            gt_rep = batch["actions"].repeat_interleave(n, 0)
            noise = p.get("noise")
            if noise is None:
                noise = sample_noisy_actions(gen(0), gt_rep, b.expert_cfg)["noise"]
            out = p.get("rollout") or flow_actor.rollout_from_hidden(
                b.expert, gen(1), hidden, noise, batch["proprio"].repeat_interleave(n, 0),
                b.expert_cfg.num_flow_steps)
            with self._whole("tokenizer"):
                wm_inputs = process_stage(b, self.action_ranges, batch["raw_pixel_values"],
                                          out["predicted_actions"], batch["actions"], n,
                                          use_gt_ac)
            prompt = wm_inputs["input_ids"][:, :rc.prompt_length]
            p0 = rc.prompt_length - pc.action_dim
            prefix_map = torch.arange(prompt.shape[0] // n, dtype=torch.int32,
                                      device=self.device).repeat_interleave(n)
            wm = self._wm_gen_model()
            rollout = lambda actions, g: generate_sequences(
                wm, g, prompt[:, p0:], actions, rc, shared_prefix=prompt[::n, :p0],
                prefix_map=prefix_map)
            with self._whole(*(() if self._use_wm_int8 else ("wm",))):
                responses = rollout(wm_inputs["action_ids"], gen(2))
                gt_responses = (rollout(wm_inputs["gt_action_ids"], gen(3)) if use_gt_ac
                                else None)
            real = (None if use_gt_ac
                    else wm_inputs["pixels_w_ctx_unique"][:, 2:].repeat_interleave(n, 0))
            with self._whole("tokenizer", "lpips"):
                reward, r_metrics = msp_reward(b.tokenizer, b.lpips, pc, b.reward_cfg,
                                               responses, wm_inputs["ctx_tokens"],
                                               real_frames=real, gt_responses=gt_responses)
                img_dir = cfg.trainer.get("img_save_dir", None)
                if img_dir and it == 0 and self.is_rank0:
                    self._save_val_frames(img_dir, wm_inputs["ctx_tokens"][:1], responses,
                                          gt_responses, real, float(reward[0].sum()))
            scores += self.ranks.gather(reward.float().sum(-1)).tolist()
            for k, v in self.ranks.mean({k: float(v) for k, v in r_metrics.items()},
                                        self.device).items():
                losses.setdefault(k, []).append(v)
        return {"val/reward": float(np.mean(scores)),
                "val/on_train_stream": float(self._val_on_train_stream),
                **{f"val/{k}": float(np.mean(v)) for k, v in losses.items()}}

    def _save_val_frames(self, img_dir, ctx_tokens, responses, gt_responses, real,
                         reward: float) -> str:
        """Row 0's predicted frames against its real ones (the gt rollout's
        frames with use_gt_ac), as one PNG grid."""
        b = self.bundle
        pc, Fn = b.proc_cfg, b.reward_cfg.num_frames
        ctx_raw = ctx_tokens - pc.visual_token_num
        frames = lambda resp: b.tokenizer.detokenize(
            ctx_raw, split_response_tokens(pc, resp[:1], Fn)).float()[0, 1:].cpu().numpy()
        real_px = (frames(gt_responses) if gt_responses is not None
                   else real[0].float().cpu().numpy())
        return save_frame_grid(real_px, frames(responses),
                               f"{img_dir}/{self.global_steps}_val_frames.png", reward=reward)


def _refuse(config: Config) -> None:
    """What the port does not run: a verify call longer than the decode
    kernels take (the reference only warns and falls back to its XLA path)."""
    problem = speculative_k_problem(config)
    if problem:
        raise ValueError(problem)
