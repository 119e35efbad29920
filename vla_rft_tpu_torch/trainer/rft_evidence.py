"""The push pipeline on the port: "RFT improves the policy" end to end on the
MuJoCo push env with the `push` preset, every stage trained (port of
tools/rft_evidence.py, with its phase names, flags and defaults).

Phases (each caches its artifact under --workdir and can run alone):

  collect     scripted-expert + graded-noise segments from the env (MuJoCo)
  tokenizer   train CompressiveVQModelFSQ on `recon_train` (FSQ's
              straight-through codes): Adam 1e-3, B 8, T 4 random windows,
              MSE
  wm          train the WM on the tokenized (frames, actions) sequences:
              teacher-forced next-token CE, AdamW with warm-up + cosine,
              the best validation CE kept (the `--wm-*` size overrides)
  wmcheck     the WM reward against MuJoCo's truth for perturbed actions
              (MuJoCo)
  bc          behaviour cloning of the whole policy (VLAAdapterSFTTrainer, no
              freeze, expert lr 3x, `--bc-decay`, `--bc-fraction`)
  evalpolicy  success rate of a saved policy on the push suite (MuJoCo)
  rft         GRPO RFT inside the trained WM (VLARFTGRPOTrainer, preset
              "push") on the clean segments, validated every 20 steps
  report      both policies' success rates and the curve into
              RFT_EVIDENCE.json (MuJoCo)

`python -m vla_rft_tpu_torch.trainer.rft_evidence all --workdir W` runs them
in order; `--device` is "cuda" (the default: the f32 kernel instances #1-#5
serve the push models there) or "cpu".  A MuJoCo phase on a machine without
`mujoco` raises with the phase's name.

What differs from the tool, and why:
* The tool runs K = 25 optimizer steps per dispatch inside a `lax.scan` (a
  TPU dispatch trick); here each step is a plain loop iteration.  The
  tokenizer and WM phases draw the same batches in the same order from the
  same `np.random.default_rng(seed)`, and print at the same block
  boundaries; BC draws its rows from `np.random.default_rng(seed)` and its
  flow noise from a `torch.Generator` (the tool's `jax.random` draws cannot
  be reproduced).
* Fresh weights are the port's seeded init (`models/factory.py`), not
  Flax's initializers; trained weights go through the tool's own files.
* The files are the tool's: `save_tree` / `load_tree` write and read its
  flat `p0..pN` leaves in Flax's tree order (`convert.torch_to_flax`,
  `flax_to_torch`), so this module's outputs and the tool's are
  interchangeable.
* The evaluation starts each chunk's flow from a torch.Generator seeded
  with 0 (the point tests/test_torch_push.py replays), where the tool uses
  jax.random.key(0)'s point.
* The tool's platform selection, compile cache and `--im2col` are TPU
  devices with no counterpart; `--device` takes their place.

Each phase function returns what it measured (losses per step, validation
values, seconds) besides writing its files; `main` returns them by phase.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import time
from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from vla_rft_tpu_torch.convert import flax_leaves, flax_to_torch, torch_to_flax

K = 25  # the tool's steps per dispatch: its print and checkpoint cadence


# ----------------------------------------------------------------- utilities
def _require_mujoco(phase: str) -> None:
    try:
        import mujoco  # noqa: F401
    except ImportError as e:
        raise RuntimeError(f"phase {phase!r} needs MuJoCo (the push env), which is not "
                           f"installed here") from e


def _inputs_fingerprint(*paths: str) -> str:
    """Cheap content fingerprint (size + mtime_ns per input) that invalidates
    derived caches (wm_tokens.npz) when segments / tokenizer change."""
    parts = []
    for p in paths:
        st = os.stat(p)
        parts.append(f"{os.path.basename(p)}:{st.st_size}:{st.st_mtime_ns}")
    return "|".join(parts)


def _drop_stale_token_cache(workdir: str) -> None:
    cache = os.path.join(workdir, "wm_tokens.npz")
    if os.path.exists(cache):
        os.remove(cache)


def save_tree(path: str, module: nn.Module, which: str) -> None:
    """The module's weights in the tool's layout: its Flax tree's leaves as
    p0..pN in tree-flatten order."""
    tree = torch_to_flax(module.state_dict(), which, module)
    np.savez(path, **{f"p{i}": a for i, (_, a) in enumerate(flax_leaves(tree))})


def load_tree(path: str, like: nn.Module, which: str) -> Dict[str, torch.Tensor]:
    """A file of the tool's layout -> the state dict of `like` (a module of
    family `which` with the file's shapes), on like's device."""
    leaves = flax_leaves(torch_to_flax(like.state_dict(), which, like))
    with np.load(path) as z:
        if len(z.files) != len(leaves):
            raise ValueError(f"{path}: {len(z.files)} leaves, the {which} module has "
                             f"{len(leaves)}")
        tree: Dict[str, Any] = {}
        for i, (p, a) in enumerate(leaves):
            arr = np.asarray(z[f"p{i}"], a.dtype)
            if arr.shape != a.shape:
                raise ValueError(f"{path}: leaf p{i} ({'/'.join(p)}) has shape {arr.shape}, "
                                 f"the module's {a.shape}")
            node = tree
            for k in p[:-1]:
                node = node.setdefault(k, {})
            node[p[-1]] = arr
    dev = next(like.parameters()).device
    return {k: v.to(dev) for k, v in flax_to_torch(tree, which).items()}


def _load_into(module: nn.Module, path: str, which: str) -> nn.Module:
    module.load_state_dict(load_tree(path, module, which), strict=True)
    return module


def make_config(args):
    """The tool's `make_config`: the port's default config with the push
    data shapes, the MAE reward against the recorded frames and the RFT
    batch sizes."""
    from vla_rft_tpu_torch.config import vla_rft_default_config

    chunk = 8
    tpf = 16  # dyn tokens per frame at the push preset (8x8 ctx, 4x4 dyn grids)
    size_ov = []
    for field in ("hidden", "inter", "layers", "heads"):
        v = getattr(args, f"wm_{field}", None)
        if v:
            key = {"hidden": "hidden_size", "inter": "intermediate_size",
                   "layers": "num_layers", "heads": "num_heads"}[field]
            size_ov.append(f"world_model_rollout.model.size_overrides.{key}={v}")
            if field == "heads":
                size_ov.append(f"world_model_rollout.model.size_overrides.num_kv_heads={v}")
    return vla_rft_default_config().apply_overrides(size_ov + [
        "data.train_batch_size=8",
        f"data.video.segment_length={chunk + 1}",
        f"data.max_prompt_length={64 + tpf + 7}",
        f"data.max_response_length={chunk * (tpf + 7)}",
        f"processor.tokens_per_frame={tpf}",
        f"world_model_rollout.rollout.interact_max_tokens={tpf}",
        # reward = -MAE(WM(policy actions), the recorded frames): no gt branch
        "world_model_rollout.rollout.w_gt_ac=False",
        "processor.use_img_gt_ac=False",
        "trainer.loss_weight.lpips=0.0",
        f"trainer.reward_fn={getattr(args, 'reward_fn', 'mae')}",
        f"actor_rollout_ref.rollout.n={args.rollout_n}",
        "actor_rollout_ref.rollout.num_flow_steps=10",
        f"actor_rollout_ref.actor.ppo_mini_batch_size={8 * args.rollout_n}",
        f"actor_rollout_ref.actor.ppo_micro_batch_size_per_gpu={8 * args.rollout_n}",
        f"actor_rollout_ref.rollout.log_prob_micro_batch_size_per_gpu={8 * args.rollout_n}",
        f"actor_rollout_ref.actor.optim.lr={args.rft_lr}",
        "trainer.save_freq=-1",
        "trainer.save_last_freq=-1",
        "trainer.logger=[]",
        f"trainer.total_training_steps={args.rft_steps}",
    ])


def build_push_bundle(args, seed: int = 0):
    """(config, every module of the push preset on args.device, seeded)."""
    from vla_rft_tpu_torch.models.factory import build_models

    cfg = make_config(args)
    return cfg, build_models(cfg, "push", device=args.device, seed=seed)


def _policy_batch(pixels64_u8: np.ndarray, proprio: np.ndarray) -> Dict[str, np.ndarray]:
    """One policy forward batch from raw eval observations."""
    from vla_rft_tpu_torch.data.push_data import build_push_prompt

    ids, attn, labels = build_push_prompt(32, 8)
    B = pixels64_u8.shape[0]
    px = pixels64_u8.astype(np.float32) / 255.0
    return {
        "input_ids": np.tile(ids, (B, 1)),
        "attention_mask": np.tile(attn, (B, 1)),
        "labels": np.tile(labels, (B, 1)),
        "pixels": np.concatenate([px, px], axis=-1),
        "proprio": proprio.astype(np.float32),
    }


def _trainable(*modules: nn.Module) -> List[nn.Parameter]:
    for m in modules:
        m.train().requires_grad_(True)
    return [p for m in modules for p in m.parameters()]


# -------------------------------------------------------------------- phases
def phase_collect(args) -> Dict[str, Any]:
    _require_mujoco("collect")
    from vla_rft_tpu_torch.data.push_data import (CollectConfig, collect_push_segments,
                                                  save_segments)

    t0 = time.time()
    data = collect_push_segments(CollectConfig(n_segments=args.n_segments, seed=args.seed))
    path = os.path.join(args.workdir, "segments.npz")
    save_segments(path, data)
    _drop_stale_token_cache(args.workdir)
    frac_clean = float((data["noise_scale"] == 0).mean())
    print(f"[collect] {args.n_segments} segments in {time.time()-t0:.0f}s -> {path} "
          f"(clean-expert fraction {frac_clean:.2f}, "
          f"success fraction {float(data['success'].mean()):.2f})", flush=True)
    return {"seconds": time.time() - t0, "clean_fraction": frac_clean}


def tokenizer_loss(tok, px: torch.Tensor) -> torch.Tensor:
    """The tokenizer phase's loss: mean squared `recon_train` error."""
    return torch.mean((tok.recon_train(px) - px) ** 2)


def phase_tokenizer(args) -> Dict[str, Any]:
    from vla_rft_tpu_torch.data.push_data import load_segments
    from vla_rft_tpu_torch.trainer.optim import AdamW

    _, bundle = build_push_bundle(args, args.seed)
    tok = bundle.tokenizer
    dev = next(tok.parameters()).device
    frames = load_segments(os.path.join(args.workdir, "segments.npz"))["raw_pixel_values"]
    rng = np.random.default_rng(args.seed)
    B, T = 8, 4  # ctx + 3 future frames per training sample (random windows)

    def sample_batch():
        rows = rng.integers(0, len(frames), B)
        # a random future window per row; ctx = frame 0 (the deployment layout)
        starts = rng.integers(1, frames.shape[1] - (T - 1) + 1, B)
        out = np.empty((B, T, 32, 32, 3), np.float32)
        for i, (r, s) in enumerate(zip(rows, starts)):
            out[i, 0] = frames[r, 0]
            out[i, 1:] = frames[r, s: s + T - 1]
        return out / 255.0

    opt = AdamW(_trainable(tok), 1e-3, weight_decay=0.0)  # optax.adam(1e-3)
    losses: List[float] = []
    t0 = time.time()
    n_blocks = max(1, args.tok_steps // K)
    for blk in range(n_blocks):
        block = [sample_batch() for _ in range(K)]  # drawn K at a time, as the tool does
        for px in block:
            loss = tokenizer_loss(tok, torch.as_tensor(px, device=dev))
            grads = torch.autograd.grad(loss, opt.params)
            opt.step(grads)
            losses.append(float(loss.detach()))
        if blk % 8 == 0 or blk == n_blocks - 1:
            psnr = -10 * np.log10(max(losses[-1], 1e-9))
            print(f"[tokenizer {(blk+1)*K}] mse {losses[-1]:.5f} psnr {psnr:.1f}dB "
                  f"({time.time()-t0:.0f}s)", flush=True)
    save_tree(os.path.join(args.workdir, "tokenizer.npz"), tok, "tokenizer")
    _drop_stale_token_cache(args.workdir)
    print(f"[tokenizer] saved ({time.time()-t0:.0f}s)", flush=True)
    return {"losses": losses, "seconds": time.time() - t0}


def make_segment_tokenizer(bundle, action_ranges: torch.Tensor):
    """(frames_u8, actions) -> the WM sequences (the trainer's process
    dataflow at n = 1: the ctx frame added, tokenized, the ctx_msp layout),
    numpy in, tensors on the tokenizer's device out."""
    from vla_rft_tpu_torch.workers.processor import add_context_frame, ctx_msp_process

    dev = action_ranges.device

    @torch.no_grad()
    def run(frames_u8: np.ndarray, actions: np.ndarray) -> Dict[str, torch.Tensor]:
        px = torch.as_tensor(frames_u8, device=dev).float() / 255.0
        acts = torch.as_tensor(actions, device=dev)
        px_w, _ = add_context_frame(px, acts)
        idx_c, idx_d = bundle.tokenizer.tokenize(px_w)
        acts_w = torch.cat([acts[:, :1], acts, acts[:, -1:]], dim=1)
        return ctx_msp_process(bundle.proc_cfg, idx_c, idx_d, acts_w, action_ranges)

    return run


def wm_loss(wm, ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Teacher-forced next-token CE over the labelled positions (the tool's
    `loss_fn`)."""
    logits, _ = wm(ids[:, :-1])
    lp = torch.log_softmax(logits.float(), dim=-1)
    tgt = labels[:, 1:].long()
    valid = tgt != -100
    nll = -torch.gather(lp, -1, tgt.clamp_min(0)[..., None])[..., 0]
    return (nll * valid).sum() / valid.sum()


def phase_wm(args) -> Dict[str, Any]:
    from vla_rft_tpu_torch.data.push_data import load_segments, train_val_split
    from vla_rft_tpu_torch.data.synthetic import default_action_ranges
    from vla_rft_tpu_torch.trainer.optim import AdamW, warmup_cosine_decay_schedule

    _, bundle = build_push_bundle(args, args.seed)
    data = load_segments(os.path.join(args.workdir, "segments.npz"))
    _load_into(bundle.tokenizer, os.path.join(args.workdir, "tokenizer.npz"), "tokenizer")
    wm = bundle.wm
    dev = next(wm.parameters()).device
    ranges = torch.as_tensor(default_action_ranges(7), device=dev)
    tr_idx, va_idx = train_val_split(data, seed=args.seed)
    sched = warmup_cosine_decay_schedule(0.0, args.wm_lr, 100, max(args.wm_steps, 101))
    opt = AdamW(_trainable(wm), sched, weight_decay=0.01)
    rng = np.random.default_rng(args.seed)
    B = args.wm_batch

    # the tokenizer is frozen here: the whole pool is tokenized once (and
    # cached with a fingerprint of its inputs)
    tok_cache = os.path.join(args.workdir, "wm_tokens.npz")
    fp = _inputs_fingerprint(os.path.join(args.workdir, "segments.npz"),
                             os.path.join(args.workdir, "tokenizer.npz"))
    cached = None
    if os.path.exists(tok_cache):
        with np.load(tok_cache) as z:
            if "fingerprint" in z.files and str(z["fingerprint"]) == fp:
                cached = (z["ids"], z["labels"])
            else:
                print("[wm] wm_tokens.npz stale (inputs changed) - retokenizing", flush=True)
    if cached is not None:
        all_ids, all_labels = cached
    else:
        tokenize = make_segment_tokenizer(bundle, ranges)
        ids_l, labels_l = [], []
        CH = 512
        for i in range(0, len(data["actions"]), CH):
            proc = tokenize(data["raw_pixel_values"][i: i + CH], data["actions"][i: i + CH])
            ids_l.append(proc["input_ids"].cpu().numpy())
            labels_l.append(proc["labels"].cpu().numpy())
        all_ids, all_labels = np.concatenate(ids_l), np.concatenate(labels_l)
        np.savez(tok_cache, ids=all_ids, labels=all_labels, fingerprint=fp)

    as_t = lambda a: torch.as_tensor(a, device=dev)
    # a fixed validation set of 8 batches for the best-checkpoint choice
    vrng = np.random.default_rng(args.seed + 1)
    val_rows = va_idx[vrng.integers(0, len(va_idx), (8, B))]

    @torch.no_grad()
    def val_ce() -> float:
        return float(np.mean([float(wm_loss(wm, as_t(all_ids[r]), as_t(all_labels[r])))
                              for r in val_rows]))

    losses: List[float] = []
    vals: List[float] = []
    t0 = time.time()
    n_blocks = max(1, args.wm_steps // K)
    best = (float("inf"), None, 0)
    for blk in range(n_blocks):
        rows = tr_idx[rng.integers(0, len(tr_idx), (K, B))]
        for r in rows:
            loss = wm_loss(wm, as_t(all_ids[r]), as_t(all_labels[r]))
            opt.step(torch.autograd.grad(loss, opt.params))
            losses.append(float(loss.detach()))
        if blk % 8 == 0 or blk == n_blocks - 1:
            vl = val_ce()
            vals.append(vl)
            if vl < best[0]:
                best = (vl, copy.deepcopy(wm.state_dict()), (blk + 1) * K)
            print(f"[wm {(blk+1)*K}] ce {losses[-1]:.4f} val_ce {vl:.4f} "
                  f"best {best[0]:.4f}@{best[2]} ({time.time()-t0:.0f}s)", flush=True)
    # wm.npz holds the best validation CE's weights; wm_final.npz the last
    save_tree(os.path.join(args.workdir, "wm_final.npz"), wm, "wm")
    if best[1] is not None:
        wm.load_state_dict(best[1])
    save_tree(os.path.join(args.workdir, "wm.npz"), wm, "wm")
    print(f"[wm] saved best val_ce {best[0]:.4f} @ step {best[2]} "
          f"({time.time()-t0:.0f}s)", flush=True)
    return {"losses": losses, "val_ce": vals, "best": best[0], "best_step": best[2],
            "seconds": time.time() - t0}


def phase_wmcheck(args) -> Dict[str, Any]:
    """WM reward against env truth: for validation segments, perturb the
    executed actions at graded scales, re-execute them in MuJoCo from the
    recorded sim state (the true future-frame error) and roll the WM with
    the same actions (the WM reward); Spearman rank correlations and
    per-scale monotonicity."""
    _require_mujoco("wmcheck")
    from vla_rft_tpu_torch.data.push_data import load_segments, resize_uint8, train_val_split
    from vla_rft_tpu_torch.data.synthetic import default_action_ranges
    from vla_rft_tpu_torch.eval.mujoco_push_env import MujocoPushEnv
    from vla_rft_tpu_torch.workers.reward import msp_reward
    from vla_rft_tpu_torch.workers.wm_rollout import compute_log_prob, generate_sequences

    _, bundle = build_push_bundle(args)
    data = load_segments(os.path.join(args.workdir, "segments.npz"))
    _load_into(bundle.tokenizer, os.path.join(args.workdir, "tokenizer.npz"), "tokenizer")
    _load_into(bundle.wm, os.path.join(args.workdir, "wm.npz"), "wm")
    dev = next(bundle.wm.parameters()).device
    ranges = torch.as_tensor(default_action_ranges(7), device=dev)
    _, va_idx = train_val_split(data, seed=args.seed)
    rng = np.random.default_rng(args.seed + 7)

    scales = [0.0, 0.15, 0.3, 0.6, 1.2]
    n_seg = min(args.check_segments, len(va_idx))
    acts, true_err, seg_of = [], [], []
    envs = {t: MujocoPushEnv(t, camera_heights=128, camera_widths=128) for t in range(3)}
    for r in va_idx[:n_seg]:
        base = data["actions"][r]
        real = data["raw_pixel_values"][r, 1:].astype(np.float32) / 255.0
        for s in scales:
            a = np.clip(base + s * rng.normal(size=base.shape).astype(np.float32), -1, 1)
            env = envs[int(data["task_id"][r])]
            env.reset()
            env.set_init_state(data["sim_states"][r])
            frames = []
            for step_a in a:
                obs, _, _, _ = env.step(step_a.tolist())
                frames.append(resize_uint8(obs["agentview_image"][::-1, ::-1], 32))
            tru = np.stack(frames).astype(np.float32) / 255.0
            acts.append(a)
            true_err.append(float(np.abs(tru - real).mean()))
            seg_of.append(r)
    acts = np.stack(acts)
    M = len(acts)

    frames_rep = data["raw_pixel_values"][np.asarray(seg_of)]
    proc = make_segment_tokenizer(bundle, ranges)(frames_rep, acts)
    roll = bundle.roll_cfg
    roll_greedy = dataclasses.replace(roll, do_sample=False)
    prompt = proc["input_ids"][:, : roll.prompt_length]
    px_real = torch.as_tensor(frames_rep[:, 1:], device=dev).float() / 255.0
    tpf = bundle.proc_cfg.tokens_per_frame
    resp_len = proc["input_ids"].shape[1] - roll.prompt_length
    dyn_mask = (np.arange(resp_len) % (tpf + 7)) < tpf
    rewards, rewards_g, lls = [], [], []
    bs = 50
    with torch.no_grad():
        for i in range(0, M, bs):
            sl = slice(i, min(i + bs, M))
            gen = torch.Generator(device=dev).manual_seed(i)
            reward = lambda resp: msp_reward(bundle.tokenizer, bundle.lpips, bundle.proc_cfg,
                                             bundle.reward_cfg, resp, proc["ctx_tokens"][sl],
                                             real_frames=px_real[sl])[0]
            resp = generate_sequences(bundle.wm, gen, prompt[sl], proc["action_ids"][sl], roll)
            rewards += reward(resp).float().sum(-1).cpu().tolist()
            # greedy decode: the same reward without sampling noise
            resp_g = generate_sequences(bundle.wm, gen, prompt[sl], proc["action_ids"][sl],
                                        roll_greedy)
            rewards_g += reward(resp_g).float().sum(-1).cpu().tolist()
            lp = compute_log_prob(bundle.wm, proc["input_ids"][sl], resp_len).cpu().numpy()
            lls += ((lp * dyn_mask).sum(-1) / dyn_mask.sum()).astype(np.float32).tolist()
            print(f"[wmcheck] {min(i+bs, M)}/{M}", flush=True)
    rewards, rewards_g = np.asarray(rewards), np.asarray(rewards_g)
    lls, true_err = np.asarray(lls), np.asarray(true_err)

    def spearman(a, b):
        ra = np.argsort(np.argsort(a)).astype(np.float64)
        rb = np.argsort(np.argsort(b)).astype(np.float64)
        ra -= ra.mean()
        rb -= rb.mean()
        return float((ra * rb).sum() / np.sqrt((ra ** 2).sum() * (rb ** 2).sum()))

    k = len(scales)
    by_scale = {str(s): {"wm_reward": round(float(rewards[j::k].mean()), 4),
                         "wm_reward_greedy": round(float(rewards_g[j::k].mean()), 4),
                         "wm_dyn_logprob": round(float(lls[j::k].mean()), 4),
                         "true_mae": round(float(true_err[j::k].mean()), 4)}
                for j, s in enumerate(scales)}
    monotone = lambda col: all(by_scale[str(scales[j])][col] >= by_scale[str(scales[j + 1])][col]
                               for j in range(k - 1))
    out = {
        "spearman_reward_vs_true": round(spearman(rewards, -true_err), 3),
        "spearman_greedy_reward_vs_true": round(spearman(rewards_g, -true_err), 3),
        "spearman_dyn_logprob_vs_true": round(spearman(lls, -true_err), 3),
        "reward_monotone_in_noise": monotone("wm_reward"),
        "greedy_reward_monotone_in_noise": monotone("wm_reward_greedy"),
        "dyn_logprob_monotone_in_noise": monotone("wm_dyn_logprob"),
        "by_noise_scale": by_scale,
        "n_segments": n_seg,
        "variants_per_segment": k,
    }
    with open(os.path.join(args.workdir, "wmcheck.json"), "w") as f:
        json.dump(out, f, indent=1)
    np.savez(os.path.join(args.workdir, "wmcheck_raw.npz"), rewards=rewards,
             rewards_greedy=rewards_g, true_err=true_err, lls=lls, seg_of=np.asarray(seg_of),
             scales=np.asarray(scales))
    print(f"[wmcheck] {json.dumps(out)}", flush=True)
    return out


def _bc_batch(px_u8: torch.Tensor, proprio: torch.Tensor, actions: torch.Tensor,
              prompt) -> Dict[str, torch.Tensor]:
    px = px_u8.float() / 255.0
    n = px_u8.shape[0]
    ids, attn, labels = (torch.as_tensor(x, device=px.device) for x in prompt)
    return {"pixels": torch.cat([px, px], dim=-1), "proprio": proprio,
            "input_ids": ids.repeat(n, 1), "attention_mask": attn.repeat(n, 1),
            "labels": labels.repeat(n, 1), "actions": actions}


def phase_bc(args) -> Dict[str, Any]:
    """Flow-matching BC of the whole policy from its seeded init: the VLM
    trains at bc_lr and the expert at 3x, the training pool held on the
    device and gathered there."""
    from vla_rft_tpu_torch.data.push_data import build_push_prompt, load_segments, train_val_split
    from vla_rft_tpu_torch.models.action_head import sample_noisy_actions
    from vla_rft_tpu_torch.trainer.optim import warmup_cosine_decay_schedule
    from vla_rft_tpu_torch.trainer.sft_trainer import VLAAdapterSFTTrainer

    _, bundle = build_push_bundle(args, args.seed)
    data = load_segments(os.path.join(args.workdir, "segments.npz"))
    tr_idx, va_idx = train_val_split(data, seed=args.seed)
    if args.bc_fraction < 1.0:  # deliberately weak BC: less data
        tr_idx = tr_idx[: max(8, int(len(tr_idx) * args.bc_fraction))]
    if args.bc_decay:
        warm = min(300, max(1, args.bc_steps // 4))
        lr = warmup_cosine_decay_schedule(0.0, args.bc_lr, warm, args.bc_steps,
                                          args.bc_lr * 0.03)
        expert_lr = warmup_cosine_decay_schedule(0.0, args.bc_lr * 3.0, warm, args.bc_steps,
                                                 args.bc_lr * 0.09)
    else:
        lr, expert_lr = args.bc_lr, args.bc_lr * 3.0
    _trainable(bundle.vla, bundle.expert)
    trainer = VLAAdapterSFTTrainer(bundle.vla, bundle.expert, lr=lr, expert_lr=expert_lr)
    dev = trainer.device
    B = args.bc_batch
    pool = [torch.as_tensor(data[k][tr_idx], device=dev)
            for k in ("policy_pixels", "proprio", "expert_actions")]
    prompt = build_push_prompt(32, 8)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    vrng = np.random.default_rng(args.seed + 1)
    vrows = va_idx[vrng.integers(0, len(va_idx), 128)]
    val_batch = _bc_batch(*(torch.as_tensor(data[k][vrows], device=dev)
                            for k in ("policy_pixels", "proprio", "expert_actions")), prompt)

    @torch.no_grad()
    def val_loss() -> float:
        g = torch.Generator(device=dev).manual_seed(args.seed + 2)
        noise = sample_noisy_actions(g, val_batch["actions"], bundle.expert.cfg)
        return float(trainer.compute_loss(val_batch, noise))

    print("[bc] pools on device, training starts", flush=True)
    losses: List[float] = []
    vals: List[float] = []
    t0 = time.time()
    best = (float("inf"), None, 0)
    n_blocks = max(1, args.bc_steps // K)
    for blk in range(n_blocks):
        for _ in range(K):
            rows = torch.as_tensor(rng.integers(0, len(tr_idx), B), device=dev)
            batch = _bc_batch(*(p[rows] for p in pool), prompt)
            losses.append(trainer.training_step(gen, batch))
        if blk % 8 == 0 or blk == n_blocks - 1:
            vl = val_loss()
            vals.append(vl)
            if vl < best[0]:
                best = (vl, (copy.deepcopy(bundle.vla.state_dict()),
                             copy.deepcopy(bundle.expert.state_dict())), (blk + 1) * K)
            print(f"[bc {(blk+1)*K}] flow_bc {np.mean(losses[-K:]):.4f} val {vl:.4f} "
                  f"best {best[0]:.4f}@{best[2]} ({time.time()-t0:.0f}s)", flush=True)
    if best[1] is not None:
        bundle.vla.load_state_dict(best[1][0])
        bundle.expert.load_state_dict(best[1][1])
    save_tree(os.path.join(args.workdir, "bc_vla.npz"), bundle.vla, "vla")
    save_tree(os.path.join(args.workdir, "bc_expert.npz"), bundle.expert, "expert")
    print(f"[bc] saved best val {best[0]:.4f} @ step {best[2]} ({time.time()-t0:.0f}s)",
          flush=True)
    return {"losses": losses, "val": vals, "best": best[0], "best_step": best[2],
            "seconds": time.time() - t0}


def _eval_policy(args, bundle, episodes_per_task: int = 10, tag: str = "") -> float:
    """The push suite's success rate of bundle's policy: per task, held-out
    init states (seed + 100), 128 px renders flipped and resized to 64 px,
    chunks of 8 clipped to [-1, 1], 10 flow steps, each chunk's flow
    started from a torch.Generator seeded with 0."""
    from vla_rft_tpu_torch.data.push_data import resize_uint8
    from vla_rft_tpu_torch.eval.libero_eval import quat2axisangle
    from vla_rft_tpu_torch.eval.mujoco_push_env import make_push_env
    from vla_rft_tpu_torch.workers.predict import predict_action

    dev = next(bundle.expert.parameters()).device
    cfg = bundle.expert.cfg
    successes, total = 0, 0
    for task_id in range(3):
        env, _, init_states = make_push_env(task_id, resolution=128,
                                            num_init_states=episodes_per_task,
                                            seed=args.seed + 100)
        for ep in range(episodes_per_task):
            env.reset()
            obs = env.set_init_state(init_states[ep % len(init_states)])
            done = False
            for _ in range(args.eval_max_steps // 8):
                img = resize_uint8(obs["agentview_image"][::-1, ::-1], 64)
                proprio = np.concatenate([obs["robot0_eef_pos"],
                                          quat2axisangle(obs["robot0_eef_quat"]),
                                          obs["robot0_gripper_qpos"]])[None]
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in _policy_batch(img[None], proprio).items()}
                noise = torch.randn((1, cfg.num_actions_chunk, cfg.action_dim),
                                    generator=torch.Generator().manual_seed(0))
                chunk = predict_action(bundle.vla, bundle.expert, batch, 10,
                                       noise=noise).float().cpu().numpy()[0]
                for a in np.clip(chunk, -1, 1):
                    obs, _, done, _ = env.step(a.tolist())
                    if done:
                        break
                if done:
                    break
            successes += int(done)
            total += 1
        print(f"[eval{tag}] task {task_id}: cumulative {successes}/{total}", flush=True)
    return successes / total


def phase_evalpolicy(args) -> Dict[str, Any]:
    _require_mujoco("evalpolicy")
    _, bundle = build_push_bundle(args)
    _load_into(bundle.vla, os.path.join(args.workdir, args.policy_vla), "vla")
    _load_into(bundle.expert, os.path.join(args.workdir, args.policy_expert), "expert")
    sr = _eval_policy(args, bundle, episodes_per_task=args.eval_episodes)
    print(json.dumps({"success_rate": sr, "policy": args.policy_expert}), flush=True)
    return {"success_rate": sr}


def phase_rft(args) -> Dict[str, Any]:
    from vla_rft_tpu_torch.data.push_data import (PushSegmentDataset, load_segments,
                                                  train_val_split)
    from vla_rft_tpu_torch.trainer.grpo_trainer import VLARFTGRPOTrainer

    cfg, bundle = build_push_bundle(args)
    data = load_segments(os.path.join(args.workdir, "segments.npz"))
    tr_idx, va_idx = train_val_split(data, seed=args.seed)
    # RFT batches: the clean expert segments, whose recorded futures are the
    # outcomes the reward pulls the policy toward
    clean = np.asarray(data["noise_scale"]) == 0.0
    tr_clean, va_clean = tr_idx[clean[tr_idx]], va_idx[clean[va_idx]]
    if len(tr_clean) == 0:  # tiny smoke datasets may have no clean rows
        tr_clean = tr_idx
    if len(va_clean) == 0:
        va_clean = va_idx
    ds = PushSegmentDataset(data, batch_size=cfg.data.train_batch_size, seed=args.seed,
                            indices=tr_clean)
    val_ds = PushSegmentDataset(data, batch_size=cfg.data.train_batch_size, seed=args.seed + 1,
                                indices=va_clean)
    files = {"vla": "bc_vla.npz", "expert": "bc_expert.npz", "wm": "wm.npz",
             "tokenizer": "tokenizer.npz"}
    params = {name: load_tree(os.path.join(args.workdir, f), getattr(bundle, name), name)
              for name, f in files.items()}
    del bundle
    trainer = VLARFTGRPOTrainer(cfg, preset="push", dataset=ds, val_dataset=val_ds,
                                params=params, seed=args.seed, device=args.device)
    curve = []
    v0 = trainer.validate()
    curve.append({"step": 0, **{k: round(float(v), 5) for k, v in v0.items()}})
    print(f"[rft 0] val {json.dumps(curve[-1])}", flush=True)
    t0 = time.time()
    batch = ds.next_batch()
    steps: List[Dict[str, float]] = []
    for step in range(1, args.rft_steps + 1):
        trainer.global_steps = step
        nxt = ds.next_batch()
        metrics = trainer.training_step(batch, step, next_batch_np=nxt)
        steps.append(metrics)
        batch = trainer._prefetched_batch
        if step % 20 == 0 or step == args.rft_steps:
            v = trainer.validate()
            row = {"step": step,
                   "train_reward": round(float(metrics.get("critic/rewards/mean", 0)), 5),
                   **{k: round(float(x), 5) for k, x in v.items()}}
            curve.append(row)
            print(f"[rft {step}] {json.dumps(row)} ({time.time()-t0:.0f}s)", flush=True)
    save_tree(os.path.join(args.workdir, "rft_expert.npz"), trainer.bundle.expert, "expert")
    with open(os.path.join(args.workdir, "rft_curve.json"), "w") as f:
        json.dump(curve, f, indent=1)
    print(f"[rft] done in {time.time()-t0:.0f}s", flush=True)
    return {"curve": curve, "metrics": steps, "seconds": time.time() - t0,
            "trainer": trainer}


def phase_report(args) -> Dict[str, Any]:
    _require_mujoco("report")
    _, bundle = build_push_bundle(args)
    _load_into(bundle.vla, os.path.join(args.workdir, "bc_vla.npz"), "vla")
    _load_into(bundle.expert, os.path.join(args.workdir, "bc_expert.npz"), "expert")
    sr_bc = _eval_policy(args, bundle, episodes_per_task=args.eval_episodes, tag=":bc")
    _load_into(bundle.expert, os.path.join(args.workdir, "rft_expert.npz"), "expert")
    sr_rft = _eval_policy(args, bundle, episodes_per_task=args.eval_episodes, tag=":rft")
    with open(os.path.join(args.workdir, "rft_curve.json")) as f:
        curve = json.load(f)
    wmcheck = {}
    wmc_path = os.path.join(args.workdir, "wmcheck.json")
    if os.path.exists(wmc_path):
        with open(wmc_path) as f:
            wmcheck = json.load(f)
    out = {
        "metric": "push_env_success_rate",
        "bc_baseline": sr_bc,
        "after_rft": sr_rft,
        "rft_steps": args.rft_steps,
        "improved": sr_rft > sr_bc,
        "val_reward_first": curve[0].get("val/reward"),
        "val_reward_last": curve[-1].get("val/reward"),
        "wm_check": wmcheck,
        "episodes_per_task": args.eval_episodes,
        "note": ("reference claim shape: <400 RFT steps surpass the supervised baseline, "
                 "reproduced on MuJoCo push physics with a fully trained "
                 "tokenizer / WM / policy stack"),
    }
    path = os.path.join(os.path.dirname(args.workdir.rstrip("/")), "RFT_EVIDENCE.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


PHASES = ("collect", "tokenizer", "wm", "wmcheck", "bc", "evalpolicy", "rft", "report")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("phase", choices=[*PHASES, "all"])
    p.add_argument("--workdir", default="artifacts/rft_evidence")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--n-segments", type=int, default=1536)
    p.add_argument("--tok-steps", type=int, default=3000)
    p.add_argument("--wm-steps", type=int, default=4000)
    # WM size overrides (None: the push preset's 4 layers x 128 / 512, 2 heads),
    # mapped to world_model_rollout.model.size_overrides
    p.add_argument("--wm-hidden", type=int, default=None)
    p.add_argument("--wm-inter", type=int, default=None)
    p.add_argument("--wm-layers", type=int, default=None)
    p.add_argument("--wm-heads", type=int, default=None)
    p.add_argument("--wm-lr", type=float, default=3e-4)
    p.add_argument("--wm-batch", type=int, default=16)
    p.add_argument("--check-segments", type=int, default=24)
    p.add_argument("--bc-steps", type=int, default=800)
    p.add_argument("--bc-batch", type=int, default=32)
    p.add_argument("--bc-lr", type=float, default=3e-4)
    p.add_argument("--bc-decay", action="store_true",
                   help="warmup+cosine lr schedule over --bc-steps")
    p.add_argument("--bc-fraction", type=float, default=1.0)
    p.add_argument("--reward-fn", default="mae", choices=["mae", "wm_logprob"])
    p.add_argument("--rft-steps", type=int, default=400)
    p.add_argument("--rft-lr", type=float, default=3e-5)
    p.add_argument("--rollout-n", type=int, default=8)
    p.add_argument("--eval-episodes", type=int, default=10)
    p.add_argument("--eval-max-steps", type=int, default=220)
    p.add_argument("--policy-vla", default="bc_vla.npz")
    p.add_argument("--policy-expert", default="bc_expert.npz")
    return p.parse_args(argv)


def main(argv=None) -> Dict[str, Dict[str, Any]]:
    args = parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    phases = (["collect", "tokenizer", "wm", "wmcheck", "bc", "rft", "report"]
              if args.phase == "all" else [args.phase])
    return {ph: globals()[f"phase_{ph}"](args) for ph in phases}


if __name__ == "__main__":
    main()
