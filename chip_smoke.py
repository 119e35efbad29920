"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. build      - nvcc builds the kernel libraries from the sources in this
                  checkout (vla_rft_tpu_torch/csrc/flash_fwd.cu, flash_bwd.cu,
                  decode_hd.cu, decode_heads.cu, fused_decode_layer.cu and
                  fused_decode_attention.cu), one nvcc per source, started
                  together;
  2. flash      - the flash kernel (#1) against its plain PyTorch twin on the
                  card over masked, padded and ragged cases and the WM's
                  1088-token prefill; three calls at each timed shape give
                  the same bits; its time at the serving and the WM
                  prefill shapes beside the twin's, scaled_dot_product_attention's
                  (a yardstick only: the port never calls it) and the bound;
  3. flash_bwd  - the flash backward kernels (#2 dQ, #3 dK/dV) against their
                  plain twin over the flash phase's masked, padded, ragged,
                  fully-masked-row and q_offset cases, D = 128 and the WM's
                  1663-token rows, causal and not; their time at the
                  VLA-adapter shape (B 16 x 352, 14/2 heads) and the WM-SFT
                  shape (B 4 x 1663, 16/16 heads) beside the twin's, the
                  autograd backward of scaled_dot_product_attention's (a
                  yardstick only, forward + backward replayed from a CUDA
                  graph less the forward) and the bound; #2's and #3's
                  launch plans and three calls of each giving the same bits
                  (#3's cluster split is reduced in a fixed order, #2 has
                  no split);
  4. decode     - the split-cache decode kernels (#4 with a shared prefix, #5
                  without) against their twins over int8 and bf16 caches, Sq 1
                  and 7, uniform and per-row prefix maps, shared_starts,
                  kv_starts (also cutting the window to a few keys or none),
                  ragged lengths, GQA 14/2, the configured 128-row WM call
                  (16 prefixes of 8 rows) and one prefix shared by 40 rows
                  (more than a chunk); their time at the WM's mid-rollout
                  shape (#4 also at 128 rows) with the launch plan, each
                  timed shape held against the twin and called three times
                  for the same bits (the key splits are merged in rank
                  order);
     decode_heads - the same for #6 / #7 over the same draws in the 'heads'
                  cache layout (rows, Hkv, S, D);
     fused_decode_attention - the cache-writing one-token decode (#10)
                  against its twin on bf16 and f32 caches and q in all four
                  pairings at rows 0, 1, mid-window and last, kv_starts at
                  or past the row, GQA 14/2, 8 ranks with empty ranges, D
                  32 and 128 with 16 query heads a kv head, 128 rows:
                  written rows and three calls bit-equal, #7 over the cache
                  #10 wrote agrees; its time with the split plan at WM
                  width (B 10, 16/16 x 64, S 1664, row 1379), at the
                  configured 128 rows and at GQA 14/2; no main path
                  launches it (the reference's neither);
  5. fused_decode - the fused decode-layer kernels of the int8-weight WM
                  (#8 RMSNorm + q/k/v + rope + k/v quantisation, #9 o_proj +
                  MLP, three launches) against their twins on one WM layer
                  of seeded int8 weights (H 1024, 16/16 heads of 64, I 4096)
                  over Sq 1 and 7, N = B*Sq of 1, 10, 128 and ragged, and
                  GQA 16/4; their
                  time at N = 10 and N = 128 beside the twin's, torch.matmul
                  of the same products over pre-dequantised bf16 weights (a
                  yardstick only) and the bound; the time per launch of #8
                  and of #9's three (o_proj, gate/up, down: torch.profiler
                  over a CUDA-graph replay), their launch plans, and three
                  calls of each giving the same bits (their split-K sums
                  are reduced in a fixed order);
  6. serving    - the libero-width policy (SigLIP-so400m + DINOv2-L +
                  Qwen2.5-0.5B + DiT action expert, seeded random weights)
                  behind ActionServer on localhost answers 4 POST /act
                  requests; every request must launch the flash kernel once
                  per Qwen layer (24), and the kernel path must agree with
                  the plain path on one request;
  7. wm_reward  - the world-model reward path at libero width (24-layer bf16
                  WM with an int8 KV cache, the 256 px tokenizer, VGG16
                  LPIPS; seeded random weights) on 2 samples with n = 4
                  rollouts, through the GRPO trainer's own stage functions
                  (process_stage -> wm_rows / wm_rollout_stage: one
                  shared-prefix rollout of 8 frames over 10 rows, each
                  sample's 4 rollouts then its gt-action row ->
                  reward_stage); run twice, each run launching #1 exactly
                  24 times and #4 exactly 24 x 521 times;
  8. wm_plain   - generate_sequences without a shared prefix on 2 rows for 2
                  frames (not 8, to keep the script short): #1 exactly 24
                  times and #5 exactly 24 x 2 x 65 times;
     wm_plain_heads - the same on the WM's weights with a 'heads' cache: #1
                  24 times and #7 24 x 2 x 65 times, and the share of its
                  tokens equal to wm_plain's (the same numbers and draws);
  9. wm_kernel_vs_plain - the WM's kernel path and plain path fed the same
                  prompts and the kernel path's tokens of frame 0 must agree
                  on the logits of every call;
 10. grpo       - the GRPO training step through
                  trainer/main_vla_rft_grpo.run at the libero preset with
                  world_model_rollout.rollout.weights_int8=true, 2 steps of
                  2 samples x n = 4 (one WM call of 10 rows), every other
                  setting the config default: per step the stage times, the
                  peak memory and exact launches (#1 24 + 24, #4 24 x 521,
                  #8 24 x 520, #9 3 x 24 x 520, every other kernel 0); every
                  trained expert leaf moved, every VLM / WM / tokenizer /
                  LPIPS leaf bit-identical, metrics finite; a torch.profiler
                  window of 16 fused decode calls; the fused route against
                  the unfused int8 route on frame 0's calls;
     grpo_heads - the same with world_model_rollout.rollout.kv_layout=heads
                  instead (a bf16 WM): #1 24 + 24 and #6 24 x 521 per step,
                  every other kernel 0; a profiler window of 16 decode
                  calls; the 'heads' route against the 'hd' route on the
                  same weights and frame 0's calls;
 11. sft        - the supervised fine-tuning path at libero width through
                  trainer/main_sft.run: 3 vla_adapter steps of B = 16 (the
                  config's train_batch_size) with the vision towers frozen,
                  each launching #1, #2 and #3 exactly 24 times (one per
                  Qwen layer), every trained leaf moving and the towers
                  bit-identical; the step's forward / backward / optimizer
                  split and peak memory; the kernel path's loss and Qwen /
                  projector gradients against the plain path's on one step
                  (and non-zero); 2 vla_flow steps (24 of #1, none of #2 or
                  #3); 2 next-token SFTTrainer steps of the 24-layer WM over
                  4 rows of 1663 tokens (24 of each kernel per step);
then the card's name and power limit, the kernel table as one JSON line, and
last `{"ok": true, "device": {...}}`.  Any failure raises: the script exits
non-zero and prints no `ok` line.  It needs a CUDA device and the rest of the
repository beside it.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM data-sheet peaks (dense): the bound of a kernel is the larger of
# its bytes over the memory rate and its operations over the bf16 rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

N_REQUESTS = 4
O_TOL = 2e-2  # bf16 O (2^-8 relative) and bf16 P in the P.V product
LSE_TOL = 1e-3  # f32 LSE; scores are exact bf16 products summed in f32
HIDDEN_TOL = 5e-2  # kernel vs plain path, relative to max|hidden|, 24 bf16 layers
ACTION_TOL = 5e-2  # normalized actions after 10 bf16 Euler steps
# decode kernel vs twin: both dequantise to bf16 and attend in f32, the twin
# with P in f32 and the kernel with P in two bf16 terms (16 bits), so they
# differ by that and by f32 summation order before O is rounded to bf16:
# |dO| <= DEC_RTOL * |O| + DEC_ATOL, one bf16 ulp plus a small floor
DEC_RTOL, DEC_ATOL = 2 ** -7, 2e-3
# WM kernel path vs plain path, max|d logits| / max|logits|: 24 bf16 layers
# whose int8 caches are written from each path's own hidden states
WM_LOGIT_TOL = 5e-2
# flash backward kernels vs their f32 twin, per gradient: max|d| <=
# BWD_RTOL * max|ref| + BWD_ATOL.  The kernels round p and dS to bf16 for
# their second products and dq/dk/dv to bf16 at the end (one bf16 ulp is
# 2^-8 relative), and sum in f32 in another order.
BWD_RTOL, BWD_ATOL = 2 ** -7, 1e-3
# SFT step, kernel path vs plain path on the same params, batch and noise:
# the loss (relative) and the Qwen q/k/v and projector gradients (max|d| /
# max|g|) after 24 bf16 layers forward and backward, each path rounding its
# own activations to bf16 (the serving check's 5e-2 for the gradients; the
# loss is a mean over 16 x 56 flow values, so it averages the differences)
SFT_LOSS_TOL, SFT_GRAD_TOL = 1e-3, 5e-2
SFT_STEPS = 3
# learning rates of the libero vla_adapter run.  The VLM's parameters are
# bf16 with no f32 master copy (as in the reference), so an Adam step of
# the default 2e-5 cannot move a norm weight of 1.0 (half a bf16 ulp there
# is 2^-8); 5e-3 moves every trained leaf, which the phase checks
SFT_VLM_LR, SFT_EXPERT_LR = 5e-3, 1e-4
WM_SFT_ROWS, WM_SFT_PROMPT, WM_SFT_LEN = 4, 1095, 1663

WM_PREFIX = 1088  # shared prompt head: 1024 ctx tokens + the 64 dyn tokens of frame 0
# the configured WM call of 128 rows (rollout.micro_batch_size): a 64-sequence
# step's policy rows (16 samples x n = 4) then their gt rows, in that order
B128_PREFIX_MAP = [i // 4 % 16 for i in range(128)]
N_SAMPLES, N_ROLLOUTS = 2, 4
# fused decode kernels vs twins: both round every product and residual to
# bf16 in the reference's order and differ only in the order of f32 sums,
# which can move one bf16 rounding: bf16 outputs |d| <= 2^-7 max|ref|, int8
# k/v within one quantum (two where the scales differ) on at most 1 % of
# entries (0.012-0.117 % measured at WM width on an H100); k/v scales at
# most 2 bf16 ulps from the twin's (an amax one ulp away moves bf16(amax /
# 127) by up to two, proven over every bf16 amax in
# tests/test_torch_kernel_redesign_qkv_dkv.py), on at most 1 % of scales
FUSED_RTOL = 2 ** -7
FUSED_INT8_SHARE = 0.01
SCALE_ULPS = 2
# the launches of #8 and #9's three, by the name of their kernel instance
QKV_KERNELS = {"qkv": "streaming_product<3"}
O_MLP_KERNELS = {"o_proj": "streaming_product<0", "gate_up": "streaming_product<1",
                 "down": "streaming_product<2"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time of fn() in ms (CUDA events around `iters` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph(fn, iters: int):
    """`iters` calls of fn captured in a CUDA graph, after 3 warm-up calls on
    a side stream; replayed once before it is returned."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one fn() call in ms: `iters` calls captured in a CUDA
    graph and replayed, so the host's launch pace does not set the time
    (back-to-back eager calls of a small kernel measure the Python wrapper)."""
    graph = _graph(fn, iters)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * iters)
    del graph
    torch.cuda.empty_cache()
    return ms


def graph_kernel_ms(fn, names: dict, iters: int = 20) -> dict:
    """{key: {"ms", "launches"}}: the device ms per launch of the kernels
    whose names contain names[key], from torch.profiler over one replay of
    `iters` calls of fn captured in a CUDA graph."""
    graph = _graph(fn, iters)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for key, sub in names.items():
        us = [e.time_range.end - e.time_range.start for e in kernels if sub in e.name]
        out[key] = {"ms": sum(us) / 1e3 / max(len(us), 1), "launches": len(us)}
    return out


def repeats_bit_for_bit(fn, calls: int = 3) -> bool:
    """fn() `calls` times on the same inputs: every output tensor the same bits."""
    outs = [fn() for _ in range(calls)]
    torch.cuda.synchronize()
    as_tuple = lambda o: o if isinstance(o, tuple) else (o,)
    return all(torch.equal(a, b) for o in outs[1:] for a, b in zip(as_tuple(outs[0]), as_tuple(o)))


def host_ms(fn):
    """(fn(), its ms on the host clock, ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(nbytes: int, flops: int) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the bf16 rate, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def attn_pairs(B, Sq, Sk, dev, kv_lens, kv_starts, q_offset, causal):
    """(key positions some query of the row reads, summed over rows; valid
    (query, key) pairs per query head)."""
    kv = torch.arange(Sk, device=dev)[None, None, :]
    qp = torch.arange(Sq, device=dev)[None, :, None] + q_offset[:, None, None]
    valid = (kv < kv_lens[:, None, None]) & (kv >= kv_starts[:, None, None])
    if causal:
        valid = valid & (qp >= kv)
    return int(valid.any(dim=1).sum()), int(valid.sum())


def flash_work(q, k, kv_lens, kv_starts, q_offset, causal):
    """(bytes, flops) the function needs on these inputs: q read once, K/V
    read once at the key positions some query of the row attends to (masked
    positions are never needed), O and LSE written once; 4*D flops per
    valid (query, key) pair."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    keys, pairs = attn_pairs(B, Sq, Sk, q.device, kv_lens, kv_starts, q_offset, causal)
    io = 2 * B * Sq * Hq * D + 2 * 2 * keys * Hkv * D + 2 * B * Sq * Hq * D + 4 * B * Sq * Hq
    return io, 4 * D * pairs * Hq


def bwd_work(q, k, kv_lens, kv_starts, q_offset, causal):
    """{kernel: (bytes, flops)} of the two backward kernels on these inputs.
    Both read q, dO, the f32 LSE and delta once and K/V at the needed key
    positions; #2 writes dq, #3 writes dk and dv.  Per valid (query, key)
    pair #2 does 3 products of 2*D flops (S, dP, dQ), #3 does 4 (S, dP, dV,
    dK)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    keys, pairs = attn_pairs(B, Sq, Sk, q.device, kv_lens, kv_starts, q_offset, causal)
    rows_in = 2 * 2 * B * Sq * Hq * D + 2 * 4 * B * Sq * Hq + 2 * 2 * keys * Hkv * D
    return {"dq": (rows_in + 2 * B * Sq * Hq * D, 6 * D * pairs * Hq),
            "dkv": (rows_in + 2 * 2 * B * Sk * Hkv * D, 8 * D * pairs * Hq)}


def phase_build() -> dict:
    from vla_rft_tpu_torch.ops import attention, cuda_build, decode_attention_hd
    from vla_rft_tpu_torch.ops import fused_decode_attention, fused_decode_layer

    t0 = time.perf_counter()
    infos = cuda_build.build("flash_fwd", "flash_bwd", "decode_hd", "decode_heads",
                             "fused_decode_layer", "fused_decode_attention")
    wall = time.perf_counter() - t0
    attention._load()
    attention._load_bwd()
    decode_attention_hd._load("hd")
    decode_attention_hd._load("heads")
    fused_decode_layer._load()
    fused_decode_attention._load()
    libs = {}
    for name, info in infos.items():
        # ptxas's lines per kernel: its (mangled) name, then registers and spills
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "Compiling entry function" in ln or "registers" in ln or "smem" in ln
                 or "spill" in ln]
        libs[name] = {"seconds": round(info["seconds"], 3), "built": info["built"],
                      "library": os.path.relpath(info["path"]), "ptxas": ptxas}
    out = {"phase": "build", "wall_seconds": round(wall, 3), "libraries": libs}
    emit(out)
    return out


def phase_flash(attention) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    D = 64
    cases = [
        # (name, B, Sq, Sk, per-row kwargs); all causal, as the Qwen and WM
        # forwards; Hq/Hkv 14/2 (Qwen) unless the case is the WM's 16/16
        ("serving_b1", 1, 352, 352, {}),
        ("right_pad_b4", 4, 352, 352, {"kv_lens": [352, 300, 161, 97]}),
        ("left_pad_b4_608", 4, 608, 608, {"kv_starts": [0, 64, 100, 333]}),
        ("q_offset_chunk", 1, 100, 608, {"q_offset": [508]}),
        ("fully_masked_row", 4, 352, 352, {"kv_lens": [352, 0, 352, 200],
                                           "kv_starts": [0, 0, 352, 50]}),
        ("ragged_300", 4, 300, 300, {"kv_lens": [300, 299, 250, 1]}),
        # the WM's shared-prefix prefill: 2 unique prefixes of 1088 tokens in
        # a cache rounded up to 1152 positions
        ("wm_prefill", 2, WM_PREFIX, 1152, {"kv_lens": [WM_PREFIX, WM_PREFIX]}),
    ]
    results, err_o, err_lse = [], 0.0, 0.0
    for name, B, Sq, Sk, kw in cases:
        Hq, Hkv = (16, 16) if name.startswith("wm") else (14, 2)
        q = torch.randn(B, Sq, Hq, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
        args = {a: torch.tensor(x, dtype=torch.int32, device=dev) for a, x in kw.items()}
        o, lse = attention.flash_fwd(q, k, v, causal=True, **args)
        torch.cuda.synchronize()
        o_ref, lse_ref = attention.attention_plain(q, k, v, causal=True, return_lse=True, **args)
        e_o = (o.float() - o_ref.float()).abs().max().item()
        e_l = (lse - lse_ref).abs().max().item()
        if not (e_o <= O_TOL and e_l <= LSE_TOL and torch.isfinite(o.float()).all()):
            raise AssertionError(f"flash case {name}: max|dO|={e_o} max|dLSE|={e_l}")
        if "fully_masked" in name:
            dead = o[1].float().abs().max().item(), o[2].float().abs().max().item()
            if dead != (0.0, 0.0) or not bool((lse[1] == attention.NEG_INF).all()):
                raise AssertionError(f"fully-masked rows not zero: {dead}")
        err_o, err_lse = max(err_o, e_o), max(err_lse, e_l)
        results.append({"case": name, "B": B, "Sq": Sq, "Sk": Sk, "max_abs_err_o": e_o,
                        "max_abs_err_lse": e_l})

    # time at the serving shape (one request, S = 96 text + 256 patches,
    # 14/2 heads) and at the WM prefill shape (2 x 1088 queries, 16/16 heads)
    timed = {}
    for shape, B, Sq, Sk, Hq, Hkv, kv_len in (("serving", 1, 352, 352, 14, 2, 352),
                                               ("wm_prefill", 2, WM_PREFIX, 1152, 16, 16,
                                                WM_PREFIX)):
        q = torch.randn(B, Sq, Hq, D, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
        rows = {"kv_lens": torch.full((B,), kv_len, dtype=torch.int32, device=dev),
                "kv_starts": torch.zeros(B, dtype=torch.int32, device=dev),
                "q_offset": torch.zeros(B, dtype=torch.int32, device=dev)}
        # SDPA over the valid keys only (a yardstick: the port never calls it)
        qt, kt, vt = (x[:, :kv_len].transpose(1, 2) for x in (q, k, v))
        kern = lambda: attention.flash_fwd(q, k, v, causal=True, **rows)
        if not repeats_bit_for_bit(kern):
            raise AssertionError(f"flash at {shape}: three calls gave different bits")
        kernel_ms = graph_ms(kern)
        eager_ms = cuda_ms(kern)
        plain_ms = graph_ms(lambda: attention.attention_plain(q, k, v, causal=True,
                                                              return_lse=True, **rows), 5)
        library_ms = graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                                     enable_gqa=True))
        nbytes, flops = flash_work(q, k, rows["kv_lens"], rows["kv_starts"], rows["q_offset"],
                                   True)
        timed[shape] = {"B": B, "Sq": Sq, "Sk": Sk, "kv_len": kv_len, "Hq": Hq, "Hkv": Hkv,
                        "D": D, "causal": True, "repeats_bit_for_bit": True,
                        "kernel_ms": kernel_ms, "eager_ms": eager_ms,
                        "plain_ms": plain_ms,
                        "library_ms": library_ms, **bound(nbytes, flops)}
    out = {"phase": "flash", "cases": results, "max_abs_err_o": err_o,
           "max_abs_err_lse": err_lse, "tolerance": {"o": O_TOL, "lse": LSE_TOL},
           "timed": timed}
    emit(out)
    return out


def phase_flash_bwd(attention) -> dict:
    """Kernels #2 and #3 against the backward twin, then timed at the two
    SFT shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [
        # (name, B, Sq, Sk, Hq, Hkv, D, per-row kwargs): phase_flash's cases,
        # D = 128, and one row of the WM's 1663 tokens (not a multiple of 64)
        ("serving_b1", 1, 352, 352, 14, 2, 64, {}),
        ("right_pad_b4", 4, 352, 352, 14, 2, 64, {"kv_lens": [352, 300, 161, 97]}),
        ("left_pad_b4_608", 4, 608, 608, 14, 2, 64, {"kv_starts": [0, 64, 100, 333]}),
        ("q_offset_chunk", 1, 100, 608, 14, 2, 64, {"q_offset": [508]}),
        ("fully_masked_row", 4, 352, 352, 14, 2, 64, {"kv_lens": [352, 0, 352, 200],
                                                      "kv_starts": [0, 0, 352, 50]}),
        ("ragged_300", 4, 300, 300, 14, 2, 64, {"kv_lens": [300, 299, 250, 1]}),
        ("d128_ragged", 2, 300, 300, 14, 2, 128, {"kv_lens": [300, 190], "kv_starts": [0, 7]}),
        ("wm_sft_row", 1, WM_SFT_LEN, WM_SFT_LEN, 16, 16, 64, {}),
    ]
    results, err = [], {"dq": 0.0, "dkv": 0.0}
    for name, B, Sq, Sk, Hq, Hkv, D, kw in cases:
        for causal in (True, False):
            q, do = (torch.randn(B, Sq, Hq, D, generator=gen, device=dev).bfloat16()
                     for _ in range(2))
            k, v = (torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
                    for _ in range(2))
            args = {a: torch.tensor(x, dtype=torch.int32, device=dev) for a, x in kw.items()}
            o, lse = attention.flash_fwd(q, k, v, causal=causal, **args)
            got = attention.flash_bwd(q, k, v, o, lse, do, causal=causal, **args)
            torch.cuda.synchronize()
            ref = attention.attention_bwd_plain(q, k, v, o, lse, do, causal=causal, **args)
            errs = {}
            for g_name, g, r in zip(("dq", "dk", "dv"), got, ref):
                e = (g.float() - r.float()).abs().max().item()
                lim = BWD_RTOL * r.float().abs().max().item() + BWD_ATOL
                if not (e <= lim and bool(torch.isfinite(g.float()).all())):
                    raise AssertionError(f"flash_bwd case {name} causal={causal}: "
                                         f"max|d{g_name}| {e} > {lim}")
                errs[g_name] = e
            if name == "fully_masked_row" and not all(bool((g[1:3] == 0).all()) for g in got):
                raise AssertionError("fully-masked rows have non-zero gradients")
            err["dq"] = max(err["dq"], errs["dq"])
            err["dkv"] = max(err["dkv"], errs["dk"], errs["dv"])
            results.append({"case": name, "causal": causal, "B": B, "Sq": Sq, "Sk": Sk,
                            "Hq": Hq, "Hkv": Hkv, "D": D, "max_abs_err": errs})

    # time at the SFT shapes: the VLA-adapter step's Qwen layer (16 rows of
    # 96 text + 256 patch tokens, the last text token padding, 14/2 heads)
    # and the WM-SFT step's layer (4 rows of 1663 tokens, 16/16 heads)
    timed = {}
    for shape, B, S, Hq, Hkv, kv_len in (("vla_adapter", 16, 352, 14, 2, 351),
                                         ("wm_sft", WM_SFT_ROWS, WM_SFT_LEN, 16, 16,
                                          WM_SFT_LEN)):
        q, do = (torch.randn(B, S, Hq, 64, generator=gen, device=dev).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(B, S, Hkv, 64, generator=gen, device=dev).bfloat16()
                for _ in range(2))
        rows = {"kv_lens": torch.full((B,), kv_len, dtype=torch.int32, device=dev),
                "kv_starts": torch.zeros(B, dtype=torch.int32, device=dev),
                "q_offset": torch.zeros(B, dtype=torch.int32, device=dev)}
        o, lse = attention.flash_fwd(q, k, v, causal=True, **rows)
        delta = (do.float() * o.float()).sum(dim=-1)
        kw = dict(causal=True, **rows)
        plain_ms = graph_ms(lambda: attention.attention_bwd_plain(q, k, v, o, lse, do, **kw), 3)
        # autograd backward of SDPA over the same rows (a yardstick: the port
        # never calls it): forward + backward replayed from a CUDA graph,
        # less the forward alone
        leaves = [x[:, :kv_len].transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)]
        do_lib = do[:, :kv_len].transpose(1, 2)
        sdpa = lambda: F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                      enable_gqa=Hq != Hkv)
        library_ms = (graph_ms(lambda: torch.autograd.grad(sdpa(), leaves, do_lib))
                      - graph_ms(sdpa))
        work = bwd_work(q, k, rows["kv_lens"], rows["kv_starts"], rows["q_offset"], True)
        entry = {"B": B, "S": S, "kv_len": kv_len, "Hq": Hq, "Hkv": Hkv, "D": 64, "causal": True,
                 "plain_ms": plain_ms, "library_ms": library_ms}
        dkv = lambda: attention.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        dq = lambda: attention.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        for name, fn in (("flash_bwd_dkv", dkv), ("flash_bwd_dq", dq)):
            if not repeats_bit_for_bit(fn):
                raise AssertionError(f"{name} at {shape}: three calls gave different bits")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        timed[shape] = {
            "dq": {**entry, "kernel_ms": graph_ms(dq), "eager_ms": cuda_ms(dq),
                   "repeats_bit_for_bit": True,
                   "plan": attention.dq_plan(B, S, Hq, True),
                   **bound(*work["dq"])},
            "dkv": {**entry, "kernel_ms": graph_ms(dkv), "eager_ms": cuda_ms(dkv),
                    "repeats_bit_for_bit": True, "plan": attention.dkv_plan(B, S, Hq, Hkv, sms),
                    **bound(*work["dkv"])},
        }
        del leaves
    out = {"phase": "flash_bwd", "cases": results, "max_abs_err": err,
           "tolerance": f"max|d| <= {BWD_RTOL} * max|ref| + {BWD_ATOL} per gradient",
           "timed": timed}
    emit(out)
    torch.cuda.empty_cache()
    return out


def phase_serving(attention) -> dict:
    from vla_rft_tpu_torch.eval.policy import build_policy_fn
    from vla_rft_tpu_torch.serving.action_server import ActionServer, get_action_from_server
    from vla_rft_tpu_torch.workers.predict import encode_context, predict_action

    t0 = time.perf_counter()
    policy_fn = build_policy_fn(preset="libero", device="cuda", seed=7)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    bundle = policy_fn.bundle
    n_layers = bundle.vla_cfg.llm.num_layers
    rng = np.random.default_rng(0)
    requests = [
        {"instruction": "put both the alphabet soup and the tomato sauce in the basket",
         "full_image": rng.integers(0, 256, (224, 224, 3), dtype=np.uint8),
         "proprio": rng.normal(size=8).astype(np.float32)}
        for _ in range(N_REQUESTS)
    ]
    server = ActionServer(policy_fn, host="127.0.0.1", port=0)
    server.start_background()
    latencies, per_request = [], []
    try:
        url = f"http://127.0.0.1:{server.port}/act"
        attention.launches = 0  # the main path starts here
        for req in requests:
            before = attention.launches
            t = time.perf_counter()
            action = get_action_from_server(req, url, timeout=600)
            latencies.append((time.perf_counter() - t) * 1e3)
            per_request.append(attention.launches - before)
            if action.shape != (8, 7) or not np.isfinite(action).all():
                raise AssertionError(f"bad action chunk: shape {action.shape}")
        main_path_launches = attention.launches  # read right after the main path
    finally:
        server.shutdown()
    if per_request != [n_layers] * N_REQUESTS:
        raise AssertionError(f"kernel launches per request {per_request}, expected {n_layers}")

    # kernel path vs plain path on one request, same weights and noise
    lm = bundle.vla.language_model
    batch = policy_fn.make_batch(requests[0], requests[0]["instruction"])
    noise = torch.randn(1, 8, 7, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    with torch.no_grad():
        h_kernel = encode_context(bundle.vla, batch).float()
        a_kernel = predict_action(bundle.vla, bundle.expert, batch, noise=noise).float()
        lm.attn_impl = "plain"
        try:
            h_plain = encode_context(bundle.vla, batch).float()
            a_plain = predict_action(bundle.vla, bundle.expert, batch, noise=noise).float()
        finally:
            lm.attn_impl = "auto"
    h_err = ((h_kernel - h_plain).abs().max() / h_plain.abs().max()).item()
    a_err = (a_kernel - a_plain).abs().max().item()
    if not (h_err <= HIDDEN_TOL and a_err <= ACTION_TOL):
        raise AssertionError(f"kernel vs plain path: hidden rel err {h_err}, action err {a_err}")

    # where a request's device time goes (kernel path, CUDA events)
    vla = bundle.vla
    with torch.no_grad():
        vision_ms = cuda_ms(lambda: vla.projector(vla.vision_backbone(batch["pixels"])), 10, 2)
        encode_ms = cuda_ms(lambda: encode_context(vla, batch), 10, 2)
        predict_ms = cuda_ms(lambda: predict_action(vla, bundle.expert, batch, noise=noise), 5, 1)
    out = {"phase": "serving", "preset": "libero", "requests": N_REQUESTS,
           "seq_len": int(batch["input_ids"].shape[1]) + bundle.vla_cfg.total_patches,
           "build_policy_s": build_s, "first_request_ms": latencies[0],
           "steady_request_ms": float(np.median(latencies[1:])), "request_ms": latencies,
           "launches_per_request": per_request, "main_path_launches": main_path_launches,
           "kernel_vs_plain": {"hidden_rel_err": h_err, "action_max_abs_err": a_err,
                               "tolerance": {"hidden_rel": HIDDEN_TOL, "action": ACTION_TOL}},
           "device_ms": {"vision_and_projector": vision_ms, "encode_context": encode_ms,
                         "predict_action": predict_ms,
                         "flow_steps": predict_ms - encode_ms}}
    emit(out)
    return out


def _decode_inputs(dec, gen, *, int8, B, Sq, G, Hkv, Sr, shared, own, starts=None, pm=None,
                   Sp=1152, shared_len=WM_PREFIX, per_row=False, heads=False, n_prefix=2):
    """Random inputs of one decode call: (kernel fn, twin fn, info, tensors).
    `dec` is the layout's module (ops/decode_attention_hd.py, or with `heads`
    ops/decode_attention.py, whose caches are the same draws transposed to
    (rows, Hkv, S, D))."""
    dev = torch.device("cuda")
    Hq = Hkv * G
    layout = ((lambda c: c.view(c.shape[0], c.shape[1], Hkv, 64).transpose(1, 2).contiguous())
              if heads else (lambda c: c))

    def cache(rows, S):
        if int8:
            c = [layout(torch.randint(-127, 128, (rows, S, Hkv * 64), generator=gen, device=dev,
                                      dtype=torch.int8)) for _ in range(2)]
            s = tuple((torch.rand(rows, Hkv, S, generator=gen, device=dev) * 0.04 + 0.01)
                      .bfloat16() for _ in range(2))
            return c, s
        return [layout(torch.randn(rows, S, Hkv * 64, generator=gen, device=dev).bfloat16())
                for _ in range(2)], None

    q = torch.randn(B, Sq, Hq, 64, generator=gen, device=dev).bfloat16()
    (ck, cv), sc = cache(B, Sr)
    own = torch.tensor(own, device=dev, dtype=torch.int32)
    starts = torch.tensor(starts if starts is not None else [0] * B, device=dev,
                          dtype=torch.int32)
    t = {"q": q, "ck": ck, "cv": cv, "sc": sc, "own": own}
    if shared:
        (sck, scv), ssc = cache(n_prefix, Sp)
        pm = torch.tensor(pm, device=dev, dtype=torch.int32)
        kv_lens = shared_len + own
        kw = dict(shared_len=shared_len, kv_lens=kv_lens, q_offset=kv_lens - Sq,
                  shared_starts=starts, scales=sc, shared_scales=ssc)
        kern = lambda: dec.decode_shared_kernel(q, ck, cv, sck, scv, pm, **kw)
        twin = lambda: dec.decode_shared_plain(q, ck, cv, sck, scv, pm, **kw)
        t.update(sck=sck, scv=scv, ssc=ssc, pm=pm)
    else:
        kw = dict(kv_lens=own, q_offset=own - Sq, kv_starts=starts, scales=sc)
        kern = lambda: dec.decode_kernel(q, ck, cv, **kw)
        twin = lambda: dec.decode_plain(q, ck, cv, **kw)
    info = {"int8": int8, "B": B, "Sq": Sq, "Hq": Hq, "Hkv": Hkv, "Sr": Sr, "shared": shared,
            "per_row_prefix_map": per_row}
    return kern, twin, info, t


def phase_decode(dec, heads: bool = False) -> dict:
    """The split-cache decode kernels against their twins, then timed: #4 /
    #5 over the 'hd' cache, or with `heads` #6 / #7 over the 'heads' cache
    (`dec` the layout's module), on the same cases."""
    from vla_rft_tpu_torch.ops.decode_attention_hd import decode_plan

    gen = torch.Generator(device="cuda").manual_seed(3)
    B = N_SAMPLES * (N_ROLLOUTS + 1)
    uniform = [0] * 5 + [1] * 5  # each sample's 4 rollouts, then its gt row
    per_row = [0, 1, 1, 0, 1, 0, 0, 1, 0, 1]
    # ragged own lengths; row 0's own segment holds only the current block
    own = lambda Sq: [Sq, 150, 291, 300, 7 + Sq, 384, 77, 200, 291, 12 + Sq]
    cases = []
    for int8 in (True, False):
        for Sq in (1, 7):
            cases.append(dict(int8=int8, B=B, Sq=Sq, G=1, Hkv=16, Sr=384, shared=True,
                              pm=uniform, own=own(Sq), starts=[5] * 5 + [0] * 5))
            cases.append(dict(int8=int8, B=B, Sq=Sq, G=1, Hkv=16, Sr=384, shared=True,
                              per_row=True, pm=per_row, own=own(Sq),
                              starts=[0, 9, 0, 0, 3, 0, 0, 0, 1, 0]))
            # kernel #5: one cache, ragged lengths and left padding
            cases.append(dict(int8=int8, B=B, Sq=Sq, G=1, Hkv=16, Sr=1408, shared=False,
                              own=[1379, Sq, 800, 1408, 1200, 64, 1000, 1379, 999, 500],
                              starts=[0, 0, 17, 0, 300, 0, 63, 0, 0, 499]))
        # windows cut short: shared_starts and kv_starts leave a few keys
        # (row 3 keeps none of its prefix, row 4 one key of it), so a kernel
        # that ignored them, or was off by one at either end, would fail
        cases.append(dict(int8=int8, B=B, Sq=1, G=1, Hkv=16, Sr=384, shared=True, pm=per_row,
                          own=[1, 3, 5, 2, 1, 150, 9, 1, 4, 2],
                          starts=[1080, 1085, 1000, WM_PREFIX, WM_PREFIX - 1, 1087, 600, 1086,
                                  1084, 0]))
        cases.append(dict(int8=int8, B=B, Sq=7, G=1, Hkv=16, Sr=1408, shared=False,
                          own=[1379, 9, 800, 1408, 1200, 64, 1000, 1379, 999, 500],
                          starts=[1378, 6, 797, 1400, 1199, 63, 990, 1372, 998, 495]))
    # the configured 128-row WM call (a 64-sequence step's policy rows, then
    # its gt rows: 16 prefixes each shared by 8 rows that are not adjacent)
    # and one prefix shared by 40 rows (chunks of 16 rows read it 3 times)
    cases.append(dict(int8=True, B=128, Sq=1, G=1, Hkv=16, Sr=384, shared=True, n_prefix=16,
                      pm=B128_PREFIX_MAP, own=[7 + (37 * i) % 378 for i in range(128)],
                      starts=[(5 * i) % 13 for i in range(128)]))
    cases.append(dict(int8=False, B=40, Sq=1, G=1, Hkv=16, Sr=384, shared=True, pm=[1] * 40,
                      own=[1 + (53 * i) % 384 for i in range(40)], starts=[0] * 40))
    # GQA 14/2 (the policy's head layout) on both kernels
    cases.append(dict(int8=True, B=4, Sq=7, G=7, Hkv=2, Sr=256, shared=True, pm=[0, 0, 1, 1],
                      own=[7, 100, 256, 31], starts=[0, 0, 2, 2]))
    cases.append(dict(int8=False, B=4, Sq=1, G=7, Hkv=2, Sr=256, shared=False,
                      own=[256, 1, 90, 200], starts=[0, 0, 10, 199]))
    results, err = [], {"shared": 0.0, "plain": 0.0}
    for case in cases:
        kern, twin, info, _ = _decode_inputs(dec, gen, heads=heads, **case)
        o = kern()
        torch.cuda.synchronize()
        ref = twin().float()
        d = (o.float() - ref).abs()
        e = d.max().item()
        if not (torch.isfinite(o.float()).all()
                and bool((d <= DEC_RTOL * ref.abs() + DEC_ATOL).all())):
            raise AssertionError(f"decode case {info}: max|dO|={e}")
        key = "shared" if case["shared"] else "plain"
        err[key] = max(err[key], e)
        results.append({**info, "max_abs_err": e})

    # Time at the WM's mid-rollout shape: 10 rows (2 samples x (4 + gt)),
    # 2 prefixes of 1088 valid positions, own length 7 + 4 * 71 = 291 (frame
    # 4 of 8), one query, int8 cache; the shared route also at the
    # configured 128 rows per WM call (16 prefixes of 8 rows).  #5 at the
    # plain route's shape: the whole 1095 + 4 * 71 = 1379-token context in
    # each row's cache.  Each is also held against its twin and called three
    # times for the same bits.
    mid = 7 + 4 * 71
    timed = {}
    for key, case in (("shared", dict(int8=True, B=B, Sq=1, G=1, Hkv=16, Sr=384, shared=True,
                                      pm=uniform, own=[mid] * B)),
                      ("shared_b128", dict(int8=True, B=128, Sq=1, G=1, Hkv=16, Sr=384,
                                           shared=True, n_prefix=16, pm=B128_PREFIX_MAP,
                                           own=[mid] * 128)),
                      ("plain", dict(int8=True, B=B, Sq=1, G=1, Hkv=16, Sr=1408, shared=False,
                                     own=[1095 + mid - 7] * B))):
        kern, twin, info, t = _decode_inputs(dec, gen, heads=heads, **case)
        o, ref = kern(), twin().float()
        if not bool((((o.float() - ref).abs()) <= DEC_RTOL * ref.abs() + DEC_ATOL).all()):
            raise AssertionError(f"decode timed case {key}: max|dO| "
                                 f"{(o.float() - ref).abs().max().item()}")
        if not repeats_bit_for_bit(kern):
            raise AssertionError(f"decode timed case {key}: three calls gave different bits")
        Bt = case["B"]
        L = case["own"][0]
        seq = (lambda c, n: c[:, :, :n]) if heads else (lambda c, n: c[:, :n])
        k_all = dec.dequantize(seq(t["ck"], L), t["sc"][0][:, :, :L], 64, torch.bfloat16)
        v_all = dec.dequantize(seq(t["cv"], L), t["sc"][1][:, :, :L], 64, torch.bfloat16)
        positions = Bt * L  # distinct cache positions the call must read
        if key == "shared":
            pm = t["pm"].long()
            k_sh = dec.dequantize(seq(t["sck"], WM_PREFIX), t["ssc"][0][:, :, :WM_PREFIX], 64,
                                  torch.bfloat16)[pm]
            v_sh = dec.dequantize(seq(t["scv"], WM_PREFIX), t["ssc"][1][:, :, :WM_PREFIX], 64,
                                  torch.bfloat16)[pm]
            k_all, v_all = torch.cat([k_sh, k_all], 1), torch.cat([v_sh, v_all], 1)
            positions += int(pm.unique().numel()) * WM_PREFIX
        # SDPA over K/V already dequantised and concatenated: a yardstick
        # that skips the dequantisation (the port never calls it)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (t["q"], k_all, v_all))
        keys = k_all.shape[1]
        # int8 K/V + bf16 scales, q, O
        nbytes = positions * 2 * 16 * (64 + 2) + 2 * 2 * Bt * 16 * 64
        flops = 4 * 64 * Bt * 16 * keys
        n_prefix = case.get("n_prefix", 2) if case["shared"] else 0
        plan = decode_plan(Bt, 1, 1, 16, case["Sr"], case["shared"], n_prefix,
                           WM_PREFIX if case["shared"] else 0,
                           torch.cuda.get_device_properties(0).multi_processor_count)
        timed[key] = {**info, "keys_per_row": keys, "kernel_ms": graph_ms(kern),
                      "eager_ms": cuda_ms(kern, 100), "plain_ms": graph_ms(twin, 10),
                      "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt)),
                      "repeats_bit_for_bit": True, "plan": plan, **bound(nbytes, flops)}
    out = {"phase": "decode_heads" if heads else "decode", "cases": results, "max_abs_err": err,
           "tolerance": f"|dO| <= {DEC_RTOL} * |O| + {DEC_ATOL}", "timed": timed}
    emit(out)
    return out


def wm_inputs(b, seed: int = 0):
    """Seeded raw inputs of one training step: 9 frames of 256 x 256 x 3
    uint8 per sample, the policy's 8-step action chunk per rollout and the
    recorded one per sample, and the action ranges ([-1, 1]^7)."""
    rng = np.random.default_rng(seed)
    T, S, A = b.num_raw_frames, b.image_size, b.proc_cfg.action_dim
    raw = rng.integers(0, 256, (N_SAMPLES, T, S, S, 3), dtype=np.uint8)
    pred = rng.uniform(-1, 1, (N_SAMPLES * N_ROLLOUTS, T - 1, A)).astype(np.float32)
    gt = rng.uniform(-1, 1, (N_SAMPLES, T - 1, A)).astype(np.float32)
    ranges = np.stack([-np.ones(A), np.ones(A)], -1).astype(np.float32)
    return tuple(torch.from_numpy(x).cuda() for x in (raw, pred, gt, ranges))


def _decode_counts(mods) -> dict:
    """The launch count of every kernel a WM call can run; `mods` is
    (ops.attention, ops.decode_attention_hd, ops.decode_attention,
    ops.fused_decode_layer)."""
    attention, dec, heads, fdl = mods
    return {"flash_fwd": attention.launches, "decode_shared_hd": dec.shared_launches,
            "decode_hd": dec.plain_launches, "decode_shared_heads": heads.shared_heads_launches,
            "decode_heads": heads.heads_launches, "fused_qkv": fdl.qkv_launches,
            "fused_o_mlp": fdl.o_mlp_launches}


def _zero_decode_counts(mods) -> None:
    attention, dec, heads, fdl = mods
    attention.launches = dec.shared_launches = dec.plain_launches = 0
    heads.shared_heads_launches = heads.heads_launches = 0
    fdl.qkv_launches = fdl.o_mlp_launches = 0


def _expect(**nonzero) -> dict:
    """Expected launch counts: the given kernels, every other one 0."""
    return {**{k: 0 for k in ("flash_fwd", "decode_shared_hd", "decode_hd",
                              "decode_shared_heads", "decode_heads", "fused_qkv",
                              "fused_o_mlp")}, **nonzero}


def phase_wm_reward(mods) -> dict:
    from vla_rft_tpu_torch.models.factory import build_wm_reward
    from vla_rft_tpu_torch.trainer.grpo_trainer import (process_stage, reward_stage,
                                                        wm_rollout_stage, wm_rows)
    from vla_rft_tpu_torch.workers.reward import (detokenize_response_frames,
                                                  perceptual_loss_frames)

    (b, build_ms) = host_ms(lambda: build_wm_reward("libero", device="cuda", seed=11))
    n, roll, pc = N_ROLLOUTS, b.roll_cfg, b.proc_cfg
    raw, pred, gt, ranges = wm_inputs(b, seed=0)
    total = N_SAMPLES * n
    V, A, Fn = roll.interact_max_tokens, roll.action_dim, roll.num_frames
    calls = 1 + Fn * (V + 1)  # tail prefill, then per frame V tokens and one action chunk
    runs = []
    for run in (1, 2):
        gen = torch.Generator(device="cuda").manual_seed(run)
        torch.cuda.reset_peak_memory_stats()
        ms = {}
        with torch.no_grad():
            _zero_decode_counts(mods)  # main path
            out, ms["process"] = host_ms(lambda: process_stage(b, ranges, raw, pred, gt, n, True))
            rows = wm_rows(b, out, n, True, True)
            (responses, gt_responses), ms["wm_rollout"] = host_ms(lambda: wm_rollout_stage(
                b, b.wm, rows, 128, lambda ci: gen))
            (reward, metrics), ms["reward"] = host_ms(lambda: reward_stage(
                b, out, responses, gt_responses, n, True, True, 8))
            counts = _decode_counts(mods)  # read right after the main path
        expect = _expect(flash_fwd=b.wm_cfg.num_layers,
                         decode_shared_hd=b.wm_cfg.num_layers * calls)
        if counts != expect:
            raise AssertionError(f"wm_reward run {run}: launches {counts}, expected {expect}")
        if responses.shape != (total, roll.response_length) or gt_responses.shape != (
                N_SAMPLES, roll.response_length):
            raise AssertionError(f"response shapes {tuple(responses.shape)}, "
                                 f"{tuple(gt_responses.shape)}")
        both = torch.cat([responses, gt_responses])
        frames = both.reshape(-1, Fn, V + A)
        act_in = torch.cat([out["action_ids"], out["gt_action_ids"][::n]])[:, 1:].cuda()
        if not (bool(((both >= 0) & (both < b.wm_cfg.vocab_size)).all())
                and torch.equal(frames[:, :, V:], act_in[:, :Fn])):
            raise AssertionError("response tokens out of range or actions not teacher-forced")
        if not (bool(torch.isfinite(reward).all()) and bool((reward[:, :-1] == 0).all())
                and bool((reward[:, -1] != 0).all())):
            raise AssertionError(f"bad rewards: {reward[:, -1].tolist()}")
        runs.append({"run": run, "stage_ms": ms, "total_ms": sum(ms.values()),
                     "launches": counts, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "reward_last": reward[:, -1].tolist(), "metrics": metrics})

    # the rollout's and the reward's parts, timed alone on the same inputs
    # (outside the main path)
    with torch.no_grad():
        def prefill():
            c = b.wm.init_cache(N_SAMPLES, rows.prefixes.shape[1])
            b.wm(rows.prefixes, cache=c, cache_index=0, compute_logits=False)
        _, prefill_ms = host_ms(prefill)
        _, prefill_ms = host_ms(prefill)
        (_, feats), ctx_ms = host_ms(
            lambda: b.tokenizer.ctx_decode(out["ctx_tokens"][::n] - pc.visual_token_num))
        gt_frames, gt_ms = host_ms(lambda: detokenize_response_frames(
            b.tokenizer, pc, Fn, gt_responses, feats, torch.arange(N_SAMPLES).cuda()))
        cmap = torch.arange(N_SAMPLES).repeat_interleave(n).cuda()
        _, lpips_ms = host_ms(lambda: perceptual_loss_frames(b.lpips, gt_frames[cmap], gt_frames[cmap]))
        _, lpips_ms = host_ms(lambda: perceptual_loss_frames(b.lpips, gt_frames[cmap], gt_frames[cmap]))
        _, detok_ms = host_ms(lambda: detokenize_response_frames(
            b.tokenizer, pc, Fn, responses, feats, cmap))
    trace = profile_decode_steps(b.wm, roll, rows)
    steady = runs[1]["stage_ms"]["wm_rollout"]
    out_json = {"phase": "wm_reward", "preset": "libero", "samples": N_SAMPLES, "n": n,
                "wm_rows": total + N_SAMPLES, "build_ms": build_ms, "runs": runs,
                "decode_calls_per_rollout": calls,
                "parts_ms": {"prefix_prefill": prefill_ms,
                             "decode_per_frame": (steady - prefill_ms) / Fn,
                             "context_features": ctx_ms, "detokenize_gt": gt_ms,
                             "detokenize_policy_rows": detok_ms,
                             "lpips_64_frame_pairs": lpips_ms},
                "decode_step_trace": trace}
    emit(out_json)
    return {"json": out_json, "bundle": b, "out": out, "responses": responses, "rows": rows}


def profile_decode_steps(wmod, roll, rows, fused: bool = False, steps: int = 16) -> dict:
    """torch.profiler over `steps` sampled one-token decode calls of the
    rollout over `rows` (sampling included), after a warm-up: wall and
    device-busy ms per call, the idle share, kernels per call and the decode
    kernel's device time.  `fused` sends the calls through
    decode_step_fused (the int8-weight route) instead of the module."""
    from vla_rft_tpu_torch.models.transformer import decode_step_fused
    from vla_rft_tpu_torch.ops.sampling import sample_token
    from vla_rft_tpu_torch.serving.profile_request import _busy_us

    P, P0 = roll.prompt_length, rows.prefixes.shape[1]
    pm = torch.as_tensor(rows.prefix_map, dtype=torch.int32, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(9)
    with torch.no_grad():
        shared = wmod.init_cache(rows.prefixes.shape[0], P0)
        wmod(rows.prefixes, cache=shared, cache_index=0, compute_logits=False)
        kw = dict(shared_cache=shared, shared_len=P0, prefix_map=pm)
        cache = wmod.init_cache(rows.tails.shape[0], P - P0 + 4 * roll.tokens_per_frame)
        last = wmod(rows.tails, cache=cache, cache_index=P0, kv_lens=P, logits_last_only=True,
                    **kw)[0][:, -1]

        def step(i):
            tok = sample_token(gen, last, roll.temperature, roll.top_k, roll.top_p,
                               roll.do_sample)
            if fused:
                return decode_step_fused(wmod, tok[:, None], cache, P + i, **kw)[0][:, 0]
            return wmod(tok[:, None], cache=cache, cache_index=P + i, **kw)[0][:, 0]

        for i in range(4):
            last = step(i)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(4, 4 + steps):
                last = step(i)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    dec_us = sum(e.time_range.end - e.time_range.start for e in kernels
                 if "decode_attend_kernel" in e.name)
    n_dec = sum(1 for e in kernels if "decode_attend_kernel" in e.name)
    by_name = {}
    for e in kernels:
        for key, name in (*QKV_KERNELS.items(), *O_MLP_KERNELS.items()):
            if name in e.name:
                by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start)
    return {"calls": steps, "rows": int(rows.tails.shape[0]), "fused": fused,
            "wall_ms_per_call": wall_us / 1e3 / steps,
            "device_busy_ms_per_call": busy / 1e3 / steps,
            "device_idle_share": (1.0 - busy / wall_us) if kernels else None,
            "kernels_per_call": len(kernels) / steps, "decode_kernel_launches": n_dec,
            "decode_kernel_ms_per_launch": dec_us / 1e3 / max(n_dec, 1),
            "fused_kernel_ms_per_call": {k: v / 1e3 / steps for k, v in by_name.items()}}


def phase_wm_plain(mods, wm, heads: bool = False) -> dict:
    """generate_sequences without a shared prefix (kernel #5, or #7 with
    `heads`: the same WM's weights with a 'heads' cache) on 2 rows, 2
    frames."""
    from vla_rft_tpu_torch.models.transformer import Decoder
    from vla_rft_tpu_torch.workers.wm_rollout import generate_sequences

    b, out = wm["bundle"], wm["out"]
    wmod = b.wm
    if heads:
        with torch.device("cuda"):
            wmod = Decoder(dataclasses.replace(b.wm.cfg, kv_layout="heads"))
        wmod.load_state_dict(b.wm.state_dict(), strict=True)
        wmod.eval().requires_grad_(False)
    Fn = 2
    roll = dataclasses.replace(b.roll_cfg, num_frames=Fn,
                               response_length=Fn * b.roll_cfg.tokens_per_frame)
    rows = torch.tensor([0, N_ROLLOUTS]).cuda()  # one rollout of each sample
    prompt = out["input_ids"][rows, : roll.prompt_length]
    with torch.no_grad():
        _zero_decode_counts(mods)  # main path
        resp, ms = host_ms(lambda: generate_sequences(
            wmod, torch.Generator(device="cuda").manual_seed(5), prompt,
            out["action_ids"][rows], roll))
        counts = _decode_counts(mods)
    L, V = b.wm_cfg.num_layers, roll.interact_max_tokens
    expect = _expect(flash_fwd=L, **{"decode_heads" if heads else "decode_hd": L * Fn * (V + 1)})
    if counts != expect:
        raise AssertionError(f"wm_plain: launches {counts}, expected {expect}")
    if resp.shape != (2, roll.response_length) or not bool(((resp >= 0) & (
            resp < b.wm_cfg.vocab_size)).all()):
        raise AssertionError(f"wm_plain: bad response {tuple(resp.shape)}")
    res = {"phase": "wm_plain_heads" if heads else "wm_plain", "kv_layout": wmod.cfg.kv_layout,
           "rows": 2, "frames": Fn, "rollout_ms": ms, "launches": counts}
    if heads:  # the same draws as the hd route's wm_plain over the same numbers
        res["tokens_equal_to_hd_route"] = float((resp == wm["plain_tokens"]).float().mean())
    emit(res)
    return {**res, "tokens": resp}


def _policy_rows(rows):
    """The policy rows of a WMRows layout, in call order: (tails, actions,
    prefix_map, row index into the step's responses)."""
    keep = rows.order < rows.total
    pm = torch.as_tensor(rows.prefix_map[keep], dtype=torch.int32, device="cuda")
    return rows.tails[keep], rows.actions[keep], pm, torch.as_tensor(rows.order[keep]).cuda()


def _frame0_logits(wmod, roll, prefixes, tails, actions, pm, toks, call):
    """Teacher-force frame 0 (the prompt tail, `toks` (rows, V), then the
    frame's action chunk) through `call(ids, cache, cache_index, kw,
    last_only)` after a shared-prefix prefill by the module; returns the
    logits of every call, (2 + V, rows, vocab)."""
    P, V, P0 = roll.prompt_length, roll.interact_max_tokens, prefixes.shape[1]
    shared = wmod.init_cache(prefixes.shape[0], P0)
    wmod(prefixes, cache=shared, cache_index=0, compute_logits=False)
    kw = dict(shared_cache=shared, shared_len=P0, prefix_map=pm)
    cache = wmod.init_cache(tails.shape[0], P - P0 + 2 * roll.tokens_per_frame)
    out = [wmod(tails, cache=cache, cache_index=P0, kv_lens=P, logits_last_only=True,
                **kw)[0][:, -1]]
    for i in range(V):
        out.append(call(toks[:, i:i + 1], cache, P + i, kw, False)[:, 0])
    out.append(call(actions[:, 1], cache, P + V, kw, True)[:, -1])
    return torch.stack(out)


def _rel_logit_err(k, p):
    per_call = ((k - p).abs().amax(dim=(1, 2)) / p.abs().amax(dim=(1, 2))).tolist()
    return per_call, {"max_rel_logit_err": max(per_call),
                      "max_abs_logit_err": (k - p).abs().max().item(),
                      "rel_err_prefill": per_call[0],
                      "argmax_agreement": (k.argmax(-1) == p.argmax(-1)).float().mean().item()}


def phase_wm_kernel_vs_plain(wm) -> dict:
    """Teacher-force the kernel path's frame-0 tokens through both paths."""
    b, rows = wm["bundle"], wm["rows"]
    wmod, roll = b.wm, b.roll_cfg
    tails, actions, pm, idx = _policy_rows(rows)
    toks = wm["responses"][idx, :roll.interact_max_tokens]
    module_call = lambda ids, cache, ci, kw, last: wmod(ids, cache=cache, cache_index=ci,
                                                         logits_last_only=last, **kw)[0]
    logits = {}
    with torch.no_grad():
        for impl in ("auto", "plain"):
            wmod.attn_impl = impl
            try:
                logits[impl] = _frame0_logits(wmod, roll, rows.prefixes, tails, actions, pm,
                                              toks, module_call)
            finally:
                wmod.attn_impl = "auto"
    k, p = logits["auto"], logits["plain"]
    per_call, errs = _rel_logit_err(k, p)
    if not (errs["max_rel_logit_err"] <= WM_LOGIT_TOL and bool(torch.isfinite(k).all())):
        raise AssertionError(f"WM kernel vs plain path: rel logit err {errs} > {WM_LOGIT_TOL}")
    res = {"phase": "wm_kernel_vs_plain", "calls": len(per_call), "rows": int(tails.shape[0]),
           **errs, "tolerance": WM_LOGIT_TOL}
    emit(res)
    return res


def _fused_layer(gen, H=1024, I=4096, Hq=16, Hkv=16, D=64):
    """One WM layer's seeded int8 weights, bf16 scales and norm weights."""
    dev = torch.device("cuda")

    def w(k_in, k_out):
        return (torch.randint(-127, 128, (k_in, k_out), generator=gen, device=dev,
                              dtype=torch.int8),
                ((torch.rand(k_out, generator=gen, device=dev) + 0.5) * 0.02 / k_in ** 0.5)
                .bfloat16())

    p = {"wq": w(H, Hq * D), "wk": w(H, Hkv * D), "wv": w(H, Hkv * D), "wo": w(Hq * D, H),
         "wg": w(H, I), "wu": w(H, I), "wd": w(I, H)}
    p["n1"], p["n2"] = ((1 + 0.1 * torch.randn(H, generator=gen, device=dev)).bfloat16()
                        for _ in range(2))
    return p


def _fused_args(fdl, p, gen, B, Sq, Hq, Hkv, H=1024, D=64):
    dev = torch.device("cuda")
    x = torch.randn(B, Sq, H, generator=gen, device=dev).bfloat16()
    attn = torch.randn(B, Sq, Hq * D, generator=gen, device=dev).bfloat16()
    pos = torch.arange(Sq, device=dev)[None] + torch.randint(0, 1600, (B, 1), generator=gen,
                                                             device=dev)
    cos, sins = fdl.rope_tables(pos, 10000.0, Hq, D)
    qkv = (x, cos, sins, p["n1"], *p["wq"], *p["wk"], *p["wv"])
    omlp = (attn, x, *p["wo"], p["n2"], *p["wg"], *p["wu"], *p["wd"])
    return qkv, omlp, dict(num_heads=Hq, num_kv_heads=Hkv, head_dim=D, eps=1e-6)


def _qkv_err(got, ref):
    """(within the bounds, max |dq|, largest int8 step and its share, largest
    scale step in bf16 ulps and the share of scales that differ)."""
    q, k8, v8, ks, vs = got
    rq, rk8, rv8, rks, rvs = ref
    e_q = (q.float() - rq.float()).abs().max().item()
    ok = e_q <= FUSED_RTOL * rq.float().abs().max().item()
    quanta, share, ulps, sc_share = 0, 0.0, 0, 0.0
    for t, r, sc, rs in ((k8, rk8, ks, rks), (v8, rv8, vs, rvs)):
        u = (sc.view(torch.int16).int() - rs.view(torch.int16).int()).abs()
        ulps, sc_share = max(ulps, u.max().item()), max(sc_share, (u > 0).float().mean().item())
        d = (t.int() - r.int()).abs()
        flip = (sc != rs).transpose(1, 2).repeat_interleave(t.shape[-1] // sc.shape[1], dim=-1)
        ok &= bool((d <= torch.where(flip, 2, 1)).all())
        quanta, share = max(quanta, d.max().item()), max(share, (d > 0).float().mean().item())
    ok &= ulps <= SCALE_ULPS and sc_share <= FUSED_INT8_SHARE and share <= FUSED_INT8_SHARE
    return ok, e_q, quanta, share, ulps, sc_share


def fused_work(N, H, Hq, Hkv, I, D=64):
    """{kernel: (bytes, flops)} of one call of #8 and #9 at N = B*Sq rows:
    the layer's int8 weights, bf16 scales and norm weight, the activations
    in and the results out once (for #8 the f32 rope tables too); #9's x1
    and m stay between its launches and are not counted."""
    HqD, KD = Hq * D, Hkv * D
    qkv_b = (H * (HqD + 2 * KD) + 2 * (HqD + 2 * KD) + 2 * H + 2 * N * H + 2 * 4 * N * HqD
             + 2 * N * HqD + 2 * N * KD + 2 * 2 * N * Hkv)
    omlp_b = HqD * H + 3 * H * I + 2 * (2 * H + 2 * I) + 2 * H + 2 * N * HqD + 2 * 2 * N * H
    return {"qkv": (qkv_b, 2 * N * H * (HqD + 2 * KD)),
            "o_mlp": (omlp_b, 2 * N * (HqD * H + 3 * H * I))}


def phase_fused_decode(fdl) -> dict:
    """Kernels #8 and #9 against their twins at WM width, then timed."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    H, I = 1024, 4096
    layers = {(16, 16): _fused_layer(gen), (16, 4): _fused_layer(gen, Hkv=4)}
    cases = [(1, 1, 16, 16), (10, 1, 16, 16), (128, 1, 16, 16), (2, 7, 16, 16), (10, 7, 16, 16),
             (19, 7, 16, 16), (128, 7, 16, 16), (10, 1, 16, 4), (5, 7, 16, 4)]
    results, err = [], {"qkv": 0.0, "o_mlp": 0.0}
    for B, Sq, Hq, Hkv in cases:
        qkv, omlp, kw = _fused_args(fdl, layers[(Hq, Hkv)], gen, B, Sq, Hq, Hkv)
        got = fdl.fused_qkv_kernel(*qkv, **kw)
        o = fdl.fused_o_mlp_kernel(*omlp, eps=1e-6)
        torch.cuda.synchronize()
        ok, e_q, quanta, share, ulps, sc_share = _qkv_err(
            got, fdl.fused_rmsnorm_qkv_plain(*qkv, **kw))
        ref = fdl.fused_o_mlp_plain(*omlp, eps=1e-6).float()
        e_o = (o.float() - ref).abs().max().item()
        ok &= e_o <= FUSED_RTOL * ref.abs().max().item() and bool(torch.isfinite(o.float()).all())
        case = {"B": B, "Sq": Sq, "N": B * Sq, "Hq": Hq, "Hkv": Hkv, "max_abs_err_q": e_q,
                "max_int8_diff": quanta, "int8_diff_share": share, "max_scale_ulps": ulps,
                "scale_diff_share": sc_share, "max_abs_err_o": e_o}
        if not ok:
            raise AssertionError(f"fused decode case {case}")
        err["qkv"], err["o_mlp"] = max(err["qkv"], e_q), max(err["o_mlp"], e_o)
        results.append(case)

    # time at N = 10 (the main path's decode call: 2 samples x (4 + gt) rows)
    # and N = 128 (the default micro_batch_size), one query each
    timed = {}
    for N in (10, 128):
        p = layers[(16, 16)]
        qkv, omlp, kw = _fused_args(fdl, p, gen, N, 1, 16, 16)
        wq = torch.cat([p[k][0].bfloat16() * p[k][1] for k in ("wq", "wk", "wv")], dim=1)
        wo, wd = (p[k][0].bfloat16() * p[k][1] for k in ("wo", "wd"))
        wgu = torch.cat([p[k][0].bfloat16() * p[k][1] for k in ("wg", "wu")], dim=1)
        xn = omlp[1].reshape(N, H)
        attn, m = omlp[0].reshape(N, -1), torch.randn(N, I, generator=gen, device="cuda").bfloat16()
        # the same products by torch.matmul over pre-dequantised bf16 weights
        # (a yardstick only: the port never calls it)
        lib = {"qkv": lambda: torch.matmul(xn, wq),
               "o_mlp": lambda: (torch.matmul(attn, wo), torch.matmul(xn, wgu),
                                 torch.matmul(m, wd))}
        work = fused_work(N, H, 16, 16, I)
        o_mlp = lambda: fdl.fused_o_mlp_kernel(*omlp, eps=1e-6)
        qkv_k = lambda: fdl.fused_qkv_kernel(*qkv, **kw)
        for name, fn in (("qkv", qkv_k), ("o/mlp", o_mlp)):
            if not repeats_bit_for_bit(fn):
                raise AssertionError(f"fused {name} at N={N}: three calls gave different bits")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        timed[N] = {
            "qkv": {"kernel_ms": graph_ms(qkv_k),
                    "per_launch": graph_kernel_ms(qkv_k, QKV_KERNELS),
                    "plan": fdl.qkv_plan(N, 16, 16, H, sms),
                    "repeats_bit_for_bit": True,
                    "eager_ms": cuda_ms(qkv_k, 100),
                    "plain_ms": graph_ms(lambda: fdl.fused_rmsnorm_qkv_plain(*qkv, **kw), 10),
                    "library_ms": graph_ms(lib["qkv"]), **bound(*work["qkv"])},
            "o_mlp": {"kernel_ms": graph_ms(o_mlp),
                      "per_launch": graph_kernel_ms(o_mlp, O_MLP_KERNELS),
                      "plan": fdl.o_mlp_plan(N, 16 * 64, H, I, sms),
                      "repeats_bit_for_bit": True,
                      "eager_ms": cuda_ms(o_mlp, 100),
                      "plain_ms": graph_ms(lambda: fdl.fused_o_mlp_plain(*omlp, eps=1e-6), 10),
                      "library_ms": graph_ms(lib["o_mlp"]), **bound(*work["o_mlp"])},
        }
    out = {"phase": "fused_decode", "H": H, "I": I, "cases": results, "max_abs_err": err,
           "tolerance": f"bf16 |d| <= {FUSED_RTOL} max|ref|; int8 within 1 quantum (2 where "
                        f"the scales differ) on <= {FUSED_INT8_SHARE} of entries; k/v scales "
                        f"within {SCALE_ULPS} bf16 ulps, <= {FUSED_INT8_SHARE} of them differ",
           "launches_per_call": {"qkv": 1, "o_mlp": fdl.O_MLP_LAUNCHES}, "timed": timed}
    emit(out)
    return out


GRPO_STEPS = 2


def _drive_grpo(mods, argv, expect_fn):
    """GRPO_STEPS steps of main_vla_rft_grpo.run(argv) at the libero preset
    with every kernel count set to 0 just before each step and read just
    after it; each step's launches must equal expect_fn(trainer), its
    metrics be finite, every trained expert leaf must move and every frozen
    leaf stay bit-identical.  Returns (trainer, step records, expected
    launches, run seconds, expert leaves, frozen leaves)."""
    import tempfile

    from vla_rft_tpu_torch.trainer import main_vla_rft_grpo

    ckpt_dir = tempfile.mkdtemp(prefix="grpo_ckpt_")
    argv = argv + [f"data.train_batch_size={N_SAMPLES}",
                   f"actor_rollout_ref.rollout.n={N_ROLLOUTS}",
                   f"trainer.total_training_steps={GRPO_STEPS}",
                   f"trainer.default_local_dir={ckpt_dir}"]
    start, steps = {}, []

    def on_start(trainer):
        b = trainer.bundle
        for name in ("vla", "wm", "tokenizer", "lpips", "expert"):
            start[name] = {k: v.detach().clone() for k, v in getattr(b, name).state_dict().items()}

    def on_step_start(step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_decode_counts(mods)  # the main path

    def on_step_end(step, metrics):
        steps.append({"step": step, "launches": _decode_counts(mods),  # read right after
                      "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                      "timing_s": {k[len("timing_s/"):]: v for k, v in metrics.items()
                                   if k.startswith("timing_s/")},
                      "metrics": {k: v for k, v in metrics.items()
                                  if not k.startswith("timing_s/")}})

    t0 = time.perf_counter()
    tr = main_vla_rft_grpo.run(argv, on_start, on_step_start, on_step_end)
    run_s = time.perf_counter() - t0
    b = tr.bundle
    expect = expect_fn(tr)
    for s in steps:
        if s["launches"] != expect:
            raise AssertionError(f"grpo step {s['step']}: launches {s['launches']}, "
                                 f"expected {expect}")
        bad = [k for k, v in s["metrics"].items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"grpo step {s['step']}: non-finite metrics {bad}")
    # the trained expert moved leaf by leaf; nothing frozen moved a bit
    still = [k for k, v in b.expert.state_dict().items() if torch.equal(v, start["expert"][k])]
    moved = [f"{m}.{k}" for m in ("vla", "wm", "tokenizer", "lpips")
             for k, v in getattr(b, m).state_dict().items() if not torch.equal(v, start[m][k])]
    if still or moved:
        raise AssertionError(f"expert leaves that did not move {still[:5]} ({len(still)}); "
                             f"frozen leaves that moved {moved[:5]} ({len(moved)})")
    n_expert = len(start["expert"])
    n_frozen = sum(len(start[m]) for m in ("vla", "wm", "tokenizer", "lpips"))
    return tr, steps, expect, run_s, n_expert, n_frozen


def _next_rollout_rows(tr, seed: int):
    """The WM rows of a next batch's rollout (outside the main path)."""
    from vla_rft_tpu_torch.models.action_head import sample_noisy_actions
    from vla_rft_tpu_torch.trainer.grpo_trainer import process_stage, wm_rows
    from vla_rft_tpu_torch.workers.flow_actor import rollout_from_hidden

    b, n = tr.bundle, N_ROLLOUTS
    with torch.no_grad():
        batch = tr.put_batch(tr.dataset.next_batch())
        gen = torch.Generator(device="cuda").manual_seed(seed)
        hidden = tr.encode(batch).repeat_interleave(n, 0)
        noise = sample_noisy_actions(gen, batch["actions"].repeat_interleave(n, 0), b.expert_cfg)
        acts = rollout_from_hidden(b.expert, gen, hidden, noise["noise"],
                                   batch["proprio"].repeat_interleave(n, 0),
                                   b.expert_cfg.num_flow_steps)["predicted_actions"]
        wm_inputs = process_stage(b, tr.action_ranges, batch["raw_pixel_values"], acts,
                                  batch["actions"], n, True)
        return wm_rows(b, wm_inputs, n, True, True), gen


def phase_grpo(mods) -> dict:
    """Two GRPO steps at the libero preset through the CLI entry point, with
    the int8-weight WM (fused decode layers #8 / #9)."""
    from vla_rft_tpu_torch.models.transformer import decode_step_fused

    fdl = mods[3]

    def expect_fn(tr):
        # #1: the Qwen context forward and the WM's shared-prefix prefill; #4:
        # the prompt tails' prefill (7 tokens, unfused) and every fused call
        b = tr.bundle
        L, roll = b.wm_cfg.num_layers, b.roll_cfg
        fused_calls = roll.num_frames * (roll.interact_max_tokens + 1)
        return _expect(flash_fwd=b.vla_cfg.llm.num_layers + L,
                       decode_shared_hd=L * (fused_calls + 1), fused_qkv=L * fused_calls,
                       fused_o_mlp=fdl.O_MLP_LAUNCHES * L * fused_calls)

    tr, steps, expect, run_s, n_expert, n_frozen = _drive_grpo(
        mods, ["world_model_rollout.rollout.weights_int8=true"], expect_fn)
    b, roll = tr.bundle, tr.bundle.roll_cfg
    fused_calls = roll.num_frames * (roll.interact_max_tokens + 1)

    # the decode calls of a next batch's rollout rows (outside the main path):
    # a profiler window of the fused route, and frame 0 of the fused route
    # against the unfused int8 route on the same prompts and tokens
    wm_q = tr._wm_gen_model()
    rows, gen = _next_rollout_rows(tr, 21)
    trace = profile_decode_steps(wm_q, roll, rows, fused=True)
    tails, actions, pm, _ = _policy_rows(rows)
    with torch.no_grad():
        fused_call = lambda ids, cache, ci, kw, last: decode_step_fused(
            wm_q, ids, cache, ci, logits_last_only=last, **kw)[0]
        module_call = lambda ids, cache, ci, kw, last: wm_q(
            ids, cache=cache, cache_index=ci, logits_last_only=last, **kw)[0]
        V = roll.interact_max_tokens
        toks = torch.randint(0, 4375, (tails.shape[0], V), generator=gen, device="cuda")
        k = _frame0_logits(wm_q, roll, rows.prefixes, tails, actions, pm, toks, fused_call)
        p = _frame0_logits(wm_q, roll, rows.prefixes, tails, actions, pm, toks, module_call)
    per_call, errs = _rel_logit_err(k, p)
    if not (errs["max_rel_logit_err"] <= WM_LOGIT_TOL and bool(torch.isfinite(k).all())):
        raise AssertionError(f"fused vs unfused int8 route: {errs} > {WM_LOGIT_TOL}")
    out = {"phase": "grpo", "preset": "libero", "samples": N_SAMPLES, "n": N_ROLLOUTS,
           "weights_int8": True, "wm_rows_per_call": N_SAMPLES * (N_ROLLOUTS + 1),
           "run_s": run_s, "steps": steps, "expected_launches_per_step": expect,
           "fused_decode_calls_per_step": fused_calls, "expert_leaves_moved": n_expert,
           "frozen_leaves_bit_identical": n_frozen, "fused_decode_trace": trace,
           "fused_vs_unfused_frame0": {"calls": len(per_call), "rows": int(tails.shape[0]),
                                       **errs, "tolerance": WM_LOGIT_TOL}}
    emit(out)
    del tr, wm_q
    return out


def phase_grpo_heads(mods) -> dict:
    """Two GRPO steps at the libero preset with the WM's KV cache in the
    'heads' layout (every other setting the default: a bf16 WM, int8 KV
    cache), so every WM decode call runs kernel #6; then a profiler window
    of 16 decode calls and the 'heads' route against the 'hd' route on the
    same weights and frame 0's tokens."""
    from vla_rft_tpu_torch.models.transformer import Decoder

    def expect_fn(tr):
        # #1: the Qwen context forward and the WM's shared-prefix prefill; #6:
        # the prompt tails' prefill (7 tokens) and every decode call
        b = tr.bundle
        L, roll = b.wm_cfg.num_layers, b.roll_cfg
        calls = 1 + roll.num_frames * (roll.interact_max_tokens + 1)
        return _expect(flash_fwd=b.vla_cfg.llm.num_layers + L, decode_shared_heads=L * calls)

    tr, steps, expect, run_s, n_expert, n_frozen = _drive_grpo(
        mods, ["world_model_rollout.rollout.kv_layout=heads"], expect_fn)
    b, roll = tr.bundle, tr.bundle.roll_cfg
    if b.wm.cfg.kv_layout != "heads" or tr._wm_gen_model() is not b.wm:
        raise AssertionError(f"the step's WM runs {b.wm.cfg.kv_layout!r}")
    rows, gen = _next_rollout_rows(tr, 22)
    trace = profile_decode_steps(b.wm, roll, rows)  # outside the main path
    tails, actions, pm, _ = _policy_rows(rows)
    with torch.device("cuda"):
        wm_hd = Decoder(dataclasses.replace(b.wm.cfg, kv_layout="hd"))
    wm_hd.load_state_dict(b.wm.state_dict(), strict=True)
    wm_hd.eval().requires_grad_(False)
    toks = torch.randint(0, 4375, (tails.shape[0], roll.interact_max_tokens), generator=gen,
                         device="cuda")
    logits = {}
    with torch.no_grad():
        for name, wmod in (("heads", b.wm), ("hd", wm_hd)):
            call = lambda ids, cache, ci, kw, last, m=wmod: m(
                ids, cache=cache, cache_index=ci, logits_last_only=last, **kw)[0]
            logits[name] = _frame0_logits(wmod, roll, rows.prefixes, tails, actions, pm, toks,
                                          call)
    per_call, errs = _rel_logit_err(logits["heads"], logits["hd"])
    if not (errs["max_rel_logit_err"] <= WM_LOGIT_TOL
            and bool(torch.isfinite(logits["heads"]).all())):
        raise AssertionError(f"heads vs hd route: {errs} > {WM_LOGIT_TOL}")
    out = {"phase": "grpo_heads", "preset": "libero", "samples": N_SAMPLES, "n": N_ROLLOUTS,
           "kv_layout": "heads", "weights_int8": False,
           "wm_rows_per_call": N_SAMPLES * (N_ROLLOUTS + 1), "run_s": run_s, "steps": steps,
           "expected_launches_per_step": expect, "expert_leaves_moved": n_expert,
           "frozen_leaves_bit_identical": n_frozen, "decode_step_trace": trace,
           "heads_vs_hd_frame0": {"calls": len(per_call), "rows": int(tails.shape[0]), **errs,
                                  "bit_equal": bool(torch.equal(logits["heads"], logits["hd"])),
                                  "tolerance": WM_LOGIT_TOL}}
    emit(out)
    del tr, wm_hd
    return out


def fda_work(B, Hq, Hkv, D, idx, kv_starts, elem: int):
    """(bytes, flops) of one #10 call: q and the new K/V rows read, the rows
    written, the valid history [kv_starts[b], idx) of each (row, kv head)
    read once for K and V, O written; 4*D flops per (query head, key),
    the current token included."""
    keys = int(torch.clamp(idx - kv_starts, min=0).sum()) * Hkv  # history rows x kv heads
    io = 2 * (B * Hq * D * elem) + 2 * 2 * B * Hkv * D * elem + 2 * keys * D * elem
    return io, 4 * D * (keys // Hkv + B) * Hq


def phase_fused_decode_attention(fda, heads) -> dict:
    """Kernel #10 against its twin on bf16 and f32 caches and q, in all four
    pairings: the written rows bit-equal, three calls the same bits (the
    ranks are merged in rank order), the output within the decode tolerance
    (1e-5 when cache and q are both f32); #7 over the cache #10 wrote agrees
    with it; then timed at the WM's width, at the configured 128 rows of a
    WM call and at Qwen2.5-0.5B's head layout (GQA 14/2), each with the
    wrapper's split plan."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    L, S, li = 2, 1664, 1
    bf, f32 = torch.bfloat16, torch.float32
    s10 = [0, 7, 1379, 1500, 0, 3, 1378, 0, 100, 0]
    cases = [
        # (cache dtype, q dtype, B, Hq, Hkv, D, idx, kv_starts, splits or None
        # for the plan): rows 0, 1, mid-window, the last; starts at or past
        # the row (only the current token); GQA 14/2; ranks without a tile
        # (8 ranks at rows 1, 100 and 129, starts at or past the row); the
        # mixed pairings; D 32 and 128 with 16 query heads a kv head; the
        # configured 128 rows
        (bf, bf, 10, 16, 16, 64, 0, [0] * 10, None),
        (bf, bf, 10, 16, 16, 64, 1, [0, 1] * 5, None),
        (bf, bf, 10, 16, 16, 64, 1379, s10, None),
        (bf, bf, 10, 16, 16, 64, S - 1, [0, S - 1, 5, 0, 9, 0, 0, 1, 2, 3], None),
        (f32, f32, 10, 16, 16, 64, 1379, s10, None),
        (f32, f32, 10, 16, 16, 64, S - 1, [0] * 10, None),
        (bf, bf, 10, 14, 2, 64, 700, [0, 0, 13, 699, 700, 0, 0, 5, 0, 0], None),
        (f32, f32, 10, 14, 2, 64, 0, [0] * 10, None),
        (bf, bf, 10, 16, 16, 64, 1, [0, 1, 2, 0, 0, 0, 1, 0, 0, 0], 8),
        (bf, bf, 10, 16, 16, 64, 100, [0, 99, 100, 150, 0, 50, 0, 0, 0, 7], 8),
        (bf, bf, 10, 16, 16, 64, 129, [0, 1, 128, 129, 200, 0, 0, 0, 64, 0], 8),
        (f32, f32, 4, 4, 2, 128, 129, [0, 129, 1, 100], 8),
        (bf, f32, 10, 16, 16, 64, 1379, s10, None),
        (f32, bf, 10, 16, 16, 64, 1379, s10, None),
        (bf, bf, 4, 32, 2, 32, 900, [0, 5, 899, 0], None),
        (bf, bf, 4, 32, 2, 128, 900, [0, 5, 899, 0], None),
        (f32, f32, 4, 32, 2, 128, 900, [0, 5, 899, 0], None),
        (bf, bf, 128, 16, 16, 64, 1379, [(37 * i) % 1500 for i in range(128)], None),
    ]
    results, err = [], 0.0
    fda.launches = 0  # no main path launches #10: its count is this loop's
    for cdt, qdt, B, Hq, Hkv, D, idx, starts, splits in cases:
        rnd = lambda dt, *sh: torch.randn(*sh, generator=gen, device=dev).to(dt)
        ck, cv = rnd(cdt, L, B, Hkv, S, D), rnd(cdt, L, B, Hkv, S, D)
        q, kn, vn = rnd(qdt, B, 1, Hq, D), rnd(cdt, B, 1, Hkv, D), rnd(cdt, B, 1, Hkv, D)
        ks = torch.tensor(starts, dtype=torch.int32, device=dev)
        rck, rcv = ck.clone(), cv.clone()
        outs = [fda.fused_decode_attention_kernel(q, kn, vn, ck, cv, li, idx, ks,
                                                  splits=splits)[0] for _ in range(3)]
        torch.cuda.synchronize()
        o = outs[0]
        ref = fda.fused_decode_attention_plain(q, kn, vn, rck, rcv, li, idx, ks)[0].float()
        d = (o.float() - ref).abs()
        both_f32 = cdt == f32 and qdt == f32
        rtol, atol = (1e-5, 1e-5) if both_f32 else (DEC_RTOL, DEC_ATOL)
        rows_equal = torch.equal(ck, rck) and torch.equal(cv, rcv)
        repeats = all(torch.equal(o, x) for x in outs[1:])
        name = (f"cache {cdt} q {qdt} B {B} {Hq}/{Hkv} x {D} idx {idx} "
                f"splits {splits or 'plan'}")
        if not (rows_equal and repeats and bool(torch.isfinite(o.float()).all())
                and bool((d <= rtol * ref.abs() + atol).all())):
            raise AssertionError(f"fused_decode_attention case {name}: max|dO| "
                                 f"{d.max().item()}, rows equal {rows_equal}, "
                                 f"repeats {repeats}")
        entry = {"cache": str(cdt).split(".")[-1], "q": str(qdt).split(".")[-1], "B": B,
                 "Hq": Hq, "Hkv": Hkv, "D": D, "cache_index": idx, "kv_starts": starts[:10],
                 "splits": splits or fda.split_plan(B, Hq, Hkv, D, idx, cdt,
                                                    fda._device_sms(dev))["splits"],
                 "max_abs_err": d.max().item(), "written_rows_bit_equal": rows_equal,
                 "three_calls_bit_equal": repeats}
        if cdt == bf and qdt == bf and Hq == Hkv and D == 64:  # #7 over the cache #10 wrote
            o7 = heads.decode_kernel(q, ck[li], cv[li], kv_lens=torch.full_like(ks, idx + 1),
                                     q_offset=torch.full_like(ks, idx),
                                     kv_starts=torch.clamp(ks, max=idx))
            d7 = (o7.float() - o.float()).abs()
            if not bool((d7 <= DEC_RTOL * o.float().abs() + DEC_ATOL).all()):
                raise AssertionError(f"#7 over #10's cache, {name}: {d7.max().item()}")
            entry["max_abs_diff_vs_decode_heads"] = d7.max().item()
        err = max(err, d.max().item())
        results.append(entry)
        del ck, cv, rck, rcv
    launches = fda.launches

    # timed, bf16 cache, D 64, S 1664, the plain route's mid-rollout position
    # (1095 + 4 * 71 = 1379 cached rows), kv_starts 0: (a) the WM's 10 rows,
    # (b) the configured 128 rows of a WM call, (c) Qwen2.5-0.5B's 14/2 heads
    timed = {}
    idx = 1379
    for key, B, Hq, Hkv in (("wm", 10, 16, 16), ("b128", 128, 16, 16), ("gqa14_2", 10, 14, 2)):
        ck, cv = (torch.randn(L, B, Hkv, S, 64, generator=gen, device=dev).bfloat16()
                  for _ in range(2))
        q = torch.randn(B, 1, Hq, 64, generator=gen, device=dev).bfloat16()
        kn, vn = (torch.randn(B, 1, Hkv, 64, generator=gen, device=dev).bfloat16()
                  for _ in range(2))
        ks = torch.zeros(B, dtype=torch.int32, device=dev)
        kern = lambda: fda.fused_decode_attention_kernel(q, kn, vn, ck, cv, li, idx, ks)
        twin = lambda: fda.fused_decode_attention_plain(q, kn, vn, ck, cv, li, idx, ks)
        o, ref = kern()[0].float(), twin()[0].float()
        if not bool(((o - ref).abs() <= DEC_RTOL * ref.abs() + DEC_ATOL).all()):
            raise AssertionError(f"fused_decode_attention timed shape {key}: "
                                 f"{(o - ref).abs().max().item()}")
        if not repeats_bit_for_bit(lambda: kern()[0]):
            raise AssertionError(f"fused_decode_attention timed shape {key}: calls differ")
        # SDPA over the written cache's valid rows (a yardstick that skips the
        # write; the port never calls it)
        qt, kt, vt = q.transpose(1, 2), ck[li, :, :, :idx + 1], cv[li, :, :, :idx + 1]
        nbytes, flops = fda_work(B, Hq, Hkv, 64, idx, ks, 2)
        timed[key] = {
            "B": B, "Hq": Hq, "Hkv": Hkv, "D": 64, "S": S, "cache_index": idx, "dtype": "bf16",
            "plan": fda.split_plan(B, Hq, Hkv, 64, idx, torch.bfloat16, fda._device_sms(dev)),
            "kernel_ms": graph_ms(kern), "eager_ms": cuda_ms(kern, 100),
            "plain_ms": graph_ms(twin, 10 if B <= 10 else 3),
            "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, enable_gqa=Hq != Hkv)),
            "max_abs_err": (o - ref).abs().max().item(), "three_calls_bit_equal": True,
            **bound(nbytes, flops)}
        del ck, cv, qt, kt, vt
        torch.cuda.empty_cache()
    out = {"phase": "fused_decode_attention", "cases": results, "launches": launches,
           "max_abs_err": err,
           "tolerance": f"|dO| <= {DEC_RTOL} * |O| + {DEC_ATOL} (bf16 cache or q), "
                        f"1e-5 * |O| + 1e-5 (both f32); written rows and three calls "
                        f"bit-equal", "timed": timed}
    emit(out)
    return out


def _zero_counts(attention) -> None:
    attention.launches = attention.bwd_dq_launches = attention.bwd_dkv_launches = 0


def _counts(attention) -> dict:
    return {"flash_fwd": attention.launches, "flash_bwd_dq": attention.bwd_dq_launches,
            "flash_bwd_dkv": attention.bwd_dkv_launches}


def _drive_sft(attention, argv):
    """main_sft.run(argv) on the card with every kernel count set to 0 just
    before each step and read just after it.  Returns (run, per-step
    records, a clone of every parameter taken before the first step, the
    ids of the parameters whose gradient was exactly zero in every step,
    peak memory in GiB)."""
    from vla_rft_tpu_torch.trainer import main_sft

    steps, start, grads, nonzero = [], {}, [], {}

    def on_start(trainer):
        start.update({id(p): p.detach().clone() for p in trainer.params})
        backward = trainer.backward

        def keep_grads(loss):  # the step's gradients, read in on_step after its time
            grads[:] = zip(trainer.params, backward(loss))
            return [g for _, g in grads]

        trainer.backward = keep_grads
        torch.cuda.synchronize()
        _zero_counts(attention)  # the main path starts here

    def on_step(step, loss, seconds):
        steps.append({"step": step, "loss": loss, "ms": seconds * 1e3,
                      "launches": _counts(attention)})  # read right after the step
        flags = torch.stack([g.ne(0).any() for _, g in grads]).tolist()
        for (p, _), f in zip(grads, flags):
            nonzero[id(p)] = nonzero.get(id(p), False) or f
        grads.clear()
        _zero_counts(attention)

    torch.cuda.reset_peak_memory_stats()
    run = main_sft.run(argv, on_start=on_start, on_step=on_step)
    del run.trainer.backward  # the class's own again
    zero_grad = {i for i, f in nonzero.items() if not f}
    return run, steps, start, zero_grad, torch.cuda.max_memory_allocated() / 2 ** 30


def _expect_launches(what, steps, expect):
    for s in steps:
        if s["launches"] != expect or not np.isfinite(s["loss"]):
            raise AssertionError(f"{what} step {s['step']}: loss {s['loss']}, launches "
                                 f"{s['launches']}, expected {expect}")


def phase_sft(attention) -> dict:
    """The SFT path at libero width: vla_adapter, kernel vs plain, vla_flow,
    and next-token SFT of the WM."""
    from vla_rft_tpu_torch.config import vla_rft_default_config
    from vla_rft_tpu_torch.data.synthetic import SyntheticVLADataset
    from vla_rft_tpu_torch.models.action_head import sample_noisy_actions
    from vla_rft_tpu_torch.models.transformer import TransformerConfig
    from vla_rft_tpu_torch.trainer import main_sft
    from vla_rft_tpu_torch.trainer.sft_trainer import SFTTrainer

    # (a) vla_adapter through the CLI entry point
    argv = ["sft.mode=vla_adapter", f"trainer.total_training_steps={SFT_STEPS}",
            "sft.freeze_vision_backbone=true", f"sft.vlm_lr={SFT_VLM_LR}",
            f"actor_rollout_ref.actor.optim.lr={SFT_EXPERT_LR}"]
    run, steps, start, zero_grad, peak = _drive_sft(attention, argv)
    tr, bundle = run.trainer, run.bundle
    L = bundle.vla_cfg.llm.num_layers
    _expect_launches("vla_adapter", steps, {"flash_fwd": L, "flash_bwd_dq": L,
                                            "flash_bwd_dkv": L})
    names = {id(p): f"{pre}.{n}" for pre, m in (("vla", bundle.vla), ("expert", bundle.expert))
             for n, p in m.named_parameters()}
    still, moved_frozen, no_grad = [], [], []
    for p in tr.params:
        same = torch.equal(p.detach(), start[id(p)])
        frozen = tr.labels[names[id(p)]] == "frozen"
        if frozen and not same:
            moved_frozen.append(names[id(p)])
        # a trained leaf whose gradient was exactly zero in every step (the BC
        # loss does not reach the sigma net) is moved only by weight decay
        # (1e-4 x lr 1e-4), below f32 resolution, as in the reference
        if not frozen and same:
            (no_grad if id(p) in zero_grad else still).append(names[id(p)])
    print(f"[sft] vla_adapter: {len(no_grad)} trained leaves with an exactly zero gradient in "
          f"every step, not required to move: {no_grad}", flush=True)
    if still or moved_frozen:
        raise AssertionError(f"trained leaves that did not move {still[:5]} ({len(still)}); "
                             f"frozen leaves that moved {moved_frozen[:5]}")
    n_frozen = sum(1 for v in tr.labels.values() if v == "frozen")
    del start

    # the step's parts on one more batch (outside the main path)
    config = vla_rft_default_config().apply_overrides(argv)
    data = SyntheticVLADataset(main_sft.dataset_config(config, "libero", bundle))
    data.load_state_dict({"step": SFT_STEPS})
    gen = torch.Generator(device="cuda").manual_seed(17)
    batch, data_ms = host_ms(lambda: main_sft.policy_batch(data.next_batch(), "cuda"))
    noise = sample_noisy_actions(gen, batch["actions"], bundle.expert_cfg)
    loss, fwd_ms = host_ms(lambda: tr.compute_loss(batch, noise))
    grads, bwd_ms = host_ms(lambda: tr.backward(loss))
    _, opt_ms = host_ms(lambda: tr.update(grads))
    del grads

    # (d) kernel path vs plain path on one step: same params, batch and noise
    lm = bundle.vla.language_model
    watch = [f"vla.language_model.layers.{i}.self_attn.{w}_proj.weight"
             for i in (0, L - 1) for w in "qkv"] + [f"vla.projector.fc{i}.weight" for i in (1, 2, 3)]
    idx = {names[id(p)]: i for i, p in enumerate(tr.params)}
    paths = {}
    for impl in ("auto", "plain"):
        lm.attn_impl = impl
        try:
            before = _counts(attention)
            loss = tr.compute_loss(batch, noise)
            grads = tr.backward(loss)
            torch.cuda.synchronize()
            n = {k: v - before[k] for k, v in _counts(attention).items()}
            paths[impl] = (loss.item(), {w: grads[idx[w]].float() for w in watch}, n)
            del grads
        finally:
            lm.attn_impl = "auto"
    (lk, gk, nk), (lp, gp, np_) = paths["auto"], paths["plain"]
    if nk != {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L} or any(np_.values()):
        raise AssertionError(f"kernel vs plain: launches {nk} / {np_}")
    loss_err = abs(lk - lp) / abs(lp)
    grad_err = {w: ((gk[w] - gp[w]).abs().max() / gp[w].abs().max()).item() for w in watch}
    zero = [w for w in watch if gk[w].abs().max().item() == 0.0]
    if zero or loss_err > SFT_LOSS_TOL or max(grad_err.values()) > SFT_GRAD_TOL:
        raise AssertionError(f"sft kernel vs plain: loss rel err {loss_err}, grad rel err "
                             f"{grad_err}, zero kernel-path grads {zero}")
    adapter = {"preset": "libero", "batch": config.data.train_batch_size,
               "seq_len": int(batch["input_ids"].shape[1]) + bundle.vla_cfg.total_patches,
               "steps": steps, "first_step_ms": steps[0]["ms"],
               "steady_step_ms": float(np.mean([s["ms"] for s in steps[1:]])),
               "launches_total": {k: sum(s["launches"][k] for s in steps) for k in steps[0]["launches"]},
               "split_ms": {"data": data_ms, "forward": fwd_ms, "backward": bwd_ms,
                            "optimizer": opt_ms},
               "peak_mem_gib": peak, "trained_leaves": len(tr.params) - n_frozen,
               "zero_grad_leaves": no_grad,
               "frozen_leaves": n_frozen, "lr": {"vlm": SFT_VLM_LR, "expert": SFT_EXPERT_LR},
               "kernel_vs_plain": {"loss": [lk, lp], "loss_rel_err": loss_err,
                                   "grad_rel_err": grad_err,
                                   "tolerance": {"loss_rel": SFT_LOSS_TOL,
                                                 "grad_rel": SFT_GRAD_TOL}}}
    del run, tr, bundle, lm, paths, gk, gp, batch, noise, loss
    torch.cuda.empty_cache()

    # (b) vla_flow: the VLM frozen, its context encoded without gradients
    run, steps, start, _, peak = _drive_sft(attention, ["sft.mode=vla_flow",
                                                        "trainer.total_training_steps=2"])
    L = run.bundle.vla_cfg.llm.num_layers
    _expect_launches("vla_flow", steps, {"flash_fwd": L, "flash_bwd_dq": 0, "flash_bwd_dkv": 0})
    flow = {"steps": steps, "peak_mem_gib": peak}
    del run, start
    torch.cuda.empty_cache()

    # (c) next-token SFT of the 24-layer WM over 4 rows of 1663 tokens, the
    # labels -100 over the 1095-token prompt
    torch.cuda.reset_peak_memory_stats()
    cfg = TransformerConfig.wm_llama(vocab_size=9008)
    wm_tr, build_ms = host_ms(lambda: SFTTrainer(cfg, lr=1e-5, device="cuda", seed=13))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (WM_SFT_ROWS, WM_SFT_LEN)).astype(np.int32)
    labels = ids.copy()
    labels[:, :WM_SFT_PROMPT] = -100
    wm_batch = {"input_ids": ids, "labels": labels,
                "attention_mask": np.ones_like(ids)}
    wm_steps = []
    for step in (1, 2):
        _zero_counts(attention)  # the main path starts here
        loss, ms = host_ms(lambda: wm_tr.training_step(wm_batch))
        wm_steps.append({"step": step, "loss": loss, "ms": ms, "launches": _counts(attention)})
    L = wm_tr.llm.cfg.num_layers
    _expect_launches("wm_sft", wm_steps, {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L})
    wm = {"rows": WM_SFT_ROWS, "seq_len": WM_SFT_LEN, "build_ms": build_ms, "steps": wm_steps,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del wm_tr
    torch.cuda.empty_cache()
    out = {"phase": "sft", "vla_adapter": adapter, "vla_flow": flow, "wm_sft": wm}
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vla_rft_tpu_torch.ops import attention
    from vla_rft_tpu_torch.ops import decode_attention as heads
    from vla_rft_tpu_torch.ops import decode_attention_hd as dec
    from vla_rft_tpu_torch.ops import fused_decode_attention as fda
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    # float32 references stay float32 (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    seconds, held = {}, {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        gc.collect()  # a phase's models can sit in reference cycles
        held[name] = torch.cuda.memory_allocated() / 2 ** 30  # what the phase leaves allocated
        return out

    mods = (attention, dec, heads, fdl)  # the kernels a WM call can launch
    timed("build", phase_build)
    flash = timed("flash", phase_flash, attention)
    flash_bwd = timed("flash_bwd", phase_flash_bwd, attention)
    decode = timed("decode", phase_decode, dec)
    decode_heads = timed("decode_heads", phase_decode, heads, True)
    fused_attn = timed("fused_decode_attention", phase_fused_decode_attention, fda, heads)
    fused = timed("fused_decode", phase_fused_decode, fdl)
    serving = timed("serving", phase_serving, attention)
    wm = timed("wm_reward", phase_wm_reward, mods)
    plain = timed("wm_plain", phase_wm_plain, mods, wm)
    wm["plain_tokens"] = plain["tokens"]
    plain_heads = timed("wm_plain_heads", phase_wm_plain, mods, wm, True)
    timed("wm_kernel_vs_plain", phase_wm_kernel_vs_plain, wm)
    wm_launches = wm["json"]["runs"][0]["launches"]
    del wm  # frees the WM reward models before the training phases
    torch.cuda.empty_cache()
    grpo = timed("grpo", phase_grpo, mods)
    torch.cuda.empty_cache()
    grpo_heads = timed("grpo_heads", phase_grpo_heads, mods)
    torch.cuda.empty_cache()
    sft = timed("sft", phase_sft, attention)
    emit({"phase_seconds": seconds, "total_seconds": round(time.perf_counter() - t0, 1),
          "allocated_gib_after_phase": held})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    entry = lambda name, source, replaces, launches, err, t: {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
    flash_src = "vla_rft_tpu_torch/csrc/flash_fwd.cu"
    bwd_src = "vla_rft_tpu_torch/csrc/flash_bwd.cu"
    adapter_n, wm_n = sft["vla_adapter"]["launches_total"], sft["wm_sft"]["steps"][0]["launches"]
    bwd_entries = []
    for kernel, line, key in (("flash_bwd_dq", 175, "dq"), ("flash_bwd_dkv", 239, "dkv")):
        for shape, n, desc in (("vla_adapter", adapter_n,
                                f"B=16 S=352 (351 valid) Hq/Hkv=14/2 D=64 causal; "
                                f"{SFT_STEPS} steps"),
                               ("wm_sft", wm_n, "B=4 S=1663 Hq=Hkv=16 D=64 causal; 1 step")):
            bwd_entries.append({**entry(f"{kernel}@{shape}", bwd_src,
                                        f"vla_rft_tpu/ops/attention.py:{line}", n[kernel],
                                        flash_bwd["max_abs_err"][key],
                                        flash_bwd["timed"][shape][key]), "shape": desc})
    dec_src = "vla_rft_tpu_torch/csrc/decode_hd.cu"
    heads_src = "vla_rft_tpu_torch/csrc/decode_heads.cu"
    heads_n = {k: sum(s["launches"][k] for s in grpo_heads["steps"])
               for k in grpo_heads["steps"][0]["launches"]}
    fused_src = "vla_rft_tpu_torch/csrc/fused_decode_layer.cu"
    grpo_n = {k: sum(s["launches"][k] for s in grpo["steps"]) for k in grpo["steps"][0]["launches"]}
    fused_entries = []
    for kernel, key, line in (("fused_rmsnorm_qkv", "qkv", 117), ("fused_o_mlp", "o_mlp", 162)):
        for N in (10, 128):
            fused_entries.append({
                **entry(kernel if N == 10 else f"{kernel}@n128", fused_src,
                        f"vla_rft_tpu/ops/fused_decode_layer.py:{line}",
                        grpo_n[f"fused_{key}"], fused["max_abs_err"][key], fused["timed"][N][key]),
                "shape": f"N={N} (B={N}, Sq=1) H=1024 Hq=Hkv=16 D=64 I=4096; launches: the "
                         f"kernel's over {GRPO_STEPS} grpo steps, all at N=10 (B=10, Sq=1)"
                         + (f", {fdl.O_MLP_LAUNCHES} per call" if key == "o_mlp" else ""),
                "launches_at_this_shape": grpo_n[f"fused_{key}"] if N == 10 else 0})
    fda_src = "vla_rft_tpu_torch/csrc/fused_decode_attention.cu"
    fda_entries = [
        {**entry(name, fda_src, "vla_rft_tpu/ops/fused_decode_attention.py:31",
                 fused_attn["launches"], fused_attn["max_abs_err"], fused_attn["timed"][key]),
         "shape": f"B={t['B']} Hq={t['Hq']} Hkv={t['Hkv']} D=64 S=1664 bf16, row 1379, "
                  f"{t['plan']['splits']} split(s); no main path launches it (the reference "
                  f"calls it only from its tests): launches are its own phase's"}
        for name, key in (("fused_decode_attention", "wm"),
                          ("fused_decode_attention@b128", "b128"),
                          ("fused_decode_attention@gqa14_2", "gqa14_2"))
        for t in (fused_attn["timed"][key],)]
    emit({"kernels": [
        entry("flash_fwd", flash_src, "vla_rft_tpu/ops/attention.py:108",
              serving["main_path_launches"], flash["max_abs_err_o"], flash["timed"]["serving"]),
        {**entry("flash_fwd@wm_prefill", flash_src, "vla_rft_tpu/ops/attention.py:108",
                 wm_launches["flash_fwd"], flash["max_abs_err_o"], flash["timed"]["wm_prefill"]),
         "shape": "B=2 Sq=1088 Sk=1152 Hq=Hkv=16 D=64 causal"},
        entry("decode_shared_hd", dec_src, "vla_rft_tpu/ops/decode_attention_hd.py:226",
              wm_launches["decode_shared_hd"], decode["max_abs_err"]["shared"],
              decode["timed"]["shared"]),
        {**entry("decode_shared_hd@b128", dec_src, "vla_rft_tpu/ops/decode_attention_hd.py:226",
                 0, decode["max_abs_err"]["shared"], decode["timed"]["shared_b128"]),
         "shape": f"B=128 Sq=1 Hq=Hkv=16 D=64 int8, 16 prefixes of {WM_PREFIX} (8 rows each) "
                  f"+ 291 own: the configured rows of a WM call; the main path runs B=10"},
        entry("decode_hd", dec_src, "vla_rft_tpu/ops/decode_attention_hd.py:272",
              plain["launches"]["decode_hd"], decode["max_abs_err"]["plain"],
              decode["timed"]["plain"]),
        *bwd_entries,
        *fused_entries,
        {**entry("decode_shared_heads", heads_src, "vla_rft_tpu/ops/decode_attention.py:183",
                 heads_n["decode_shared_heads"], decode_heads["max_abs_err"]["shared"],
                 decode_heads["timed"]["shared"]),
         "shape": f"B=10 Sq=1 Hq=Hkv=16 D=64 int8, 2 prefixes of {WM_PREFIX} + 291 own; "
                  f"launches: {GRPO_STEPS} grpo_heads steps"},
        {**entry("decode_heads", heads_src, "vla_rft_tpu/ops/decode_attention.py:36",
                 plain_heads["launches"]["decode_heads"], decode_heads["max_abs_err"]["plain"],
                 decode_heads["timed"]["plain"]),
         "shape": "B=10 Sq=1 Hq=Hkv=16 D=64 int8, 1379 keys; launches: wm_plain_heads "
                  "(2 rows, 2 frames)"},
        *fda_entries,
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
