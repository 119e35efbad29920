"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one JSON line each:
  1. build      - nvcc builds the kernel libraries from the sources in this
                  checkout (vla_rft_tpu_torch/csrc/flash_fwd.cu, flash_bwd.cu,
                  decode_hd.cu, decode_heads.cu, fused_decode_layer.cu and
                  fused_decode_attention.cu), one nvcc per source, and g++ the
                  data path's host libraries (tfrecord_reader.cc and
                  image_ops.cc, the resize and crop), all started together;
  2. flash      - the flash kernel (#1) against its plain PyTorch twin on the
                  card over masked, padded and ragged cases and the WM's
                  1088-token prefill; three calls at each timed shape give
                  the same bits; its time at the serving, the WM prefill
                  the wm_logprob forward (8 x 1663) and the text-SFT layer
                  (4 right-padded rows of 1663 valid 1663 / 1211 / 742 /
                  205, 14/2 heads) shapes beside the twin's,
                  scaled_dot_product_attention's (a yardstick only: the port
                  never calls it; causal with enable_gqa, right-padded rows
                  whole, since a valid query never reaches a padding key)
                  and the bound;
  3. flash_bwd  - the flash backward kernels (#2 dQ, #3 dK/dV) against their
                  plain twin over the flash phase's masked, padded, ragged,
                  fully-masked-row and q_offset cases, D = 128 and the WM's
                  1663-token rows and the text-SFT layer (4 ragged rows of
                  1663, 14/2), causal and not; their time at the
                  VLA-adapter shape (B 16 x 352, 14/2 heads), the WM-SFT
                  shape (B 4 x 1663, 16/16 heads) and the text-SFT shape
                  beside the twin's, the
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
                  shape (#4 also at 128 rows and at the speculative verify
                  call: 10 rows of Sq 5 at 10 offsets) with the launch plan, each
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
     eval       - the eval harnesses on libero-width policies (seeded random
                  weights): eval/main_eval.py's LIBERO CLI at its defaults
                  (2 views, center crop) on ScriptedEnv must report
                  success_rate 1.0 from the derived 2 queries; the ALOHA
                  harness (2 rollouts x 8 steps, a stand-in rig of 480 x
                  640 cameras and 14 dof) queries a 3-view policy behind
                  ActionServer, one query per 8 steps, every command
                  received; the Bridge harness over WidowXGym and a
                  stand-in client queries a 1-view policy in process once a
                  step for 5 steps, row 0 of each chunk executed; every
                  query launches #1 once per Qwen layer (24), every chunk
                  (8, 7) and finite; the kernel path agrees with the plain
                  path at 2 and 3 views; #1 timed at the 2- and 3-view
                  request shapes (1 x 608, 1 x 864); query ms and one
                  profiled predict_action (wall, device-busy, idle share)
                  at 1 / 2 / 3 views; the peak memory;
  7. wm_reward  - the world-model reward path at libero width (24-layer bf16
                  WM with an int8 KV cache, the 256 px tokenizer, VGG16
                  LPIPS; seeded random weights) on 2 samples with n = 4
                  rollouts, through the GRPO trainer's own stage functions
                  (process_stage -> wm_rows / wm_rollout_stage: one
                  shared-prefix rollout of 8 frames over 10 rows, each
                  sample's 4 rollouts then its gt-action row ->
                  reward_stage), launching #1 exactly 24 times and #4
                  exactly 24 x 521 times;
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
                  world_model_rollout.rollout.weights_int8=true, one step
                  (no lr warm-up) of 2 samples x n = 4 (one WM call of 10
                  rows), every other setting the config default: the stage times, the
                  peak memory and exact launches (#1 24 + 24, #4 24 x 521,
                  #8 24 x 520, #9 3 x 24 x 520, every other kernel 0); every
                  trained expert leaf moved, every VLM / WM / tokenizer /
                  LPIPS leaf bit-identical, metrics finite; a torch.profiler
                  window of 16 fused decode calls; the fused route against
                  the unfused int8 route on frame 0's calls;
     grpo_heads - the same with world_model_rollout.rollout.kv_layout=heads
                  instead (a bf16 WM), one step without lr warm-up: #1
                  24 + 24 and #6 24 x 521,
                  every other kernel 0; a profiler window of 16 decode
                  calls; the 'heads' route against the 'hd' route on the
                  same weights and frame 0's calls;
     grpo_variants - the trainer's other settings through the same entry
                  point, one step of 2 x 4 each (no learning-rate warm-up,
                  so that the step moves every trained leaf), exact
                  launches per step:
                  ReMax with the int8 WM and validation first (one WM call
                  of 12 rows: each sample's 4 rollouts, its greedy baseline
                  and its gt row; the val frame grid's PNG decoded with
                  zlib), the action-space reward (#1 24, no WM), the
                  wm_logprob reward (one full WM forward: #1 24 + 24; the
                  reward kernel vs plain route <= 5e-2) and speculative
                  decoding (k = 4, int8 weights on the module route: #4 24
                  x the rollout's calls, #8 / #9 0; verify calls, drafts
                  accepted, acceptance rate); then the greedy rollout with
                  and without speculation (2 frames: the first token that
                  differs, every verify chunk's logits vs the one-token
                  calls <= 5e-2) and one verify call of Sq = 5 whose 10 rows
                  stand at 10 offsets on the 'hd' and 'heads' layouts,
                  kernel vs plain route (logits <= 5e-2, layer 0's cache
                  bit-equal, only the call's positions written);
     grpo_pretrained - the GRPO entry point from checkpoints: the port's
                  five libero-width modules built with a second seed, every
                  parameter perturbed so that no norm, bias or layer scale
                  keeps init's constant, are
                  written in the reference's formats by this script's own
                  inverse of each layout (OpenVLA as two bf16 .safetensors
                  shards, the action_head / proprio_projector /
                  noisy_action_projector / sigma_net .pt files, the WM as
                  bf16 .safetensors, the tokenizer as a .pt with config.json,
                  LPIPS as a taming vgg.pth with heads); main_vla_rft_grpo.run
                  loads them (the four checkpoint paths, weights_int8) into a
                  trainer built from the first seed and takes one step:
                  no parameter equal to what was written for it before the
                  load, every one bit-equal to it after, the rollout's int8 WM equal to quantize_decoder_params
                  of the loaded WM, the grpo phase's exact launches, finite
                  metrics; then one step from the checkpoint without
                  sigma_net--*.pt, whose sigma net keeps its first-seed
                  initialisation; seconds to write and to
                  load each family, bytes read, peak host RSS and peak
                  device memory;
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
     sft_text   - sft.mode=text through trainer/main_sft.run at
                  Qwen2.5-0.5B width (vocabulary 151,936): a parquet of 32
                  prompt / response rows of 200-2100 words and a word-level
                  HF tokenizer written by this script, 2 steps of B = 4 rows
                  right-padded to 1663 tokens (the config's 16 would hold
                  16.2 GB of f32 logits; lr 5e-3 so that every bf16
                  parameter moves): exactly 24 launches of #1, #2 and #3 a
                  step, every parameter moved, finite losses; the step's
                  data / forward / backward / optimizer split and peak
                  memory; the kernel route's loss and q/k/v / embedding
                  gradients against the plain route's on step 1's weights
                  and batch; on step 1's and on the trained weights both
                  routes against attention computed in f64 (the kernel
                  route within twice the plain route's distance; both
                  routes again with delta from an f32 O, reported), #1's O
                  and LSE on every call of a trained forward against the
                  f64 attention, #2 / #3 against their twin on every call
                  of a trained backward;
     sft_align  - sft.mode=vla_align through main_sft.run at the libero
                  preset, B = 16: 8 PNGs of 224 px and a LLaVA chat JSON
                  written here (6 caption rows; the finetune file adds two
                  4-turn dialogs, one without an image), the tokenizer read
                  from actor_rollout_ref.model.path; 2 steps of the align
                  stage, 1 of the finetune stage, 1 of synthetic captions:
                  exactly 24 / 24 / 24 launches a step, every projector
                  parameter moved and every other VLA parameter
                  bit-identical, the global gradient norm each update
                  clipped (at least one step above grad_clip 1.0); the
                  kernel route's loss and projector gradients against the
                  plain route's on the next align batch;
     grpo_rlds  - the GRPO entry point on RLDS records (data.video.dataset_path)
                  at the libero preset: the fixture's 256 px JPEG frames
                  (tests/torch_fixtures/rlds/) decoded by the port (Pillow's
                  libjpeg-turbo), bit-equal to the reference's pixels; 2
                  shards x 3 episodes x 40 steps written with the port's
                  Example and TFRecord writers, read back by the native and
                  the plain reader; one grpo step (no lr warm-up) through
                  main_vla_rft_grpo.run on the records, weights_int8 and
                  val_before_train (one val batch from the val shard): the
                  trainer's batch and the next one its dataset draws
                  (val_fraction 0.5, image_aug, the crc32 stub
                  tokenizer) hold the reference's SHA-256 digests in the
                  fixture, every field; the grpo phase's exact launches,
                  finite metrics, moved / frozen leaves; the data's seconds
                  (first batch, steady), host RSS and device peaks, the host
                  libraries' build;
     parallel   - parallel/ over two ranks sharing the card (cuda:0 for
                  LOCAL_RANK % 1, gloo: NCCL refuses two ranks on one
                  device), each a process of this script: a probe of which
                  collectives gloo carries on CUDA tensors (one process
                  pair, a new one after a collective that aborts it; the
                  port stages the rest through host memory, chosen by the
                  backend), printed with which axes ran at 2 ranks and
                  why; main_vla_rft_grpo.run at the grpo phase's settings
                  (int8 WM, greedy, no lr warm-up, one step) over dp = 2
                  and over fsdp = 2 and, with the teacher-forced WM reward
                  (trainer.reward_fn=wm_logprob), at 1 rank here and over
                  fsdp = 2 (dp = 2 where gloo lacks FSDP2's collectives)
                  on the same global batch and draws: exact launches of
                  #1 / #4 / #8 / #9 (#1 alone with that reward) per rank, the
                  experts bit-identical across ranks, every expert leaf
                  moved and every frozen one bit-identical, rank 0 alone
                  checkpointing, each rank's peak memory (the pair under
                  80 GiB), the 2-rank teacher-forced step within bounds of
                  the 1-rank one (each rank digests its own shards of the
                  frozen trees); text RL and SFT at Qwen2.5-0.5B width over
                  fsdp = 2 (`_rank_text`): main_ppo.run's sampled grpo step
                  with the value-head RM, 2 prompts x 16 at 142 tokens, remat
                  (launches of #1 / #5 / #2 / #3 a rank, its share of the
                  1-rank step's; the policy bit-identical across ranks
                  after whole_like; the reference policy unmoved; against
                  the 1-rank step from the checkpoint on the pair's rollout:
                  log-probs, rewards, advantages and metrics within
                  PAR_COMPARED's rule, the policy within 2 x the 1-rank
                  step) and one text SFT step of 4 x 1663 (its loss within
                  1e-3 of the 1-rank step's, 24 / 24 / 24 a rank); Qwen2.5-0.5B
                  at full width on 2 x 1663 tokens over
                  sp = 2 (Ulysses, the sequence padded to 1664), tp = 2
                  and pp = 2 (12 layers a stage, 2 micro-batches): logits,
                  loss and (sp, pp) the gradient of the embedding output
                  against the unsharded route within sft_text's bounds,
                  #1 (and #2 / #3) launches per rank; #1 at 2 x 1663 with
                  7/1 heads (a rank's under sp or tp) and the WM prefill
                  at 8/8, #2 / #3 at 7/1, held against the twins and timed;
 12. text_gen   - text generation at Qwen2.5-0.5B width (vocabulary 151,936)
                  through trainer/main_generation.run at the config's sizes:
                  a seeded random checkpoint under HF names, a word-level
                  chat tokenizer of 151,936 ids and a parquet of 17
                  gsm8k-style chat prompts (16 of 150-1095 tokens, one
                  overlong and filtered) written here; RLHFDataset's chat
                  ids equal to the rendered template's on the card's
                  transformers; one batch of 16 prompts x n = 16 = 256 rows
                  x 568 tokens: the loaded weights bit-equal to the written
                  ones, exactly 24 of #1, 24 x 568 of #5 and no other
                  kernel, each of the 256 parquet rows equal to its
                  generated ids decoded again; prefill ms,
                  decode ms per step, tokens/s, peak memory and a
                  profiler window of 16 decode calls (wall vs device-busy);
                  greedy kernel vs plain route on the 16 prompts (prefill
                  logits <= 5e-2 of max|logit|, the first differing token
                  over 64 steps); compute_log_probs of the main path's
                  sequences (one row per prompt, 16 x 1663) on both routes
                  (24 of #1; log-probs and entropy within 2 x 5e-2 x
                  max|logit|, which the log-probs with kv_starts dropped
                  must exceed); generate_sequences(prefix_share_n=16) at 256
                  rows for 64 steps (24 of #1, 24 x 64 of #4; its step-0
                  logits against one cache a row <= 5e-2);
                  main_eval.evaluate_parquet on
                  the generations, n per prompt, and crafted rows that
                  must score as on the CPU (gsm8k, sympy's prime_math, a
                  passing and a failing prime_code program); #1 at the
                  text prefill and the log-prob shape, #5 and #4 at 256
                  rows, timed beside their twins, a masked
                  scaled_dot_product_attention and the bound;
 13. ppo        - text RL through trainer/main_ppo.run on text_gen's
                  checkpoint, tokenizer and prompts, with
                  enable_gradient_checkpointing (the decoder's remat): one
                  grpo step at the config's sizes (16 prompts x n = 16 =
                  256 rows x 568, 16 actor updates of 16 rows of 1663,
                  lr 1e-6), then validate(): exact launches of #1 / #5 /
                  #2 / #3 derived from the rows, log-prob chunks and
                  mini-batches (#4 0), timing_s per stage and peak memory
                  (< 80 GiB), finite metrics; the loaded policy and
                  reference policy bit-equal to the file; on-policy
                  identity (first mini-batch ppo_kl <= 1e-6 and clip
                  fraction 0, the reference policy's log-probs within 1e-6
                  of the policy's, its weights bit-identical after the
                  step); the parameters that moved at lr 1e-6; on the
                  first mini-batch the kernel route against the plain
                  route and an f64-attention route (sft_text's bounds);
                  #2 / #3 at the update's shape (the step's rows, one per
                  prompt: kv_starts up to 945) against their twin with the
                  gradients of pad positions exactly 0, finite, three calls
                  the same bits, timed beside the twin and the masked
                  enable_gqa SDPA backward; then one gae step of 2 prompts
                  x 16 of 142 tokens (a quarter of 568) at lr 5e-3 (its
                  critic's values and updates: the
                  exact launches; every policy and critic parameter moved,
                  the reference policy bit-identical);
     reward_models - main_ppo.run with text RL's reward models on text_gen's
                  inputs, bf16, enable_gradient_checkpointing: one PRIME step
                  at the config's shapes with recipe/prime.sh's overrides
                  (8 of its 16 prompts: 128 rows x 568 tokens; ce, token,
                  update after, lr 1e-6; the
                  RM's log-probs in chunks of 16, its reference's those of
                  the reference policy, which it is, in chunks of 8, the
                  RM's update in micro-batches of 16 rows): exact launches
                  of #1 / #5 / #2 / #3 (#4 0), #1's at 8 rows counted apart,
                  timing_s per stage (the RM's score and update among them)
                  and peak memory (< 80 GiB); the loaded policy, reference,
                  PRIME RM and its
                  reference bit-equal to the file; step 1's process scores
                  exactly 0 (the RM is its reference); PRIME's reference
                  bit-identical after the step; the RM's parameters that
                  moved at lr 1e-6; prime/rm_loss and prime/dpo_acc finite;
                  on PRIME's first update micro-batch, at the RM's start
                  weights and with its reference's log-probs on each
                  route's own attention, the kernel route against the
                  plain route and an f64-attention route (sft_text's
                  bounds).  Then one grpo step with the value-head RM cut
                  to 2 prompts x 16 of 142 tokens (a gsm8k prompt and one of a data
                  source with no rule scorer): the rule rows carry the
                  reward manager's scores, the others the RM's at their
                  last valid token, within 2 x 5e-2 x max|score| of the
                  plain route's; and two PRIME steps of PRIME's other
                  branch (dpo, bon_rm, whole, update before) cut the same
                  ways at RM lr 5e-3, outcomes from a stand-in verifier
                  (the parity of the response's length): step 1's
                  prime/rm_loss the tie value n x rows x ln 2 (the RM is
                  its reference), step 2's not, with a group of both
                  outcomes;
                  every RM parameter moved, its reference bit-identical, at
                  most one process score a row; exact launches in each;
then the card's name and power limit, the kernel table as one JSON line, and
last `{"ok": true, "device": {...}}`.  Any failure raises: the script exits
non-zero and prints no `ok` line.  It needs a CUDA device and the rest of the
repository beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import shutil
import struct
import subprocess
import sys
import tempfile
import time
import types

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
# sft_text: Qwen2.5-0.5B over a parquet of 32 rows whose word counts spread
# over 200-2100 (rows past 1663 tokens are cut), B = 4 rows of 1663 (the
# config's 16 would hold 16.2 GB of f32 logits at 151,936 words), 2 steps;
# the flash phases time #1-#3 at its shape with these ragged valid lengths
SFT_TEXT_ROWS, SFT_TEXT_WORDS, SFT_TEXT_BATCH, SFT_TEXT_STEPS = 32, (200, 2100), 4, 2
SFT_TEXT_KV_LENS = [1663, 1211, 742, 205]
# sft_text, each route against the attention computed in f64 from the same
# bf16 q / k / v (`_attention_f64`): trained, the q / k gradients of a
# saturated softmax are some 1e-4 of the v gradients and both bf16 routes
# miss them by more than their size (each rounds O to bf16 before delta =
# sum dO * O), so the kernel route's distance, per gradient and relative to
# max|ref|, is held to F64_ROUTE_RATIO times the plain route's plus
# SFT_GRAD_TOL; the loss to SFT_LOSS_TOL.  #1's O on every call of a
# trained forward: within BWD_RTOL of max|O_f64| plus BWD_ATOL
F64_ROUTE_RATIO = 2.0

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


def _sdpa_yardstick(qt, kt, vt):
    """scaled_dot_product_attention over head-major (B, H, S, D) q / k / v,
    causal, GQA through `enable_gqa`, as a closure (a yardstick only: the
    port never calls it).  The caller cuts full rows to their valid keys;
    right-padded rows stay whole: causal, a valid query never reaches a
    padding key, so the valid outputs are the function's."""
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=qt.shape[1] != kt.shape[1])


def phase_build() -> dict:
    from vla_rft_tpu_torch.data import image_ops, tfrecord
    from vla_rft_tpu_torch.ops import attention, cuda_build, decode_attention_hd
    from vla_rft_tpu_torch.ops import fused_decode_attention, fused_decode_layer

    t0 = time.perf_counter()
    # the data path's host libraries (g++; collected first, so their seconds
    # are their own): the TFRecord scanner and the resize / crop; then the
    # kernels
    infos = cuda_build.build("tfrecord_reader", "image_ops", "flash_fwd", "flash_bwd",
                             "decode_hd", "decode_heads", "fused_decode_layer",
                             "fused_decode_attention")
    wall = time.perf_counter() - t0
    attention._load()
    attention._load_bwd()
    decode_attention_hd._load("hd")
    decode_attention_hd._load("heads")
    fused_decode_layer._load()
    fused_decode_attention._load()
    tfrecord._load()
    image_ops._load()
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


def time_flash(attention, gen, shape, B, Sq, Sk, Hq, Hkv, kv_len, D: int = 64) -> dict:
    """#1 at one shape (causal; `kv_len` one valid length or one per row):
    held against the twin at this very shape, three calls the same bits,
    then its time replayed from a CUDA graph beside the twin's, SDPA's and
    the bound."""
    dev = torch.device("cuda")
    q = torch.randn(B, Sq, Hq, D, generator=gen, device=dev).bfloat16()
    k = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
    v = torch.randn(B, Sk, Hkv, D, generator=gen, device=dev).bfloat16()
    rows = {"kv_lens": torch.tensor(kv_len, dtype=torch.int32, device=dev).expand(B)
            .contiguous(),
            "kv_starts": torch.zeros(B, dtype=torch.int32, device=dev),
            "q_offset": torch.zeros(B, dtype=torch.int32, device=dev)}
    # SDPA over the valid keys only (a yardstick: the port never calls it);
    # ragged rows keep their padding, causal over the whole row
    n = kv_len if isinstance(kv_len, int) else Sk
    sdpa = _sdpa_yardstick(*(x[:, :n].transpose(1, 2) for x in (q, k, v)))
    kern = lambda: attention.flash_fwd(q, k, v, causal=True, **rows)
    twin = lambda: attention.attention_plain(q, k, v, causal=True, return_lse=True, **rows)
    # held against the twin at this very shape: at 1663 the last tile is ragged
    o, lse = kern()
    o_ref, lse_ref = twin()
    e_o = (o.float() - o_ref.float()).abs().max().item()
    e_l = (lse - lse_ref).abs().max().item()
    if not (e_o <= O_TOL and e_l <= LSE_TOL and torch.isfinite(o.float()).all()):
        raise AssertionError(f"flash at {shape}: max|dO|={e_o} max|dLSE|={e_l}")
    del o, lse, o_ref, lse_ref
    if not repeats_bit_for_bit(kern):
        raise AssertionError(f"flash at {shape}: three calls gave different bits")
    kernel_ms = graph_ms(kern)
    eager_ms = cuda_ms(kern)
    plain_ms = graph_ms(twin, 5)
    library_ms = graph_ms(sdpa)
    nbytes, flops = flash_work(q, k, rows["kv_lens"], rows["kv_starts"], rows["q_offset"], True)
    return {"B": B, "Sq": Sq, "Sk": Sk, "kv_len": kv_len, "Hq": Hq, "Hkv": Hkv,
            "D": D, "causal": True, "max_abs_err_o": e_o, "max_abs_err_lse": e_l,
            "repeats_bit_for_bit": True,
            "kernel_ms": kernel_ms, "eager_ms": eager_ms,
            "plain_ms": plain_ms,
            "library_ms": library_ms, **bound(nbytes, flops)}


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
    # 14/2 heads), at the WM prefill shape (2 x 1088 queries, 16/16 heads)
    # and at the wm_logprob reward's full WM forward (compute_log_prob: 8
    # rows of the whole 1663-token sequence)
    timed = {shape: time_flash(attention, gen, shape, *dims)
             for shape, *dims in (("serving", 1, 352, 352, 14, 2, 352),
                                  ("wm_prefill", 2, WM_PREFIX, 1152, 16, 16, WM_PREFIX),
                                  ("wm_logprob", N_SAMPLES * N_ROLLOUTS, WM_SFT_LEN, WM_SFT_LEN,
                                   16, 16, WM_SFT_LEN),
                                  ("sft_text", SFT_TEXT_BATCH, WM_SFT_LEN, WM_SFT_LEN, 14, 2,
                                   SFT_TEXT_KV_LENS))}
    out = {"phase": "flash", "cases": results, "max_abs_err_o": err_o,
           "max_abs_err_lse": err_lse, "tolerance": {"o": O_TOL, "lse": LSE_TOL},
           "timed": timed}
    emit(out)
    return out


def time_flash_bwd(attention, gen, shape, B, S, Hq, Hkv, kv_len, check: bool = False) -> dict:
    """#2 and #3 at one causal shape: three calls the same bits, their time
    replayed from a CUDA graph beside the twin's, SDPA's autograd backward
    (a yardstick) and the bound; with `check` also held against the twin
    at this shape (max_abs_err per kernel)."""
    dev = torch.device("cuda")
    q, do = (torch.randn(B, S, Hq, 64, generator=gen, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(B, S, Hkv, 64, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    rows = {"kv_lens": torch.tensor(kv_len, dtype=torch.int32, device=dev).expand(B)
            .contiguous(),
            "kv_starts": torch.zeros(B, dtype=torch.int32, device=dev),
            "q_offset": torch.zeros(B, dtype=torch.int32, device=dev)}
    o, lse = attention.flash_fwd(q, k, v, causal=True, **rows)
    delta = (do.float() * o.float()).sum(dim=-1)
    kw = dict(causal=True, **rows)
    errs = {}
    if check:
        got = attention.flash_bwd(q, k, v, o, lse, do, **kw)
        ref = attention.attention_bwd_plain(q, k, v, o, lse, do, **kw)
        for g_name, g, r in zip(("dq", "dk", "dv"), got, ref):
            e = (g.float() - r.float()).abs().max().item()
            lim = BWD_RTOL * r.float().abs().max().item() + BWD_ATOL
            if not (e <= lim and bool(torch.isfinite(g.float()).all())):
                raise AssertionError(f"flash_bwd at {shape}: max|d{g_name}| {e} > {lim}")
            errs[g_name] = e
        del got, ref
    plain_ms = graph_ms(lambda: attention.attention_bwd_plain(q, k, v, o, lse, do, **kw), 3)
    # autograd backward of SDPA over the same rows (a yardstick: the port
    # never calls it): forward + backward replayed from a CUDA graph,
    # less the forward alone
    n = kv_len if isinstance(kv_len, int) else S
    leaves = [x[:, :n].transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)]
    sdpa = _sdpa_yardstick(*leaves)
    do_lib = do[:, :n].transpose(1, 2)
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
    out = {
        "dq": {**entry, "kernel_ms": graph_ms(dq), "eager_ms": cuda_ms(dq),
               "repeats_bit_for_bit": True,
               "plan": attention.dq_plan(B, S, Hq, True),
               **bound(*work["dq"])},
        "dkv": {**entry, "kernel_ms": graph_ms(dkv), "eager_ms": cuda_ms(dkv),
                "repeats_bit_for_bit": True, "plan": attention.dkv_plan(B, S, Hq, Hkv, sms),
                **bound(*work["dkv"])},
    }
    if check:
        out["dq"]["max_abs_err"] = errs["dq"]
        out["dkv"]["max_abs_err"] = max(errs["dk"], errs["dv"])
    del leaves
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
        # the text-SFT layer: Qwen's 14/2 heads over 4 right-padded rows of 1663
        ("sft_text", SFT_TEXT_BATCH, WM_SFT_LEN, WM_SFT_LEN, 14, 2, 64,
         {"kv_lens": SFT_TEXT_KV_LENS}),
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
    # 96 text + 256 patch tokens, the last text token padding, 14/2 heads),
    # the WM-SFT step's layer (4 rows of 1663 tokens, 16/16 heads) and the
    # text-SFT step's (4 ragged rows of 1663, 14/2 heads)
    timed = {shape: time_flash_bwd(attention, gen, shape, B, S, Hq, Hkv, kv_len)
             for shape, B, S, Hq, Hkv, kv_len in (
                 ("vla_adapter", 16, 352, 14, 2, 351),
                 ("wm_sft", WM_SFT_ROWS, WM_SFT_LEN, 16, 16, WM_SFT_LEN),
                 ("sft_text", SFT_TEXT_BATCH, WM_SFT_LEN, 14, 2, SFT_TEXT_KV_LENS))}
    out = {"phase": "flash_bwd", "cases": results, "max_abs_err": err,
           "tolerance": f"max|d| <= {BWD_RTOL} * max|ref| + {BWD_ATOL} per gradient",
           "timed": timed}
    emit(out)
    torch.cuda.empty_cache()
    return out


def policy_kernel_vs_plain(bundle, batch, noise) -> dict:
    """The policy's kernel path against its plain path on one request (same
    weights, batch and flow noise): encode_context's hidden states relative
    to max|hidden| and the normalized actions, within HIDDEN_TOL /
    ACTION_TOL."""
    from vla_rft_tpu_torch.workers.predict import encode_context, predict_action

    lm = bundle.vla.language_model
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
    return {"hidden_rel_err": h_err, "action_max_abs_err": a_err,
            "tolerance": {"hidden_rel": HIDDEN_TOL, "action": ACTION_TOL}}


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
    batch = policy_fn.make_batch(requests[0], requests[0]["instruction"])
    noise = torch.randn(1, 8, 7, generator=torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    kvp = policy_kernel_vs_plain(bundle, batch, noise)

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
           "kernel_vs_plain": kvp,
           "device_ms": {"vision_and_projector": vision_ms, "encode_context": encode_ms,
                         "predict_action": predict_ms,
                         "flow_steps": predict_ms - encode_ms}}
    emit(out)
    return out


# the eval phase: main_eval's --scripted_env episode (ScriptedEnv succeeds at
# its step 12, after 2 settling steps), the ALOHA run through the action
# server and the in-process Bridge run
SCRIPTED_SUCCEED_AT, SCRIPTED_WAIT = 12, 2
ALOHA_ROLLOUTS, ALOHA_STEPS, BRIDGE_STEPS = 2, 8, 5
EVAL_TASK = "put the black bowl on the plate"


class _AlohaRig:
    """A stand-in ALOHA rig in dm_env's TimeStep shape: 480 x 640 frames from
    cam_high / cam_left_wrist / cam_right_wrist, new each step, and a 14-dof
    qpos that takes each command; it counts the commands it receives."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.commands = 0
        self.qpos = np.zeros(14)

    def reset(self):
        self.qpos = np.zeros(14)
        return self.get_observation()

    def get_qpos(self):
        return self.qpos.copy()

    def get_observation(self, t: int = 0):
        images = {c: self.rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
                  for c in ("cam_high", "cam_left_wrist", "cam_right_wrist")}
        return types.SimpleNamespace(observation={"images": images, "qpos": self.qpos.copy()})

    def step(self, action):
        self.commands += 1
        self.qpos[: len(action)] = action
        return self.get_observation()


class _WidowXClient:
    """A stand-in WidowX service client: a flat CHW float image of 256 px, a
    7-dim state and a 480 x 640 full image, new after each action."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)
        self.actions = []

    def reset(self):
        pass

    def move(self, transform, duration=0.8, blocking=True):
        pass

    def step_action(self, action, blocking=False):
        self.actions.append(np.asarray(action))

    def get_observation(self):
        return {"image": self.rng.uniform(size=3 * 256 * 256), "state": self.rng.normal(size=7),
                "full_image": self.rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)}


def _query_log(attention, fn):
    """fn(obs, task) wrapped: each call's #1 launches, host ms and chunk."""
    log = []

    def query(obs, task):
        before = attention.launches
        t = time.perf_counter()
        chunk = np.asarray(fn(obs, task))
        log.append({"ms": (time.perf_counter() - t) * 1e3, "chunk": chunk,
                    "launches": attention.launches - before})
        return chunk

    return query, log


def _check_queries(log, n_layers: int, expect: int, what: str) -> dict:
    per_query = [q["launches"] for q in log]
    if len(log) != expect or per_query != [n_layers] * expect:
        raise AssertionError(f"{what}: {len(log)} queries (expected {expect}), #1 launches "
                             f"per query {per_query} (expected {n_layers})")
    for q in log:
        if q["chunk"].shape != (8, 7) or not np.isfinite(q["chunk"]).all():
            raise AssertionError(f"{what}: bad action chunk {q['chunk'].shape}")
    ms = [q["ms"] for q in log]
    return {"queries": len(log), "launches_per_query": n_layers, "first_query_ms": ms[0],
            "steady_query_ms": float(np.median(ms[1:])), "query_ms": ms}


def _views_check(policy_fn, obs, views: int, seed: int) -> dict:
    """At `views` cameras: the request's sequence length, the kernel path
    against the plain path, and one predict_action traced by torch.profiler
    (after a warm-up call): wall and device-busy ms, the idle share, the
    kernels launched and #1's device ms."""
    from vla_rft_tpu_torch.serving.profile_request import _busy_us
    from vla_rft_tpu_torch.workers.predict import predict_action

    bundle = policy_fn.bundle
    if bundle.vla_cfg.num_images != views:
        raise AssertionError(f"policy built with {bundle.vla_cfg.num_images} views, not {views}")
    batch = policy_fn.make_batch(obs, EVAL_TASK)
    dev = batch["pixels"].device
    noise = torch.randn(1, 8, 7, generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    out = {"views": views,
           "seq_len": int(batch["input_ids"].shape[1]) + bundle.vla_cfg.total_patches}
    if views > 1:
        out["kernel_vs_plain"] = policy_kernel_vs_plain(bundle, batch, noise)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad():
        predict_action(bundle.vla, bundle.expert, batch, noise=noise)
        with torch.profiler.profile(activities=acts) as prof:
            _, wall_ms = host_ms(lambda: predict_action(bundle.vla, bundle.expert, batch,
                                                        noise=noise))
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels]) / 1e3
    flash = [e.time_range.end - e.time_range.start for e in kernels
             if "flash_fwd_kernel" in e.name]
    if len(flash) != bundle.vla_cfg.llm.num_layers:
        raise AssertionError(f"{views} views: the trace shows {len(flash)} #1 launches")
    out["traced_predict_action"] = {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms, "kernels": len(kernels),
        "flash_fwd": {"launches": len(flash), "device_ms": sum(flash) / 1e3}}
    return out


def phase_eval(attention) -> dict:
    """The eval surface at libero width: main_eval's LIBERO CLI at its
    defaults (2 views, center crop) on ScriptedEnv, the ALOHA harness at 3
    views through the action server, the Bridge harness at 1 view in
    process; each run's #1 launches per query, the kernel path against the
    plain path at 2 and 3 views, and #1 timed at the 2- and 3-view request
    shapes."""
    from vla_rft_tpu_torch.eval import aloha_eval, bridge_eval, main_eval, widowx_gym
    from vla_rft_tpu_torch.eval import policy as policy_mod
    from vla_rft_tpu_torch.serving.action_server import ActionServer, get_action_from_server

    torch.cuda.reset_peak_memory_stats()
    out = {"phase": "eval"}

    # (a) the LIBERO CLI at its defaults; build_policy_fn is wrapped to keep the
    # policy it builds and to log each query
    real_build, built = policy_mod.build_policy_fn, {}

    def build(**kwargs):
        built["policy"] = real_build(**kwargs)
        built["kwargs"] = kwargs
        query, built["log"] = _query_log(attention, built["policy"])
        return query

    policy_mod.build_policy_fn = build
    stdout = io.StringIO()
    try:
        _zero_counts(attention)  # the main path starts here
        with contextlib.redirect_stdout(stdout):
            main_eval.main(["--scripted_env"])
        launches = _counts(attention)  # read right after the main path
    finally:
        policy_mod.build_policy_fn = real_build
    by_rows = dict(attention.launches_by_rows)
    metrics = json.loads(stdout.getvalue().strip().splitlines()[-1])
    if metrics.get("success_rate") != 1.0:
        raise AssertionError(f"main_eval --scripted_env: {metrics}")
    policy2 = built["policy"]
    n_layers = policy2.bundle.vla_cfg.llm.num_layers
    kw = built["kwargs"]
    if (kw["num_images"], kw["center_crop"], kw["preset"]) != (2, True, "libero"):
        raise AssertionError(f"main_eval's defaults built {kw}")
    # policy steps until ScriptedEnv's success, taken from queues of 8
    expect = -(-(SCRIPTED_SUCCEED_AT - SCRIPTED_WAIT) // 8)
    libero = {"metrics": metrics, "build_kwargs": kw, "launches": launches,
              "launches_by_rows": by_rows,
              **_check_queries(built["log"], n_layers, expect, "main_eval")}
    if launches != {"flash_fwd": expect * n_layers, "flash_bwd_dq": 0, "flash_bwd_dkv": 0} \
            or by_rows != {1: expect * n_layers}:
        raise AssertionError(f"main_eval launches {launches}, by rows {by_rows}")
    rng = np.random.default_rng(21)
    obs2 = {"full_image": rng.integers(0, 256, (224, 224, 3), dtype=np.uint8),
            "wrist_image": rng.integers(0, 256, (224, 224, 3), dtype=np.uint8),
            "proprio": rng.normal(size=8).astype(np.float32)}
    libero["views"] = _views_check(policy2, obs2, 2, seed=2)
    out["libero_main_eval"] = libero
    del built, policy2
    gc.collect()
    torch.cuda.empty_cache()

    # (b) ALOHA at 3 views through the action server (center crop off, the
    # server's default)
    policy3 = policy_mod.build_policy_fn(preset="libero", num_images=3, device="cuda", seed=7)
    server = ActionServer(policy3, host="127.0.0.1", port=0)
    server.start_background()
    rig = _AlohaRig(seed=3)
    try:
        url = f"http://127.0.0.1:{server.port}/act"
        query, log = _query_log(attention, lambda obs, task: get_action_from_server(
            {**obs, "instruction": task}, url, timeout=600))
        cfg = aloha_eval.AlohaGenerateConfig(num_rollouts_planned=ALOHA_ROLLOUTS,
                                             max_steps=ALOHA_STEPS, pace_control=False)
        _zero_counts(attention)
        res = aloha_eval.run_eval(cfg, query, rig, [EVAL_TASK] * ALOHA_ROLLOUTS)
        launches = _counts(attention)
    finally:
        server.shutdown()
    steps = [e["total_steps"] for e in res["episodes"]]
    # each episode requeries when its queue (8 of each chunk) drains
    expect = ALOHA_ROLLOUTS * -(-ALOHA_STEPS // 8)
    aloha = {"episodes": len(steps), "steps": steps, "commands": rig.commands,
             "launches": launches, **_check_queries(log, n_layers, expect, "aloha")}
    if steps != [ALOHA_STEPS] * ALOHA_ROLLOUTS or rig.commands != sum(steps) \
            or launches["flash_fwd"] != expect * n_layers:
        raise AssertionError(f"aloha: steps {steps}, commands {rig.commands}, {launches}")
    obs3, _ = aloha_eval.prepare_observation(rig.get_observation(), cfg.resize_size)
    aloha["views"] = _views_check(policy3, obs3, 3, seed=3)
    out["aloha"] = aloha
    del policy3, server
    gc.collect()
    torch.cuda.empty_cache()

    # (c) Bridge at 1 view in process (center crop off, as Bridge requires):
    # one query a step, row 0 of each chunk executed
    policy1 = policy_mod.build_policy_fn(preset="libero", num_images=1, device="cuda", seed=7)
    client = _WidowXClient(seed=4)
    cfg = bridge_eval.BridgeGenerateConfig(max_steps=BRIDGE_STEPS, max_episodes=1,
                                           pace_control=False)
    env = widowx_gym.WidowXGym(client, cfg, blocking=False)
    query, log = _query_log(attention, policy1)
    _zero_counts(attention)
    res = bridge_eval.run_eval(cfg, env, query, [EVAL_TASK])
    launches = _counts(attention)
    bridge = {"steps": res["episodes"][0]["total_steps"], "launches": launches,
              **_check_queries(log, n_layers, BRIDGE_STEPS, "bridge")}
    executed = [np.array_equal(a, q["chunk"][0].astype(np.float32)) for a, q in
                zip(client.actions, log, strict=True)]
    if bridge["steps"] != BRIDGE_STEPS or not all(executed):
        raise AssertionError(f"bridge: {bridge['steps']} steps, row 0 executed {executed}")
    obs1 = {"full_image": rng.integers(0, 256, (224, 224, 3), dtype=np.uint8),
            "proprio": rng.normal(size=8).astype(np.float32)}
    bridge["views"] = _views_check(policy1, obs1, 1, seed=1)
    out["bridge"] = bridge
    del policy1
    gc.collect()
    torch.cuda.empty_cache()

    # (e) #1 at the 2- and 3-view request shapes (1 x 608, 1 x 864, 14/2)
    gen = torch.Generator(device="cuda").manual_seed(5)
    out["timed"] = {}
    for shape, part in (("libero_eval_2view", libero), ("aloha_3view", aloha)):
        S = part["views"]["seq_len"]
        out["timed"][shape] = time_flash(attention, gen, shape, 1, S, S, 14, 2, S)
    out["query_ms_by_views"] = {
        str(p["views"]["views"]): {"steady_query_ms": p["steady_query_ms"],
                                   **p["views"]["traced_predict_action"]}
        for p in (bridge, libero, aloha)}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
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
    if not heads:
        timed["spec5"] = _time_spec5(dec, gen, B, uniform, mid)
    out = {"phase": "decode_heads" if heads else "decode", "cases": results, "max_abs_err": err,
           "tolerance": f"|dO| <= {DEC_RTOL} * |O| + {DEC_ATOL}", "timed": timed}
    emit(out)
    return out


def _time_spec5(dec, gen, B, pm, mid) -> dict:
    """#4 at the speculative rollout's verify call: B rows of Sq = 5 (a
    pending token and 4 drafts), each at its own offset (own lengths mid - 4
    .. mid + 5), 2 prefixes of 1088, int8; held against its twin, three
    calls for the same bits, then timed beside the twin and SDPA over K/V
    already dequantised (a per-row boolean mask: the port never calls it)."""
    from vla_rft_tpu_torch.ops.decode_attention_hd import decode_plan

    Sq, Sr = 5, 384
    own = [mid - 4 + r for r in range(B)]
    kern, twin, info, t = _decode_inputs(dec, gen, int8=True, B=B, Sq=Sq, G=1, Hkv=16, Sr=Sr,
                                         shared=True, pm=pm, own=own, per_row=True)
    o, ref = kern(), twin().float()
    err = (o.float() - ref).abs().max().item()
    if not bool((((o.float() - ref).abs()) <= DEC_RTOL * ref.abs() + DEC_ATOL).all()):
        raise AssertionError(f"decode spec5: max|dO| {err}")
    if not repeats_bit_for_bit(kern):
        raise AssertionError("decode spec5: three calls gave different bits")
    pml = t["pm"].long()
    deq = lambda c, s_, n: dec.dequantize(c[:, :n], s_[:, :, :n], 64, torch.bfloat16)
    k_all = torch.cat([deq(t["sck"], t["ssc"][0], WM_PREFIX)[pml], deq(t["ck"], t["sc"][0], Sr)], 1)
    v_all = torch.cat([deq(t["scv"], t["ssc"][1], WM_PREFIX)[pml], deq(t["cv"], t["sc"][1], Sr)], 1)
    # query i of row b (position WM_PREFIX + own[b] - Sq + i) sees keys up to itself
    kv_len = WM_PREFIX + t["own"]
    qpos = kv_len[:, None] - Sq + torch.arange(Sq, device="cuda")[None]
    mask = torch.arange(k_all.shape[1], device="cuda")[None, None] <= qpos[..., None]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (t["q"], k_all, v_all))
    positions = int(t["own"].sum()) + int(pml.unique().numel()) * WM_PREFIX
    nbytes = positions * 2 * 16 * (64 + 2) + 2 * 2 * B * Sq * 16 * 64
    flops = 4 * 64 * 16 * int(mask.sum())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {**info, "own": own, "max_abs_err": err, "kernel_ms": graph_ms(kern), "eager_ms": cuda_ms(kern, 100),
            "plain_ms": graph_ms(twin, 10),
            "library_ms": graph_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask[:, None])),
            "repeats_bit_for_bit": True,
            "plan": decode_plan(B, Sq, 1, 16, Sr, True, 2, WM_PREFIX, sms),
            **bound(nbytes, flops)}


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
    attention.launches_by_rows.clear()
    heads.shared_heads_launches = heads.heads_launches = 0
    fdl.qkv_launches = fdl.o_mlp_launches = 0


def _expect(**nonzero) -> dict:
    """Expected launch counts: the given kernels, every other one 0."""
    return {**{k: 0 for k in ("flash_fwd", "decode_shared_hd", "decode_hd",
                              "decode_shared_heads", "decode_heads", "fused_qkv",
                              "fused_o_mlp")}, **nonzero}


def grpo_expect(fdl):
    """A grpo step's launches: #1 for the Qwen context forward and the WM's
    shared-prefix prefill; #4 for the prompt tails' prefill (7 tokens,
    unfused) and every fused call, #8 and #9 for every fused call."""
    def expect_fn(tr, _):
        b = tr.bundle
        L, roll = b.wm_cfg.num_layers, b.roll_cfg
        fused_calls = roll.num_frames * (roll.interact_max_tokens + 1)
        return _expect(flash_fwd=b.vla_cfg.llm.num_layers + L,
                       decode_shared_hd=L * (fused_calls + 1), fused_qkv=L * fused_calls,
                       fused_o_mlp=fdl.O_MLP_LAUNCHES * L * fused_calls)
    return expect_fn


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
    gen = torch.Generator(device="cuda").manual_seed(1)
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
        raise AssertionError(f"wm_reward: launches {counts}, expected {expect}")
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
    run = {"stage_ms": ms, "total_ms": sum(ms.values()), "launches": counts,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "reward_last": reward[:, -1].tolist(), "metrics": metrics}

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
    rollout_ms = run["stage_ms"]["wm_rollout"]
    out_json = {"phase": "wm_reward", "preset": "libero", "samples": N_SAMPLES, "n": n,
                "wm_rows": total + N_SAMPLES, "build_ms": build_ms, "run": run,
                "decode_calls_per_rollout": calls,
                "parts_ms": {"prefix_prefill": prefill_ms,
                             "decode_per_frame": (rollout_ms - prefill_ms) / Fn,
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


# one step each in the grpo and grpo_rlds phases (two before the parallel
# phase came), without the lr warm-up, whose first step is 0 for the flow
# head, so that every expert leaf moves
GRPO_STEPS = 1
NO_WARMUP = "actor_rollout_ref.actor.optim.lr_warmup_steps=0"


def _drive_grpo(mods, argv, expect_fn, n_steps: int = GRPO_STEPS, check_start=None,
                tokenizer=None):
    """n_steps steps of main_vla_rft_grpo.run(argv) at the libero preset
    (`check_start(trainer)` first runs on the trainer as the entry point
    hands it over, after any checkpoint load) with every kernel count set to
    0 just before each step and read just after it; each step's launches must equal expect_fn(trainer, its
    record), its metrics be finite, every trained expert leaf must move and
    every frozen leaf stay bit-identical (`tokenizer` goes to run for the
    RLDS prompts).  Returns (trainer, step records,
    the last step's expected launches, run seconds, expert leaves, frozen
    leaves)."""
    import tempfile

    from vla_rft_tpu_torch.trainer import main_vla_rft_grpo

    ckpt_dir = tempfile.mkdtemp(prefix="grpo_ckpt_")
    argv = argv + [f"data.train_batch_size={N_SAMPLES}",
                   f"actor_rollout_ref.rollout.n={N_ROLLOUTS}",
                   f"trainer.total_training_steps={n_steps}",
                   f"trainer.default_local_dir={ckpt_dir}"]
    start, steps = {}, []

    def on_start(trainer):
        if check_start is not None:
            check_start(trainer)
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
    tr = main_vla_rft_grpo.run(argv, on_start, on_step_start, on_step_end, tokenizer=tokenizer)
    run_s = time.perf_counter() - t0
    b = tr.bundle
    for s in steps:
        expect = expect_fn(tr, s)
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

    tr, steps, expect, run_s, n_expert, n_frozen = _drive_grpo(
        mods, ["world_model_rollout.rollout.weights_int8=true", NO_WARMUP],
        grpo_expect(mods[3]))
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
    """One GRPO step at the libero preset with the WM's KV cache in the
    'heads' layout (every other setting the default: a bf16 WM, int8 KV
    cache), so every WM decode call runs kernel #6; then a profiler window
    of 16 decode calls and the 'heads' route against the 'hd' route on the
    same weights and frame 0's tokens."""
    from vla_rft_tpu_torch.models.transformer import Decoder

    def expect_fn(tr, _):
        # #1: the Qwen context forward and the WM's shared-prefix prefill; #6:
        # the prompt tails' prefill (7 tokens) and every decode call
        b = tr.bundle
        L, roll = b.wm_cfg.num_layers, b.roll_cfg
        calls = 1 + roll.num_frames * (roll.interact_max_tokens + 1)
        return _expect(flash_fwd=b.vla_cfg.llm.num_layers + L, decode_shared_heads=L * calls)

    # one step, so no learning-rate warm-up (its first update's lr is 0)
    tr, steps, expect, run_s, n_expert, n_frozen = _drive_grpo(
        mods, ["world_model_rollout.rollout.kv_layout=heads",
               "actor_rollout_ref.actor.optim.lr_warmup_steps=0"], expect_fn, n_steps=1)
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


def read_png(path):
    """(H, W, 3) uint8 of an 8-bit RGB PNG of filter-0 rows (the port's
    writer), decoded with zlib; every chunk's CRC checked."""
    import struct
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    i, chunks = 8, {}
    while i < len(data):
        (n,) = struct.unpack(">I", data[i:i + 4])
        kind, body = data[i + 4:i + 8], data[i + 8:i + 8 + n]
        if struct.unpack(">I", data[i + 8 + n:i + 12 + n])[0] != zlib.crc32(kind + body):
            raise AssertionError(f"{path}: bad CRC in {kind}")
        chunks[kind] = chunks.get(kind, b"") + body
        i += 12 + n
    W, H, depth, colour = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(H, 1 + 3 * W)
    if (depth, colour) != (8, 2) or b"IEND" not in chunks or (raw[:, 0] != 0).any():
        raise AssertionError(f"{path}: not an 8-bit RGB PNG of filter-0 rows")
    return raw[:, 1:].reshape(H, W, 3)


class _Recorder:
    """A Decoder that records (ids, cache_index, logits) of every cached
    call that returns logits, and is otherwise the model it wraps."""

    def __init__(self, wm):
        self.wm, self.calls = wm, []

    def __getattr__(self, name):
        return getattr(self.wm, name)

    def __call__(self, ids, **kw):
        out = self.wm(ids, **kw)
        if kw.get("cache") is not None and kw.get("compute_logits", True):
            self.calls.append((ids, kw["cache_index"], out[0], kw.get("logits_last_only", False)))
        return out


def _spec_vs_plain(wm_q, roll, rows, k: int) -> dict:
    """The greedy rollout (2 frames) of `rows` with speculation (k drafts)
    and without, both on the module route (fused_layers off): each row's
    first token where they differ, if any, and every verify chunk's logits
    against the plain rollout's one-token calls at the same positions, as
    far as the chunk's tokens are the plain rollout's and lie before its
    row's first difference."""
    from vla_rft_tpu_torch.workers.wm_rollout import generate_sequences

    Fn, V, A = 2, roll.interact_max_tokens, roll.action_dim
    cfg = dataclasses.replace(roll, do_sample=False, num_frames=Fn,
                              response_length=Fn * (V + A), fused_layers=False)
    pm = torch.as_tensor(rows.prefix_map, dtype=torch.int32, device="cuda")
    P = roll.prompt_length
    rec, stats = {}, {}
    with torch.no_grad():
        for name, kk in (("plain", 0), ("spec", k)):
            r = rec[name] = _Recorder(wm_q)
            out = generate_sequences(r, torch.Generator(device="cuda"), rows.tails, rows.actions,
                                     dataclasses.replace(cfg, speculative_k=kk),
                                     shared_prefix=rows.prefixes, prefix_map=pm,
                                     stats=stats.setdefault(name, {}))
            r.tokens = out
    plain, spec = rec["plain"].tokens, rec["spec"].tokens
    B, T = plain.shape
    # each row's first differing token (T where the row agrees throughout):
    # a row's cache history is the plain rollout's only below it
    differs = (plain != spec).cpu()
    first = torch.where(differs.any(1), differs.int().argmax(1), torch.full((B,), T)).tolist()
    # the plain rollout's logits by the absolute position of the token fed
    # (its one-token calls), (B, positions, vocab)
    ones = [(int(ci), logits[:, 0]) for ids, ci, logits, _ in rec["plain"].calls
            if ids.shape[1] == 1]
    index = {pos: i for i, (pos, _) in enumerate(ones)}
    ref = torch.stack([lg for _, lg in ones], 1)
    seq = torch.cat([torch.zeros(B, P, dtype=plain.dtype), plain.cpu()], 1)
    agree = [P + f for f in first]
    errs = []
    for ids, ci, logits, _ in rec["spec"].calls:
        if not isinstance(ci, torch.Tensor):
            continue  # the prompt tail and the action calls
        ids_c, ci_c, sel = ids.cpu(), ci.cpu(), []
        for b in range(B):  # a row's chunk as far as it is the plain rollout's tokens
            for t in range(ids.shape[1]):
                pos = int(ci_c[b]) + t
                if pos >= agree[b] or pos not in index or int(ids_c[b, t]) != int(seq[b, pos]):
                    break
                sel.append((b, t, index[pos]))
        if sel:
            bb, tt, ii = (torch.tensor(x, device="cuda") for x in zip(*sel))
            r = ref[bb, ii]
            errs.append((logits[bb, tt] - r).abs().amax(-1) / r.abs().amax(-1))
    errs = torch.cat(errs) if errs else torch.zeros(0)
    if errs.numel() == 0 or errs.max().item() > WM_LOGIT_TOL:
        raise AssertionError(f"verify chunks vs one-token decode: {errs.numel()} positions, "
                             f"max rel {errs.max().item() if errs.numel() else None} > "
                             f"{WM_LOGIT_TOL}")
    return {"rows": B, "frames": Fn, "k": k, "tokens_equal": first == [T] * B,
            "first_difference_per_row": [None if f == T else f for f in first],
            "positions_compared": errs.numel(),
            "max_rel_logit_err": errs.max().item(), "spec_stats": stats["spec"],
            "plain_calls": stats["plain"]["calls"], "tolerance": WM_LOGIT_TOL}


def _per_row_verify(wm_q, rows, mods, gen, Sq: int = 5) -> dict:
    """One verify call of Sq tokens whose rows stand at as many different
    cache offsets, over the shared prefix, on the 'hd' and the 'heads'
    layout (the same int8 weights), kernel route vs attn_impl="plain":
    logits within WM_LOGIT_TOL; layer 0's cache (whose k / v both routes
    compute from the same embeddings and quantise in the same torch code)
    bit-equal; in every layer only the verify call's positions written;
    #4 / #6 launched once per layer by the kernel route, never by the plain
    one."""
    from vla_rft_tpu_torch.models.transformer import Decoder

    P0, P = rows.prefixes.shape[1], rows.prefixes.shape[1] + rows.tails.shape[1]
    B, L = rows.tails.shape[0], wm_q.cfg.num_layers
    pm = torch.as_tensor(rows.prefix_map, dtype=torch.int32, device="cuda")
    warm = 12  # one-token steps before the verify call
    steps = torch.randint(0, 4375, (B, warm), generator=gen, device="cuda")
    chunk = torch.randint(0, 4375, (B, Sq), generator=gen, device="cuda")
    ci = P + 3 + torch.arange(B, dtype=torch.int32, device="cuda")  # B offsets
    out = {}
    for layout in ("hd", "heads"):
        wmod = wm_q
        if layout == "heads":
            with torch.device("cuda"):
                wmod = Decoder(dataclasses.replace(wm_q.cfg, kv_layout="heads"))
            wmod.load_state_dict(wm_q.state_dict(), strict=True)
            wmod.eval().requires_grad_(False)
        seq_ax = wmod.cache_seq_axes()
        res = {}
        for impl in ("auto", "plain"):
            wmod.attn_impl = impl
            try:
                with torch.no_grad():
                    shared = wmod.init_cache(rows.prefixes.shape[0], P0)
                    wmod(rows.prefixes, cache=shared, cache_index=0, compute_logits=False)
                    kw = dict(shared_cache=shared, shared_len=P0, prefix_map=pm)
                    cache = wmod.init_cache(B, P - P0 + warm + 2 * B)
                    wmod(rows.tails, cache=cache, cache_index=P0, kv_lens=P, compute_logits=False,
                         **kw)
                    for i in range(warm):
                        wmod(steps[:, i:i + 1], cache=cache, cache_index=P + i,
                             compute_logits=False, **kw)
                    before = [c.clone() for c in cache]
                    torch.cuda.synchronize()
                    _zero_decode_counts(mods)
                    logits = wmod(chunk, cache=cache, cache_index=ci, kv_lens=ci + Sq, **kw)[0]
                    torch.cuda.synchronize()
                    counts = _decode_counts(mods)
            finally:
                wmod.attn_impl = "auto"
            # the own-cache positions each route changed, per (layer, row, position)
            changed = torch.zeros(L, B, cache[0].shape[seq_ax[0]], dtype=torch.bool,
                                  device="cuda")
            for a, b0, ax in zip(cache, before, seq_ax):
                changed |= (a != b0).movedim(ax, 2).flatten(3).any(-1)
            res[impl] = (logits.float(), cache, counts, changed)
        (k, ck, kc, kchg), (p, cp, pc, pchg) = res["auto"], res["plain"]
        key = "decode_shared_heads" if layout == "heads" else "decode_shared_hd"
        if kc != _expect(**{key: L}) or pc != _expect():
            raise AssertionError(f"per-row verify ({layout}): launches {kc} / {pc}")
        expect_pos = torch.zeros_like(kchg[0])
        for b in range(B):
            expect_pos[b, int(ci[b]) - P0:int(ci[b]) - P0 + Sq] = True
        rel = ((k - p).abs().max() / p.abs().max()).item()
        layer0_equal = all(torch.equal(a[0], b0[0]) for a, b0 in zip(ck, cp))
        only_written = all(bool((chg & ~expect_pos[None]).sum() == 0) for chg in (kchg, pchg))
        equal_int8 = float(sum((a[1:] == b0[1:]).sum().item() for a, b0 in zip(ck[:2], cp[:2]))
                           / sum(a[1:].numel() for a in ck[:2]))
        if not (rel <= WM_LOGIT_TOL and layer0_equal and only_written
                and bool(torch.isfinite(k).all())):
            raise AssertionError(f"per-row verify ({layout}): rel {rel}, layer 0 equal "
                                 f"{layer0_equal}, only the call's positions written "
                                 f"{only_written}")
        out[layout] = {"rows": B, "Sq": Sq, "offsets": ci.tolist(), "launches": kc,
                       "max_rel_logit_err": rel, "layer0_cache_bit_equal": layer0_equal,
                       "only_the_calls_positions_written": only_written,
                       "layers_1_up_int8_values_equal_share": equal_int8}
        if layout == "heads":
            del wmod
    out["tolerance"] = WM_LOGIT_TOL
    return out


def phase_grpo_variants(mods) -> dict:
    """The GRPO trainer's other settings through the CLI entry point at the
    libero preset, one step of 2 samples x n = 4 each with
    lr_warmup_steps=0 (the default warm-up starts at 0, and the one step
    must move every trained leaf), exact launches per step (every other
    kernel 0):
      remax      algorithm.adv_estimator=remax with the int8-weight WM and
                 validation first (val_before_train, val_iters 1, the frame
                 grid): one WM call of 12 rows (each sample's 4 rollouts, its
                 greedy baseline and its gt row), #1 24 + 24, #4 24 x 521,
                 #8 24 x 520, #9 3 x 24 x 520; the baseline metric finite; the
                 PNG decodes to the grid's shape;
      ac_reward  trainer.use_ac_reward: #1 24 (the Qwen encode) and nothing
                 else;
      wm_logprob trainer.reward_fn=wm_logprob: #1 24 + 24 (one full WM
                 forward), nothing else; the reward from the kernel route
                 against attn_impl="plain" on a next batch's rows;
      spec       world_model_rollout.rollout.speculative_k=4 with the
                 int8-weight WM (the module route: #8 / #9 off): #1 24 + 24,
                 #4 24 x the rollout's calls; the verify calls, drafts
                 accepted and acceptance rate.
    Then on the spec run's int8 WM: the greedy rollout with and without
    speculation (2 frames; every verify chunk's logits against the
    one-token calls) and one per-row verify call on both layouts, kernel
    route vs plain."""
    import glob
    import tempfile

    from vla_rft_tpu_torch.workers.reward import wm_logprob_reward

    fdl = mods[3]
    out = {"phase": "grpo_variants", "preset": "libero", "samples": N_SAMPLES, "n": N_ROLLOUTS}

    def run(name, argv, expect_fn, check=None):
        # no warm-up, so that the one step moves every trained leaf
        argv = argv + ["actor_rollout_ref.actor.optim.lr_warmup_steps=0"]
        tr, steps, expect, run_s, n_expert, n_frozen = _drive_grpo(mods, argv, expect_fn, 1)
        rec = {"argv": argv, "run_s": run_s, "steps": steps, "expected_launches": expect,
               "expert_leaves_moved": n_expert, "frozen_leaves_bit_identical": n_frozen}
        if check is not None:
            rec.update(check(tr, steps[0]["metrics"]))
        out[name] = rec
        return tr

    fused_expect = grpo_expect(fdl)

    img_dir = tempfile.mkdtemp(prefix="val_frames_")

    def remax_check(tr, m):
        b = tr.bundle
        rows = N_SAMPLES * (N_ROLLOUTS + 2)
        calls = 1 + b.roll_cfg.num_frames * (b.roll_cfg.interact_max_tokens + 1)
        (png,) = glob.glob(os.path.join(img_dir, "*.png"))
        shape = read_png(png).shape
        want = (3 * b.image_size, b.reward_cfg.num_frames * b.image_size, 3)
        if not (m["wm_rollout/rows"] == rows and m["wm_rollout/calls"] == calls
                and np.isfinite(m["critic/reward_baseline/mean"]) and shape == want):
            raise AssertionError(f"remax: rows {m['wm_rollout/rows']} calls "
                                 f"{m['wm_rollout/calls']} baseline "
                                 f"{m['critic/reward_baseline/mean']} png {shape} != {want}")
        return {"wm_rows_per_call": rows, "reward_baseline_mean": m["critic/reward_baseline/mean"],
                "png": os.path.basename(png), "png_shape": list(shape)}

    tr = run("remax", ["algorithm.adv_estimator=remax",
                       "world_model_rollout.rollout.weights_int8=true",
                       "trainer.val_before_train=true", "trainer.val_iters=1",
                       f"trainer.img_save_dir={img_dir}"], fused_expect, remax_check)
    out["wm_layers"] = tr.bundle.wm_cfg.num_layers
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    tr = run("ac_reward", ["trainer.use_ac_reward=true"],
             lambda tr, _: _expect(flash_fwd=tr.bundle.vla_cfg.llm.num_layers))
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    def logprob_check(tr, m):
        # the reward of a next batch's rows, kernel route vs plain (outside
        # the main path)
        from vla_rft_tpu_torch.models.action_head import sample_noisy_actions
        from vla_rft_tpu_torch.trainer.grpo_trainer import process_stage
        from vla_rft_tpu_torch.workers.flow_actor import rollout_from_hidden

        b, n = tr.bundle, N_ROLLOUTS
        with torch.no_grad():
            batch = tr.put_batch(tr.dataset.next_batch())
            gen = torch.Generator(device="cuda").manual_seed(23)
            hidden = tr.encode(batch).repeat_interleave(n, 0)
            noise = sample_noisy_actions(gen, batch["actions"].repeat_interleave(n, 0),
                                         b.expert_cfg)
            acts = rollout_from_hidden(b.expert, gen, hidden, noise["noise"],
                                       batch["proprio"].repeat_interleave(n, 0),
                                       b.expert_cfg.num_flow_steps)["predicted_actions"]
            ids = process_stage(b, tr.action_ranges, batch["raw_pixel_values"], acts,
                                batch["actions"], n, True)["input_ids"]
            r = {}
            for impl in ("auto", "plain"):
                b.wm.attn_impl = impl
                try:
                    r[impl] = wm_logprob_reward(b.wm, b.proc_cfg, b.reward_cfg, ids,
                                                b.roll_cfg.prompt_length)[0][:, -1]
                finally:
                    b.wm.attn_impl = "auto"
        rel = ((r["auto"] - r["plain"]).abs().max() / r["plain"].abs().max()).item()
        if not (rel <= WM_LOGIT_TOL and bool(torch.isfinite(r["auto"]).all())):
            raise AssertionError(f"wm_logprob reward, kernel vs plain: rel {rel}")
        return {"reward_kernel_vs_plain": {"rows": int(ids.shape[0]), "tokens": int(ids.shape[1]),
                                           "max_rel_err": rel, "reward": r["auto"].tolist(),
                                           "tolerance": WM_LOGIT_TOL},
                "wm_dyn_logprob_mean": m["critic/wm_dyn_logprob/mean"]}

    tr = run("wm_logprob", ["trainer.reward_fn=wm_logprob"],
             lambda tr, _: _expect(flash_fwd=tr.bundle.vla_cfg.llm.num_layers
                                   + tr.bundle.wm_cfg.num_layers), logprob_check)
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    k = 4

    def spec_expect(tr, s):
        b = tr.bundle
        return _expect(flash_fwd=b.vla_cfg.llm.num_layers + b.wm_cfg.num_layers,
                       decode_shared_hd=b.wm_cfg.num_layers * int(s["metrics"]["wm_rollout/calls"]))

    def spec_check(tr, m):
        keys = ("rows", "calls", "verify_calls", "proposed", "accepted", "acceptance_rate")
        rec = {key: m[f"wm_rollout/{key}"] for key in keys}
        print(f"grpo_variants spec: {rec['verify_calls']:.0f} verify calls, "
              f"{rec['accepted']:.0f} of {rec['proposed']:.0f} drafts accepted "
              f"(rate {rec['acceptance_rate']:.4f})", flush=True)
        return {"rollout": rec}

    tr = run("spec", [f"world_model_rollout.rollout.speculative_k={k}",
                      "world_model_rollout.rollout.weights_int8=true"], spec_expect, spec_check)
    wm_q = tr._wm_gen_model()
    rows, gen = _next_rollout_rows(tr, 24)
    out["spec_vs_plain_greedy"] = _spec_vs_plain(wm_q, tr.bundle.roll_cfg, rows, k)
    out["per_row_verify"] = _per_row_verify(wm_q, rows, mods, gen, Sq=1 + k)
    emit(out)
    del tr, wm_q
    return out


# ------------------------------------------------------------------------
# The reference's checkpoint formats, written from the port's modules by this
# script's own inverse of each layout (no converter of the port, no JAX), so
# that a loader which permutes, transposes or drops a weight shows up as a
# parameter that differs from what was written for it.
ST_DTYPES = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
             torch.int8: "I8", torch.int32: "I32", torch.int64: "I64", torch.uint8: "U8",
             torch.bool: "BOOL"}
# torchvision VGG16 `features` index of each LPIPS conv, and taming's slice of it
VGG_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
VGG_SLICE_STARTS = (4, 9, 16, 23)
TOKENIZER_LISTS = re.compile(
    r"(down_blocks|up_blocks|resnets|attentions|downsamplers|upsamplers|cross_att_blocks)_(\d+)")


def write_safetensors(path: str, sd: dict) -> int:
    """A .safetensors file of `sd` (CPU tensors, each in its own dtype): the
    little-endian u64 header length, the JSON header padded to 8 bytes, the
    tensors' bytes in order.  Returns the bytes written."""
    header, off = {}, 0
    for k, t in sd.items():
        n = t.numel() * t.element_size()
        header[k] = {"dtype": ST_DTYPES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    hb = json.dumps(header).encode()
    hb += b" " * (-len(hb) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for t in sd.values():
            if t.numel():
                f.write(memoryview(t.contiguous().view(-1).view(torch.uint8).numpy()))
    return 8 + len(hb) + off


def _fuse(groups: dict, out: dict) -> None:
    """{fused name: {"q"|"k"|"v": tensor}} -> out[fused name] = cat(q, k, v)."""
    for name, parts in groups.items():
        out[name] = torch.cat([parts["q"], parts["k"], parts["v"]], 0)


def openvla_names(sd: dict) -> dict:
    """The port's OpenVLA state dict under OpenVLAForActionPrediction's HF
    names: timm towers (fused qkv, `patch_embed.proj`, `ls1.gamma`,
    `reg_token`), the Qwen backbone under `language_model.model.`."""
    out, fused = {}, {}
    for k, v in sd.items():
        if k.startswith("language_model."):
            out["language_model.model." + k[len("language_model."):]] = v
            continue
        m = re.fullmatch(r"(vision_backbone\.\w+\.)(.+)", k)
        if not m:  # projector.fc{1,2,3}, action_queries
            out[k] = v
            continue
        tower, rest = m.groups()
        b = re.fullmatch(r"blocks\.(\d+)\.(\w+)\.(weight|bias)", rest)
        if rest == "reg_tokens":
            rest = "reg_token"
        elif rest.startswith("patch_embed."):
            rest = "patch_embed.proj." + rest[len("patch_embed."):]
        elif re.fullmatch(r"blocks\.\d+\.ls[12]_gamma", rest):
            rest = rest.replace("_gamma", ".gamma")
        elif b and b.group(2) in ("q", "k", "v"):
            fused.setdefault(f"{tower}blocks.{b.group(1)}.attn.qkv.{b.group(3)}",
                             {})[b.group(2)] = v
            continue
        elif b and b.group(2) == "proj":
            rest = f"blocks.{b.group(1)}.attn.proj.{b.group(3)}"
        elif b and b.group(2).startswith("mlp_"):
            rest = f"blocks.{b.group(1)}.mlp.{b.group(2)[4:]}.{b.group(3)}"
        out[tower + rest] = v
    _fuse(fused, out)
    return out


def _dit_name(k: str) -> str:
    """A port DiT name (after `dit.`) -> DiT_SingleTokenAction_OneCtx's."""
    for a, b in ((r"t_embedder\.fc1\.", "t_embedder.mlp.0."),
                 (r"t_embedder\.fc2\.", "t_embedder.mlp.2."),
                 (r"final_adaLN\.", "final_layer.adaLN_modulation.1."),
                 (r"final_linear\.", "final_layer.linear."),
                 (r"(blocks\.\d+\.)adaLN_modulation\.", r"\1adaLN_modulation.1."),
                 (r"(blocks\.\d+\.)mlp_(fc\d)\.", r"\1mlp.\2."),
                 (r"(blocks\.\d+\.cross_attn\.)(v_proj|l_proj|values_l_proj|out_v_proj)\.",
                  r"\1attn.\2.")):
        k = re.sub("^" + a, b, k)
    return k


def expert_components(sd: dict) -> dict:
    """The port's ActionExpert state dict as the reference's four component
    checkpoints: {"action_head", "sigma_net", "proprio_projector",
    "noisy_action_projector": state dict}."""
    out = {c: {} for c in ("action_head", "sigma_net", "proprio_projector",
                           "noisy_action_projector")}
    for k, v in sd.items():
        comp, rest = k.split(".", 1)
        if comp in ("action_head", "sigma_net"):
            head = "flow_predictor" if comp == "action_head" else "std_predictor"
            out[comp][f"{head}.dit.{_dit_name(rest[len('dit.'):])}"] = v
        else:
            out[comp][rest] = v
    return out


def hf_decoder_names(sd: dict) -> dict:
    """The port's Decoder state dict under HF LlamaForCausalLM's names."""
    return {k if k == "lm_head.weight" else "model." + k: v for k, v in sd.items()}


def tokenizer_names(sd: dict) -> dict:
    """The port's tokenizer state dict under CompressiveVQModelFSQ's
    (diffusers-style) names: numbered module lists, `to_out.0`, and each
    cross-attention block's packed `att.in_proj_*` / `att.out_proj`."""
    out, fused = {}, {}
    for k, v in sd.items():
        k = TOKENIZER_LISTS.sub(r"\1.\2", k).replace(".to_out.", ".to_out.0.")
        m = re.fullmatch(r"(.+\.cross_att_blocks\.\d+\.)(q|k|v)_proj\.(weight|bias)", k)
        if m:
            fused.setdefault(f"{m.group(1)}att.in_proj_{m.group(3)}", {})[m.group(2)] = v
            continue
        out[k.replace(".out_proj.", ".att.out_proj.")] = v
    _fuse(fused, out)
    return out


def lpips_names(sd: dict, slices: bool = True) -> dict:
    """The port's LPIPS state dict under taming's `vgg.pth` names
    (`net.sliceK.N.*`, or torchvision's `features.N.*`) with the heads as
    `lin{i}.model.1.weight`."""
    out = {}
    for k, v in sd.items():
        m = re.fullmatch(r"vgg\.conv(\d+)\.(weight|bias)", k)
        if m:
            idx = VGG_CONV_IDX[int(m.group(1))]
            s = 1 + sum(idx >= b for b in VGG_SLICE_STARTS)
            out[f"net.slice{s}.{idx}.{m.group(2)}" if slices
                else f"features.{idx}.{m.group(2)}"] = v
        else:
            out[k.replace(".weight", ".model.1.weight")] = v
    return out


def write_reference_checkpoints(root: str, second: dict, st_dtype=torch.bfloat16) -> dict:
    """Write the state dicts `second` ({vla, expert, wm, tokenizer, lpips:
    CPU state dict}) under `root` in the reference's formats: OpenVLA as
    two .safetensors shards in `st_dtype` plus the component .pt files in
    `ckpt/`, the WM as one .safetensors in `st_dtype` in `wm/`, the tokenizer as `tokenizer/model.pt`
    with a config.json, LPIPS as `lpips/vgg.pth`; and `ckpt_nosigma/`, the
    same checkpoint without sigma_net--*.pt (links to ckpt/'s files).
    Returns {"paths": {...}, "dtypes": {family: file dtype or None},
    "write_s": {...}, "bytes": {...}}."""
    paths = {k: os.path.join(root, k) for k in ("ckpt", "ckpt_nosigma", "wm", "tokenizer",
                                                 "lpips")}
    for d in paths.values():
        os.makedirs(d, exist_ok=True)
    write_s, nbytes = {}, {}

    t0 = time.perf_counter()
    names = openvla_names(second["vla"])
    keys = list(names)
    n = 0
    for i in range(2):
        part = {k: names[k].to(st_dtype) for k in keys[i::2]}
        f = f"model-{i + 1:05d}-of-00002.safetensors"
        n += write_safetensors(os.path.join(paths["ckpt"], f), part)
        os.symlink(os.path.join(paths["ckpt"], f), os.path.join(paths["ckpt_nosigma"], f))
    write_s["vla"], nbytes["vla"] = time.perf_counter() - t0, n

    t0 = time.perf_counter()
    n = 0
    for comp, sd in expert_components(second["expert"]).items():
        f = os.path.join(paths["ckpt"], f"{comp}--checkpoint.pt")
        torch.save({"module." + k: v for k, v in sd.items()} if comp == "action_head" else sd, f)
        n += os.path.getsize(f)
        if comp != "sigma_net":
            os.symlink(f, os.path.join(paths["ckpt_nosigma"], os.path.basename(f)))
    write_s["expert"], nbytes["expert"] = time.perf_counter() - t0, n

    t0 = time.perf_counter()
    wm = {k: v.to(st_dtype) for k, v in hf_decoder_names(second["wm"]).items()}
    nbytes["wm"] = write_safetensors(os.path.join(paths["wm"], "model.safetensors"), wm)
    write_s["wm"] = time.perf_counter() - t0
    del wm

    t0 = time.perf_counter()
    f = os.path.join(paths["tokenizer"], "model.pt")
    torch.save({"state_dict": tokenizer_names(second["tokenizer"])}, f)
    tok = second["tokenizer"]
    channels = [int(tok[k].shape[0]) for k in sorted(tok) if re.fullmatch(
        r"encoder\.down_blocks_\d+\.resnets_0\.conv1\.weight", k)]
    lpb = len([k for k in tok if re.fullmatch(
        r"encoder\.down_blocks_0\.resnets_\d+\.conv1\.weight", k)])
    with open(os.path.join(paths["tokenizer"], "config.json"), "w") as cf:
        json.dump({"block_out_channels": channels, "layers_per_block": lpb}, cf)
    write_s["tokenizer"], nbytes["tokenizer"] = time.perf_counter() - t0, os.path.getsize(f)

    t0 = time.perf_counter()
    f = os.path.join(paths["lpips"], "vgg.pth")
    torch.save(lpips_names(second["lpips"]), f)
    write_s["lpips"], nbytes["lpips"] = time.perf_counter() - t0, os.path.getsize(f)
    return {"paths": paths, "write_s": write_s, "bytes": nbytes,
            "dtypes": {"vla": st_dtype, "wm": st_dtype}}


@torch.no_grad()
def perturb_(module, seed: int) -> None:
    """Add 0.02 times a seeded standard normal to every floating parameter
    of `module` in place.  init_random_ sets every norm weight and layer
    scale to 1 and every bias to 0, in every layer and for every seed, so a
    loader that swapped two of them, or read another layer's, would still
    give the written values; after this no two of them agree."""
    dev = next(module.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for p in module.parameters():
        if p.is_floating_point():
            r = torch.randn(p.shape, generator=gen, device=dev, dtype=torch.float32)
            p.copy_(p.float() + 0.02 * r)


def compare_written(trainer, second: dict, dtypes: dict, keep=()):
    """(the parameters of the trainer's five modules that equal, bit for bit,
    what was written for them; those that differ; the number compared): the
    written value is `second`'s in its file's dtype, then in the parameter's
    dtype; names under a `keep` prefix are skipped."""
    same, differ = [], []
    for fam, sd in second.items():
        for k, p in getattr(trainer.bundle, fam).state_dict().items():
            if keep and f"{fam}.{k}".startswith(keep):
                continue
            want = sd[k].to(dtypes.get(fam) or sd[k].dtype).to(device=p.device, dtype=p.dtype)
            (same if torch.equal(p, want) else differ).append(f"{fam}.{k}")
    return same, differ, len(same) + len(differ)


@contextlib.contextmanager
def before_load(check):
    """Within the block, main_vla_rft_grpo.run calls `check(trainer)` on the
    trainer it builds just before it loads the checkpoints into it."""
    from vla_rft_tpu_torch.trainer import main_vla_rft_grpo

    load = main_vla_rft_grpo._maybe_load_pretrained

    def checked(trainer, config):
        check(trainer)
        return load(trainer, config)

    main_vla_rft_grpo._maybe_load_pretrained = checked
    try:
        yield
    finally:
        main_vla_rft_grpo._maybe_load_pretrained = load


def host_rss_gib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 2 ** 30
    raise RuntimeError("/proc/self/status has no VmRSS")


class HostRssPeak:
    """The largest resident set of this process over a window, sampled every
    5 ms by a thread (the card's machine reports no VmHWM to reset)."""

    def __init__(self, every_s: float = 0.005):
        import threading

        self.every_s, self.peak = every_s, host_rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()

    def _sample(self):
        while not self._stop.wait(self.every_s):
            self.peak = max(self.peak, host_rss_gib())

    def stop(self) -> float:
        self._stop.set()
        self._thread.join()
        return max(self.peak, host_rss_gib())


def phase_grpo_pretrained(mods) -> dict:
    """The GRPO entry point from checkpoints at the libero width: the port's
    five modules built with a second seed, every parameter perturbed
    (perturb_: norms, biases and layer scales too), are written in the
    reference's formats (write_reference_checkpoints), then
    main_vla_rft_grpo.run loads them with the four checkpoint paths and
    weights_int8=true into a trainer built from the first seed (trainer.seed
    0) and takes one step.  Checks: before the load no parameter of vla /
    expert / wm / tokenizer / lpips equals the array written for it, after
    it every one does, bit for bit; the int8 WM the rollout decoded
    with equals quantize_decoder_params of the loaded WM; the step's
    launches are the grpo phase's (#1 24 + 24, #4 24 x 521, #8 24 x 520, #9
    3 x 24 x 520); metrics finite.  Then one step from the checkpoint
    without sigma_net--*.pt: the same parameters loaded, the sigma net at
    its first-seed initialisation."""
    import tempfile

    from vla_rft_tpu_torch.config import vla_rft_default_config
    from vla_rft_tpu_torch.models.action_head import ActionExpert
    from vla_rft_tpu_torch.models.factory import build_models, init_random_
    from vla_rft_tpu_torch.models.transformer import quantize_decoder_params

    fdl = mods[3]
    second_seed, families = 7, ("vla", "expert", "wm", "tokenizer", "lpips")
    t0 = time.perf_counter()
    b2 = build_models(vla_rft_default_config(), "libero", device="cuda", seed=second_seed)
    for i, m in enumerate(families):
        perturb_(getattr(b2, m), second_seed * 100 + i)
    second = {m: {k: v.detach().cpu() for k, v in getattr(b2, m).state_dict().items()}
              for m in families}
    del b2
    gc.collect()
    torch.cuda.empty_cache()
    build_s = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="grpo_pretrained_")
    out = {"phase": "grpo_pretrained", "preset": "libero", "second_seed": second_seed,
           "second_modules_s": build_s, "runs": {}}
    try:
        w = write_reference_checkpoints(root, second)
        out["write_s"], out["file_bytes"] = w["write_s"], w["bytes"]
        paths = w["paths"]

        def argv(ckpt):
            return ["world_model_rollout.rollout.weights_int8=true",
                    "actor_rollout_ref.actor.optim.lr_warmup_steps=0",
                    f"actor_rollout_ref.model.ckpt_path={ckpt}",
                    f"world_model_rollout.model.path={paths['wm']}",
                    f"processor.tokenizer.path={paths['tokenizer']}",
                    f"processor.lpips_path={paths['lpips']}"]

        def preload_check(rec, keep=()):
            # the trainer's first-seed parameters differ from the files, so
            # the bit-equality after the load shows that each one was loaded
            def check(tr):
                same, _, n = compare_written(tr, second, w["dtypes"], keep)
                if same:
                    raise AssertionError(f"parameters that hold the written value before the "
                                         f"load: {same[:8]} ({len(same)} of {n})")
                rec["parameters_differ_before_load"] = n
            return check

        def load_record(tr, keep=()):
            # over the trainer's build and the load: run() hands the trainer
            # to on_start right after the load
            rec = {"host_peak_rss_gib": rss.stop(), "host_rss_before_gib": rss_before,
                   "device_peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                   "loaded": tr.pretrained}
            _, bad, n = compare_written(tr, second, w["dtypes"], keep)
            if bad or set(tr.pretrained) != set(families):
                raise AssertionError(f"loaded parameters that differ from the files: {bad[:8]} "
                                     f"({len(bad)} of {n}); families loaded "
                                     f"{sorted(tr.pretrained)}")
            rec["parameters_bit_equal"] = n
            return rec

        fused_expect = grpo_expect(fdl)

        # one step from the full checkpoint
        rec = {}

        def check_full(tr):
            rec.update(load_record(tr))

        rss_before = host_rss_gib()
        rss = HostRssPeak()
        torch.cuda.reset_peak_memory_stats()
        with before_load(preload_check(rec)):
            tr, steps, expect, run_s, n_expert, n_frozen = _drive_grpo(
                mods, argv(paths["ckpt"]), fused_expect, 1, check_full)
        wm_q = tr._wm_q
        q_want = quantize_decoder_params(tr.bundle.wm.state_dict(), wm_q.cfg)
        q_bad = [k for k, v in wm_q.state_dict().items() if not torch.equal(v, q_want[k])]
        if q_bad or set(q_want) != set(wm_q.state_dict()):
            raise AssertionError(f"the rollout's int8 WM is not quantize_decoder_params of the "
                                 f"loaded WM: {q_bad[:8]} ({len(q_bad)})")
        rec.update({"run_s": run_s, "steps": steps, "expected_launches": expect,
                    "expert_leaves_moved": n_expert, "frozen_leaves_bit_identical": n_frozen,
                    "int8_wm_tensors_bit_equal": len(q_want)})
        out["runs"]["with_sigma_net"] = rec
        del tr, wm_q, q_want
        gc.collect()
        torch.cuda.empty_cache()

        # the checkpoint without sigma_net--*.pt: the sigma net keeps its
        # first-seed initialisation (the trainer's expert: trainer.seed + 1)
        rec = {}

        def check_nosigma(tr):
            rec.update(load_record(tr, keep=("expert.sigma_net.",)))
            with torch.device(tr.device):
                init = init_random_(ActionExpert(tr.bundle.expert_cfg), tr._seed + 1)
            init = {k: v for k, v in init.state_dict().items() if k.startswith("sigma_net.")}
            got = tr.bundle.expert.state_dict()
            bad = [k for k, v in init.items() if not torch.equal(got[k], v)]
            if bad or not init:
                raise AssertionError(f"sigma net not at its first-seed init: {bad[:8]}")
            rec["sigma_net_at_first_seed_init"] = len(init)

        rss_before = host_rss_gib()
        rss = HostRssPeak()
        torch.cuda.reset_peak_memory_stats()
        with before_load(preload_check(rec, keep=("expert.sigma_net.",))):
            _, steps, expect, run_s, _, _ = _drive_grpo(
                mods, argv(paths["ckpt_nosigma"]), fused_expect, 1, check_nosigma)
        rec.update({"run_s": run_s, "steps": steps, "expected_launches": expect})
        out["runs"]["without_sigma_net"] = rec
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name, r in out["runs"].items():
        print(f"grpo_pretrained {name}: load s " + ", ".join(
            f"{f} {v['seconds']:.2f} ({v['bytes']} B)" for f, v in r["loaded"].items())
              + f"; host RSS {r['host_rss_before_gib']:.2f} GiB before, peak "
              f"{r['host_peak_rss_gib']:.2f} GiB over build + load; device peak "
              f"{r['device_peak_gib']:.2f} GiB; parameters that differ from the files "
              f"before the load {r['parameters_differ_before_load']}, bit-equal to them "
              f"after {r['parameters_bit_equal']}", flush=True)
    print("grpo_pretrained write s " + ", ".join(
        f"{f} {v:.2f} ({out['file_bytes'][f]} B)" for f, v in out["write_s"].items()),
          flush=True)
    emit(out)
    return out


# ---------------------------------------------------------------- grpo_rlds
RLDS_FIXTURE = os.path.join("tests", "torch_fixtures", "rlds")
RLDS_SHARDS, RLDS_EPISODES, RLDS_STEPS = 2, 3, 40
RLDS_INSTRUCTION = ("pick up the black bowl between the plate and the ramekin and place it "
                    "on the plate")
RLDS_ARGV = ["data.val_fraction=0.5", f"data.train_batch_size={N_SAMPLES}"]


def rlds_fixture(root: str) -> tuple:
    """The fixture's JPEG frames (bytes, in name order), the reference's
    decoded pixels of them and the digests of its batches."""
    d = os.path.join(root, RLDS_FIXTURE)
    names = sorted(f for f in os.listdir(d) if f.endswith(".jpg"))
    frames = [open(os.path.join(d, f), "rb").read() for f in names]
    with np.load(os.path.join(d, "pixels.npz")) as z:
        pixels = z["pixels"]
    with open(os.path.join(d, "digests.json")) as f:
        digests = json.load(f)
    return frames, pixels, digests


def write_rlds_records(data_dir: str, frames: list) -> list:
    """RLDS_SHARDS shards of RLDS_EPISODES episodes of RLDS_STEPS steps under
    data_dir/<dataset_name>/, written with the port's Example writer and
    TFRecord framing: episode g shows the frames cycled from offset g, with
    actions (7) and states (8) from numpy seeded (16, g) and one LIBERO
    instruction.  Returns the shard paths."""
    from vla_rft_tpu_torch.data.rlds import RLDSConfig, make_episode_example
    from vla_rft_tpu_torch.data.tfrecord import write_records

    cfg = RLDSConfig()
    d = os.path.join(data_dir, cfg.dataset_name)
    os.makedirs(d, exist_ok=True)
    paths = []
    for s in range(RLDS_SHARDS):
        payloads = []
        for e in range(RLDS_EPISODES):
            g = s * RLDS_EPISODES + e
            rng = np.random.default_rng((16, g))
            actions = rng.uniform(-1, 1, (RLDS_STEPS, 7)).astype(np.float32)
            states = rng.normal(size=(RLDS_STEPS, 8)).astype(np.float32)
            imgs = [frames[(t + g) % len(frames)] for t in range(RLDS_STEPS)]
            payloads.append(make_episode_example(imgs, actions, states, RLDS_INSTRUCTION, cfg))
        paths.append(os.path.join(
            d, f"{cfg.dataset_name}-train.tfrecord-{s:05d}-of-{RLDS_SHARDS:05d}"))
        write_records(paths[-1], payloads)
    return paths


def batch_digest(batch: dict) -> dict:
    """Per field: shape, dtype and SHA-256 of the bytes."""
    import hashlib

    return {k: {"shape": list(np.shape(v)), "dtype": str(np.asarray(v).dtype),
                "sha256": hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()}
            for k, v in sorted(batch.items())}


def compare_digests(got: dict, ref: dict) -> None:
    """Every field of `got` has the reference's shape, dtype and bytes;
    raises on a mismatch."""
    if sorted(got) != sorted(ref):
        raise AssertionError(f"batch fields {sorted(got)} != reference {sorted(ref)}")
    bad = [f"{k}: {got[k]} vs {r}" for k, r in ref.items() if got[k] != r]
    if bad:
        raise AssertionError(f"batch differs from the reference: {bad}")


def rlds_config_tree(data_dir: str, extra=()):
    from vla_rft_tpu_torch.config import vla_rft_default_config

    return vla_rft_default_config().apply_overrides(
        [f"data.video.dataset_path={data_dir}", *RLDS_ARGV, *extra])


def _levels(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return {"bit_equal": bool(d.max() == 0), "max_abs_levels": int(d.max()),
            "mean_abs_levels": float(d.mean()), "share_differing": float((d > 0).mean())}


def phase_grpo_rlds(mods, build: dict) -> dict:
    """The GRPO entry point on RLDS records at the libero preset: (1) the
    fixture's JPEG frames decoded by the port (Pillow's libjpeg-turbo)
    against the reference's pixels, bit for bit; (2) RLDS_SHARDS x
    RLDS_EPISODES x RLDS_STEPS records written with the port's writers and
    read back through the native and the plain TFRecord readers, the same
    bytes; (3) one grpo step through main_vla_rft_grpo.run on those records
    with weights_int8 and val_before_train (one val batch, from the val
    shard): the trainer's batch and the next its dataset draws (val_fraction 0.5, the crc32
    stub tokenizer, image_aug on) hold the reference's digests in the
    fixture, every field's bytes; the grpo phase's exact launches, finite
    metrics, the expert moved, frozen leaves bit-identical; (4) the data's
    seconds (next_batch timed apart from the step, which draws its next
    batch before on_step_start), the host RSS and device peaks, and the
    build of the host libraries (phase build's record, `build`)."""
    import tempfile

    from vla_rft_tpu_torch.data import image_ops, tfrecord
    from vla_rft_tpu_torch.eval.policy import _StubTokenizer

    rss = HostRssPeak()
    root = os.path.dirname(os.path.abspath(__file__))
    frames, ref_pixels, digests = rlds_fixture(root)
    h, w = ref_pixels.shape[1:3]
    t = time.perf_counter()
    pixels = image_ops.decode_jpeg_batch(frames, h, w)
    decode = {"route": "pillow", "frames": len(frames), "seconds": time.perf_counter() - t,
              **_levels(pixels, ref_pixels)}
    if not decode["bit_equal"]:
        raise AssertionError(f"the port's JPEG decode differs from the reference: {decode}")

    data_dir = tempfile.mkdtemp(prefix="rlds_")
    t = time.perf_counter()
    paths = write_rlds_records(data_dir, frames)
    write_s = time.perf_counter() - t
    for p in paths:
        native = list(tfrecord.read_records(p, verify_crc=True))
        plain = list(tfrecord.read_records(p, plain=True))  # its crc check: the CPU tests
        if native != plain or len(native) != RLDS_EPISODES:
            raise AssertionError(f"{p}: native and plain readers disagree")

    data_s, checked = [], []

    def check_start(trainer):
        inner = trainer.dataset.next_batch

        def timed_next():
            t0 = time.perf_counter()
            out = inner()
            data_s.append(time.perf_counter() - t0)
            if len(checked) < len(digests["batches"]):  # the trainer's own batches
                compare_digests(batch_digest(out), digests["batches"][len(checked)])
                checked.append(True)
            return out

        trainer.dataset.next_batch = timed_next

    tr, steps, expect, run_s, n_expert, n_frozen = _drive_grpo(
        mods, [f"data.video.dataset_path={data_dir}", *RLDS_ARGV,
               "world_model_rollout.rollout.weights_int8=true", "trainer.val_before_train=true",
               "trainer.val_iters=1", NO_WARMUP],
        grpo_expect(mods[3]), check_start=check_start, tokenizer=_StubTokenizer())
    while len(checked) < len(digests["batches"]):  # the batches a longer run would draw
        tr.dataset.next_batch()
    if len(checked) != len(digests["batches"]):
        raise AssertionError(f"the trainer drew {len(checked)} batches, the fixture holds "
                             f"{len(digests['batches'])}")
    train_files = [os.path.basename(f) for f in tr.dataset.files]
    val_files = [os.path.basename(f) for f in tr.val_dataset.files]
    if (tr.val_dataset is tr.dataset or set(train_files) & set(val_files) or not val_files
            or tr.val_dataset._step != 1):
        raise AssertionError(f"validation: train {train_files}, val {val_files}, val batches "
                             f"{tr.val_dataset._step}")
    out = {"phase": "grpo_rlds", "preset": "libero", "samples": N_SAMPLES, "n": N_ROLLOUTS,
           "weights_int8": True, "decode": decode,
           "records": {"shards": RLDS_SHARDS, "episodes_per_shard": RLDS_EPISODES,
                       "steps": RLDS_STEPS, "bytes": sum(os.path.getsize(p) for p in paths),
                       "write_s": write_s, "native_equals_plain": True},
           "digests": {"trainer_batches_bytes_equal": len(checked),
                       "fields": sorted(digests["batches"][0])},
           "train_files": train_files, "val_files": val_files, "val_batches": 1,
           "data_s": {"first_batch": data_s[0], "steady": data_s[1:]},
           "run_s": run_s, "steps": steps, "expected_launches_per_step": expect,
           "expert_leaves_moved": n_expert, "frozen_leaves_bit_identical": n_frozen,
           "host_rss_peak_gib": rss.stop(),
           "host_libraries": {k: {f: build["libraries"][k][f] for f in ("seconds", "built")}
                              for k in ("tfrecord_reader", "image_ops")}}
    shutil.rmtree(data_dir, ignore_errors=True)
    emit(out)
    del tr
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
    attention.launches_by_rows.clear()


def _counts(attention) -> dict:
    return {"flash_fwd": attention.launches, "flash_bwd_dq": attention.bwd_dq_launches,
            "flash_bwd_dkv": attention.bwd_dkv_launches}


def _drive_sft(attention, argv, before_steps=None):
    """main_sft.run(argv) on the card with every kernel count set to 0 just
    before each step and read just after it.  Returns (run, per-step
    records, a clone of every parameter taken before the first step, the
    ids of the parameters whose gradient was exactly zero in every step,
    peak memory in GiB over the steps).  Each step's record holds its loss,
    ms, launches and the global gradient norm that the update clipped.
    `before_steps(trainer)` runs after the build, before the counts and
    the memory peak are set to 0 for the first step."""
    from vla_rft_tpu_torch.trainer import main_sft

    steps, start, grads, nonzero, norms = [], {}, [], {}, []

    def on_start(trainer):
        if before_steps is not None:
            before_steps(trainer)
        start.update({id(p): p.detach().clone() for p in trainer.params})
        backward, update = trainer.backward, trainer.update

        def keep_grads(loss):  # the step's gradients, read in on_step after its time
            grads[:] = zip(trainer.params, backward(loss))
            return [g for _, g in grads]

        def keep_norm(g):
            norms.append(update(g))
            return norms[-1]

        trainer.backward, trainer.update = keep_grads, keep_norm
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        _zero_counts(attention)  # the main path starts here

    def on_step(step, loss, seconds):
        steps.append({"step": step, "loss": loss, "ms": seconds * 1e3,
                      "launches": _counts(attention)})  # read right after the step
        steps[-1]["grad_norm"] = float(norms.pop())
        flags = torch.stack([g.ne(0).any() for _, g in grads]).tolist()
        for (p, _), f in zip(grads, flags):
            nonzero[id(p)] = nonzero.get(id(p), False) or f
        grads.clear()
        _zero_counts(attention)

    run = main_sft.run(argv, on_start=on_start, on_step=on_step)
    del run.trainer.backward, run.trainer.update  # the class's own again
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

    kvp = _kernel_vs_plain(attention, lm, lambda: tr.compute_loss(batch, noise), tr.backward,
                           {w: idx[w] for w in watch}, L)
    _require_agreement(kvp, L, "sft vla_adapter")
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
               "kernel_vs_plain": kvp}
    del run, tr, bundle, lm, batch, noise, loss
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


def _moved_and_frozen(trainer, start: dict, names: dict):
    """(trained parameters that did not move, frozen ones that did), by name."""
    still, moved = [], []
    labels = getattr(trainer, "labels", {})
    for p in trainer.params:
        label = labels.get(names[id(p)], "trained")
        same = torch.equal(p.detach(), start[id(p)])
        if label == "frozen" and not same:
            moved.append(names[id(p)])
        elif label != "frozen" and same:
            still.append(names[id(p)])
    return still, moved


def _attention_f64(q, k, v, do=None, *, causal=False, kv_lens=None, q_offset=None,
                   kv_starts=None, scale=None):
    """Attention in f64 from the same q / k / v: an exact softmax over the
    valid keys (a fully-masked row gives 0).  Returns O (f64) and the LSE
    (f32, -1e30 on a fully-masked row); with dO, the gradients dq, dk, dv
    in q / k / v's dtypes from the f64 P and O (delta = sum_D dO * O in
    f64)."""
    from vla_rft_tpu_torch.ops.attention import NEG_INF, _valid

    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    qh, kd, vd = q.reshape(B, Sq, Hkv, G, D).double(), k.double(), v.double()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, kd) * scale
    s = s.masked_fill(~_valid(B, Sq, Sk, q.device, causal, kv_lens, q_offset, kv_starts),
                      float("-inf"))
    m = s.amax(-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(s - m)
    del s
    den = e.sum(-1, keepdim=True)
    p = e / den.clamp_min(1e-300)
    del e
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, vd)
    if do is None:
        lse = torch.where(den > 0, m + torch.log(den.clamp_min(1e-300)),
                          torch.full_like(m, NEG_INF))
        return o.reshape(B, Sq, Hq, D), lse.reshape(B, Hq, Sq).transpose(1, 2).float()
    dod = do.reshape(B, Sq, Hkv, G, D).double()
    delta = (dod * o).sum(-1).permute(0, 2, 3, 1)[..., None]
    ds = p * (torch.einsum("bqhgd,bkhd->bhgqk", dod, vd) - delta) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kd).reshape(B, Sq, Hq, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qh)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dod)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@contextlib.contextmanager
def _f64_route(attention):
    """The plain route (attn_impl "plain") with `_attention_f64` for its
    forward (O rounded to q's dtype, as every route hands it on) and its
    backward (recomputed in f64; the stored O and LSE unused)."""
    fwd, bwd = attention.attention_plain, attention.attention_bwd_plain

    def f64_fwd(q, k, v, return_lse=False, **kw):
        o, lse = _attention_f64(q, k, v, **kw)
        return (o.to(q.dtype), lse) if return_lse else o.to(q.dtype)

    attention.attention_plain = f64_fwd
    attention.attention_bwd_plain = lambda q, k, v, o, lse, do, **kw: _attention_f64(
        q, k, v, do, **kw)
    try:
        yield
    finally:
        attention.attention_plain, attention.attention_bwd_plain = fwd, bwd


@contextlib.contextmanager
def _f32_delta(attention):
    """Both backward routes with delta = sum_D dO * O taken from O in f32
    (recomputed by the plain twin from the same q / k / v) where they take
    the stored bf16 O: what an f32 O saved by the forward would give."""
    bwd, bwd_plain, plain = (attention.flash_bwd, attention.attention_bwd_plain,
                             attention.attention_plain)
    o32 = lambda q, k, v, kw: plain(q.float(), k.float(), v.float(), **kw)

    def kernel_bwd(q, k, v, o, lse, do, **kw):
        delta = (do.float() * o32(q, k, v, kw)).sum(dim=-1)
        dk, dv = attention.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return attention.flash_bwd_dq(q, k, v, do, lse, delta, **kw), dk, dv

    attention.flash_bwd = kernel_bwd
    attention.attention_bwd_plain = lambda q, k, v, o, lse, do, **kw: bwd_plain(
        q, k, v, o32(q, k, v, kw), lse, do, **kw)
    try:
        yield
    finally:
        attention.flash_bwd, attention.attention_bwd_plain = bwd, bwd_plain


def _kernel_vs_plain(attention, lm, loss_fn, backward, watch: dict, L: int,
                     f64: bool = False) -> dict:
    """loss_fn() and backward(loss) with `lm`'s attention on the kernels and
    then on the plain twins (same weights, same batch): the loss's relative
    error, the max|d| / max|g| of the gradients at the indices `watch`
    names, each route's launches and the watched gradients that are zero on
    the kernel route (`_require_agreement` holds them to the limits).  With
    `f64`, a third route through `_f64_route` and each route's loss and
    gradients against it (`_require_near_f64` holds them), and, reported
    only, both routes again under `_f32_delta` against it."""
    routes = {"auto": ("auto", None), "plain": ("plain", None)}
    if f64:
        routes.update({"f64": ("plain", _f64_route), "auto_f32_delta": ("auto", _f32_delta),
                       "plain_f32_delta": ("plain", _f32_delta)})
    paths = {}
    for route, (impl, patch) in routes.items():
        lm.attn_impl = impl
        try:
            with patch(attention) if patch else contextlib.nullcontext():
                before = _counts(attention)
                loss = loss_fn()
                grads = backward(loss)
                torch.cuda.synchronize()
            n = {k: v - before[k] for k, v in _counts(attention).items()}
            paths[route] = (loss.item(), {w: grads[i].float() for w, i in watch.items()}, n)
            del grads, loss
        finally:
            lm.attn_impl = "auto"
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    (lk, gk, nk), (lp, gp, np_) = paths["auto"], paths["plain"]
    out = {"loss": [lk, lp], "loss_rel_err": abs(lk - lp) / abs(lp),
           "grad_rel_err": {w: rel(gk[w], gp[w]) for w in watch},
           "zero_kernel_route_grads": [w for w in watch if gk[w].abs().max().item() == 0.0],
           "launches": {"kernel": nk, "plain": np_},
           "tolerance": {"loss_rel": SFT_LOSS_TOL, "grad_rel": SFT_GRAD_TOL}}
    if f64:
        lr, gr, _ = paths["f64"]
        g32k, g32p = paths["auto_f32_delta"][1], paths["plain_f32_delta"][1]
        out["f64"] = {
            "loss": lr, "loss_rel_err": {"kernel": abs(lk - lr) / abs(lr),
                                         "plain": abs(lp - lr) / abs(lr)},
            "grad_max": {w: gr[w].abs().max().item() for w in watch},
            "grad_rel_err": {w: {"kernel": rel(gk[w], gr[w]), "plain": rel(gp[w], gr[w])}
                             for w in watch},
            "tolerance": f"kernel <= {F64_ROUTE_RATIO} * plain + {SFT_GRAD_TOL} per gradient, "
                         f"loss <= {SFT_LOSS_TOL}",
            "f32_delta_grad_rel_err": {w: {"kernel": rel(g32k[w], gr[w]),
                                           "plain": rel(g32p[w], gr[w])} for w in watch}}
    return out


def _require_agreement(kvp: dict, L: int, what: str, fwd: int = 1) -> None:
    """Raise past SFT_LOSS_TOL / SFT_GRAD_TOL, on a zero kernel-route
    gradient, or on other launches than fwd x L / L / L (kernel route; fwd
    is 2 when the layers are recomputed in the backward) and 0 (plain
    route)."""
    n = kvp["launches"]
    if (n["kernel"] != {"flash_fwd": fwd * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
            or any(n["plain"].values()) or kvp["zero_kernel_route_grads"]
            or not kvp["loss_rel_err"] <= SFT_LOSS_TOL
            or not max(kvp["grad_rel_err"].values()) <= SFT_GRAD_TOL):
        raise AssertionError(f"{what}: kernel vs plain {kvp}")


def _require_near_f64(kvp: dict, L: int, what: str, fwd: int = 1) -> None:
    """Raise unless the kernel route launched fwd x L / L / L and the plain
    route nothing, the kernel route's loss is within SFT_LOSS_TOL of the
    f64 route's, and each watched gradient of the kernel route is within
    F64_ROUTE_RATIO times the plain route's distance (plus SFT_GRAD_TOL) of
    the f64 route's."""
    n, ref = kvp["launches"], kvp["f64"]
    far = {w: e for w, e in ref["grad_rel_err"].items()
           if not e["kernel"] <= F64_ROUTE_RATIO * e["plain"] + SFT_GRAD_TOL}
    if (n["kernel"] != {"flash_fwd": fwd * L, "flash_bwd_dq": L, "flash_bwd_dkv": L}
            or any(n["plain"].values()) or far
            or not ref["loss_rel_err"]["kernel"] <= SFT_LOSS_TOL):
        raise AssertionError(f"{what}: routes vs f64 attention, out of bounds {far}: {kvp}")


def _fwd_vs_f64(attention, fn) -> dict:
    """fn() with every #1 call's O and LSE checked against `_attention_f64`
    on the very same q, k, v (max|dO| <= BWD_RTOL * max|O_f64| + BWD_ATOL,
    max|dLSE| <= LSE_TOL); returns the largest max|dO| / max|O_f64| and
    max|dLSE| over the calls; raises past a bound or when fn made no
    call."""
    errs = []
    kernel = attention.flash_fwd

    def checked(q, k, v, **kw):
        o, lse = kernel(q, k, v, **kw)
        o_ref, lse_ref = _attention_f64(q, k, v, **kw)
        e, top = (o.double() - o_ref).abs().max().item(), o_ref.abs().max().item()
        e_lse = (lse - lse_ref).abs().max().item()
        if not (e <= BWD_RTOL * top + BWD_ATOL and e_lse <= LSE_TOL):
            raise AssertionError(f"flash forward vs f64 on a step's tensors: max|dO| {e} "
                                 f"(max|O| {top}), max|dLSE| {e_lse}")
        errs.append((e / top, e_lse))
        return o, lse

    attention.flash_fwd = checked
    try:
        fn()
    finally:
        attention.flash_fwd = kernel
    if not errs:
        raise AssertionError("no flash forward call to check")
    return {"calls": len(errs), "max_rel_err_o": max(e for e, _ in errs),
            "max_abs_err_lse": max(e for _, e in errs),
            "tolerance": f"max|dO| <= {BWD_RTOL} * max|O_f64| + {BWD_ATOL}, "
                         f"max|dLSE| <= {LSE_TOL}"}


def _bwd_vs_twin(attention, fn) -> dict:
    """fn() with every flash backward call (#2 and #3) checked against the
    backward twin on the very same q, k, v, O and LSE, under the flash_bwd
    phase's bound per gradient (max|d| <= BWD_RTOL * max|ref| + BWD_ATOL).
    A training step's dO is far below BWD_ATOL, so both run again on dO
    scaled by the power of two that brings max|dO| into [1, 2): exact in
    bf16, and the backward is linear in dO.  Returns the largest
    max|d| / max|ref| of dq, dk and dv over the calls; raises past the
    bound or when fn made no backward call."""
    errs = []
    kernel = attention.flash_bwd

    def checked(q, k, v, o, lse, do, **kw):
        scaled = do * 2.0 ** -torch.floor(torch.log2(do.float().abs().max())).item()
        got = kernel(q, k, v, o, lse, scaled, **kw)
        ref = attention.attention_bwd_plain(q, k, v, o, lse, scaled, **kw)
        row = []
        for g_name, g, r in zip(("dq", "dk", "dv"), got, ref):
            e, top = (g.float() - r.float()).abs().max().item(), r.float().abs().max().item()
            if not e <= BWD_RTOL * top + BWD_ATOL:
                raise AssertionError(f"flash backward vs twin on a step's tensors: max|d{g_name}| "
                                     f"{e} > {BWD_RTOL} * {top} + {BWD_ATOL}")
            row.append(e / top)
        errs.append(row)
        return kernel(q, k, v, o, lse, do, **kw)

    attention.flash_bwd = checked
    try:
        fn()
    finally:
        attention.flash_bwd = kernel
    if not errs:
        raise AssertionError("no flash backward call to check")
    return {"calls": len(errs),
            "max_rel_err": dict(zip(("dq", "dk", "dv"), np.max(errs, axis=0).tolist())),
            "tolerance": f"max|d| <= {BWD_RTOL} * max|ref| + {BWD_ATOL}, dO scaled into [1, 2)"}


def phase_sft_text(attention) -> dict:
    """sft.mode=text through main_sft.run at Qwen2.5-0.5B width: a parquet of
    SFT_TEXT_ROWS rows and a word-level tokenizer written here, 2 steps of
    B = SFT_TEXT_BATCH rows right-padded to 1663 tokens.  The kernel route
    is held against the plain route on step 1's weights and batch.  On
    step 1's and on the trained weights, both routes are held against a
    third whose attention is computed in f64 (`_require_near_f64`); after
    the steps, #1 against the f64 attention on every call of one forward
    and #2 / #3 against their twin on every call of one backward (the same
    tensors)."""
    import tempfile

    from sft_data import write_sft_parquet, write_word_tokenizer
    from transformers import AutoTokenizer

    from vla_rft_tpu_torch.trainer import main_sft
    from vla_rft_tpu_torch.trainer.sft_trainer import to_device

    root = tempfile.mkdtemp(prefix="sft_text_")
    try:
        parquet, tok_dir = os.path.join(root, "train.parquet"), os.path.join(root, "tokenizer")
        words = write_sft_parquet(parquet, SFT_TEXT_ROWS, SFT_TEXT_WORDS, 1000, seed=0)
        vocab = write_word_tokenizer(tok_dir, [" ".join(words)])
        argv = ["sft.mode=text", f"data.train_files={parquet}",
                f"actor_rollout_ref.model.ckpt_path={tok_dir}",
                f"data.train_batch_size={SFT_TEXT_BATCH}",
                f"trainer.total_training_steps={SFT_TEXT_STEPS}",
                f"actor_rollout_ref.actor.optim.lr={SFT_VLM_LR}"]
        # the run's batches, drawn again (the dataset's seed is fixed)
        data = main_sft.SFTParquetDataset(parquet, AutoTokenizer.from_pretrained(tok_dir),
                                          max_length=WM_SFT_LEN, batch_size=SFT_TEXT_BATCH)
        batches = [to_device(data.next_batch(), "cuda") for _ in range(SFT_TEXT_STEPS + 2)]
        routes = {}

        def watched(tr):
            L = tr.llm.cfg.num_layers
            idx = {n: i for i, (n, _) in enumerate(tr.llm.named_parameters())}
            return {w: idx[w] for w in [f"layers.{i}.self_attn.{x}_proj.weight"
                                        for i in [*range(0, L - 1, 6), L - 1] for x in "qkv"]
                    + ["embed_tokens.weight"]}

        def step1_routes(tr):  # step 1's weights and batch, before the main path
            routes["step1"] = _kernel_vs_plain(attention, tr.llm,
                                               lambda: tr.compute_loss(batches[0]),
                                               tr.backward, watched(tr), tr.llm.cfg.num_layers,
                                               f64=True)

        run, steps, start, _, peak = _drive_sft(attention, argv, before_steps=step1_routes)
        tr = run.trainer
        L = tr.llm.cfg.num_layers
        _require_agreement(routes["step1"], L, "sft_text step 1")
        _require_near_f64(routes["step1"], L, "sft_text step 1")
        _expect_launches("sft_text", steps, {"flash_fwd": L, "flash_bwd_dq": L,
                                             "flash_bwd_dkv": L})
        names = {id(p): n for n, p in tr.llm.named_parameters()}
        still, _ = _moved_and_frozen(tr, start, names)
        if still:
            raise AssertionError(f"sft_text: parameters that did not move {still[:5]} "
                                 f"({len(still)})")
        del start

        # the step's parts on the next batch (outside the main path)
        batch, data_ms = host_ms(lambda: to_device(data.next_batch(), "cuda"))
        loss, fwd_ms = host_ms(lambda: tr.compute_loss(batch))
        grads, bwd_ms = host_ms(lambda: tr.backward(loss))
        _, opt_ms = host_ms(lambda: tr.update(grads))
        del grads, loss, batch
        with torch.no_grad():
            fwd_f64 = _fwd_vs_f64(attention, lambda: tr.compute_loss(batches[-1]))
        same_tensors = _bwd_vs_twin(attention, lambda: tr.backward(tr.compute_loss(batches[-1])))
        routes["trained"] = _kernel_vs_plain(attention, tr.llm,
                                             lambda: tr.compute_loss(batches[-1]), tr.backward,
                                             watched(tr), L, f64=True)
        _require_near_f64(routes["trained"], L, "sft_text after the steps")
        out = {"phase": "sft_text", "model": "qwen25_0_5b", "vocab": tr.llm.cfg.vocab_size,
               "tokenizer_vocab": vocab, "rows_in_parquet": SFT_TEXT_ROWS,
               "batch": SFT_TEXT_BATCH, "seq_len": WM_SFT_LEN,
               "kv_lens_per_step": [b["attention_mask"].sum(-1).tolist()
                                    for b in batches[:SFT_TEXT_STEPS]],
               "steps": steps, "steady_step_ms": steps[-1]["ms"],
               "launches_total": {k: sum(s["launches"][k] for s in steps)
                                  for k in steps[0]["launches"]},
               "split_ms": {"data": data_ms, "forward": fwd_ms, "backward": bwd_ms,
                            "optimizer": opt_ms},
               "peak_mem_gib": peak, "parameters_moved": len(tr.params), "lr": SFT_VLM_LR,
               "kernel_vs_plain": routes["step1"], "fwd_vs_f64_after_steps": fwd_f64,
               "bwd_vs_twin_after_steps": same_tensors,
               "kernel_vs_plain_after_steps": routes["trained"],
               "cut": f"data.train_batch_size={SFT_TEXT_BATCH} (config 16): B x 1663 x "
                      f"151,936 f32 logits"}
        del run, tr, batches
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


def phase_sft_align(attention) -> dict:
    """sft.mode=vla_align through main_sft.run at the libero preset (B 16):
    2 steps of the chat JSON's align stage, 1 of its finetune stage, 1 of
    synthetic captions; only projector parameters move."""
    import tempfile

    from sft_data import write_chat_data, write_word_tokenizer

    from vla_rft_tpu_torch.data.caption import get_caption_dataset
    from vla_rft_tpu_torch.trainer.sft_trainer import to_device

    root = tempfile.mkdtemp(prefix="sft_align_")
    try:
        paths = write_chat_data(root, size=224)
        tok_dir = os.path.join(root, "tokenizer")
        vocab = write_word_tokenizer(tok_dir, paths["texts"])
        common = ["sft.mode=vla_align", f"actor_rollout_ref.model.path={tok_dir}",
                  f"sft.image_dir={paths['image_dir']}"]
        runs, kvp = {}, None
        for name, extra, n in (("align", [f"sft.chat_json={paths['align']}", "sft.stage=align"],
                                2),
                               ("finetune", [f"sft.chat_json={paths['finetune']}",
                                             "sft.stage=finetune"], 1),
                               ("synthetic", [], 1)):
            run, steps, start, _, peak = _drive_sft(
                attention, common + extra + [f"trainer.total_training_steps={n}"])
            tr, vla = run.trainer, run.bundle.vla
            L = vla.cfg.llm.num_layers
            _expect_launches(f"sft_align {name}", steps, {"flash_fwd": L, "flash_bwd_dq": L,
                                                          "flash_bwd_dkv": L})
            names = {id(p): n_ for n_, p in vla.named_parameters()}
            still, moved = _moved_and_frozen(tr, start, names)
            if still or moved:
                raise AssertionError(f"sft_align {name}: projector parameters that did not "
                                     f"move {still}; frozen ones that moved {moved[:5]}")
            del start
            runs[name] = {"steps": steps, "peak_mem_gib": peak,
                          "steady_step_ms": steps[-1]["ms"],
                          "trained": sorted(k for k, v in tr.labels.items() if v != "frozen"),
                          "frozen_parameters": sum(v == "frozen" for v in tr.labels.values())}
            if name == "align":  # kernel route vs plain route on the next align batch
                from transformers import AutoTokenizer

                tok = AutoTokenizer.from_pretrained(tok_dir)
                data = get_caption_dataset(
                    "align", json_path=paths["align"], image_dir=paths["image_dir"],
                    tokenizer=tok, image_size=run.bundle.policy_image_size, batch_size=16,
                    seq_len=run.bundle.policy_seq_len, pad_token_id=tok.pad_token_id or 0)
                for _ in range(n):
                    data.next_batch()
                b = data.next_batch()
                batch = to_device({k: b[k] for k in ("input_ids", "pixel_values",
                                                     "attention_mask", "labels")}, "cuda")
                runs[name]["kv_lens_next_batch"] = b["attention_mask"].sum(-1).tolist()
                idx = {names[id(p)]: i for i, p in enumerate(tr.params)}
                watch = {w: idx[w] for w in (f"projector.fc{i}.{x}" for i in (1, 2, 3)
                                             for x in ("weight", "bias"))}
                kvp = _kernel_vs_plain(attention, vla.language_model,
                                       lambda: tr.compute_loss(batch), tr.backward, watch, L)
                _require_agreement(kvp, L, "sft_align")
                del batch
            del run, tr, vla
            gc.collect()
            torch.cuda.empty_cache()
        norms = [s["grad_norm"] for r in runs.values() for s in r["steps"]]
        if not any(n_ >= 1.0 for n_ in norms) or not np.isfinite(norms).all():
            raise AssertionError(f"sft_align: no step clipped (grad_clip 1.0): norms {norms}")
        out = {"phase": "sft_align", "preset": "libero", "batch": 16, "tokenizer_vocab": vocab,
               "runs": runs, "grad_norms": norms, "grad_clip": 1.0,
               "steps_clipped": sum(n_ >= 1.0 for n_ in norms), "kernel_vs_plain": kvp,
               "launches_total": {k: sum(s["launches"][k] for r in runs.values()
                                         for s in r["steps"]) for k in _counts(attention)}}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit(out)
    return out


# text_gen: trainer/main_generation.run at the config's own sizes: 16 prompts
# (data.train_batch_size) of up to data.max_prompt_length = 1095 tokens, n =
# 16 rollouts each (256 rows), rollout.response_length = 568, on a seeded
# random Qwen2.5-0.5B checkpoint and a word-level tokenizer of its 151,936
# ids, both written here.  Prompt word counts spread over 146..1091 (the
# chat template adds 4 tokens: 150..1095 tokens, so kv_starts reach 945 of
# 1095), plus one row of 1400 words that RLHFDataset filters out.
TEXT_PROMPT, TEXT_R, TEXT_N, TEXT_PROMPTS, TEXT_VOCAB = 1095, 568, 16, 16, 151936
TEXT_WORDS = [int(x) for x in np.linspace(146, 1091, TEXT_PROMPTS)] + [1400]
# kernel vs plain route (and shared vs unshared cache): max|d logits| /
# max|logits| of one call after 24 bf16 layers, as every phase; a log-prob
# or an entropy moves at most twice the largest change of its logits, so
# theirs are held to 2 * TEXT_LOGIT_TOL * max|logits| over the response, and
# the same log-probs with kv_starts dropped must fall outside that bound
TEXT_LOGIT_TOL = 5e-2
TEXT_PROFILE_FROM, TEXT_PROFILE_CALLS = 100, 16  # the profiled window of decode calls
# the greedy comparisons (kernel vs plain route at 16 rows, the unshared
# reference of the shared route at 256 rows) stop after this many steps:
# each eager decode call takes some 40 ms of host time, and the first
# differing token falls inside it (PERF.md section 6, text generation)
TEXT_R_CMP = 64
TEXT_MID = 284  # the decode step the kernels are timed at (half of R)


def _all_counts(mods, fda) -> dict:
    """Every kernel's launch count: a WM call's (`_decode_counts`), the flash
    backward's and #10's."""
    attention = mods[0]
    return {**_decode_counts(mods), "flash_bwd_dq": attention.bwd_dq_launches,
            "flash_bwd_dkv": attention.bwd_dkv_launches, "fused_decode_attention": fda.launches}


def _zero_all_counts(mods, fda) -> None:
    _zero_decode_counts(mods)
    mods[0].bwd_dq_launches = mods[0].bwd_dkv_launches = fda.launches = 0


def _text_expect(**nonzero) -> dict:
    return {**_expect(), "flash_bwd_dq": 0, "flash_bwd_dkv": 0, "fused_decode_attention": 0,
            **nonzero}


def _first_diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Where two (rows, R) token tensors first differ: the earliest differing
    step over the rows (R where none), and the rows equal throughout."""
    R = a.shape[1]
    ne = (a != b).int()
    first = torch.where(ne.any(dim=1), ne.argmax(dim=1), torch.full_like(ne[:, 0], R))
    return {"first_differing_step": int(first.min()), "rows_equal": int((first == R).sum()),
            "rows": int(a.shape[0])}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max|a - b| / max|b|."""
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


def decode_work(q, row_keys: int, read_keys: int, Hkv: int, elem: int = 2):
    """(bytes, flops) of a decode call on these inputs: q read and O written
    once, each distinct valid cache position read once (K and V, `elem`
    bytes each); 4*D flops per query position, head and valid key
    (`row_keys`: valid keys summed over the rows)."""
    B, Sq, Hq, D = q.shape
    return 2 * 2 * B * Sq * Hq * D + 2 * read_keys * Hkv * D * elem, 4 * D * Hq * Sq * row_keys


def _library_ms(fn) -> dict:
    """{"library_ms": graph-replayed ms of fn}."""
    return {"library_ms": graph_ms(fn, 3, 2)}


def _masked_sdpa(q, k, v, valid):
    """scaled_dot_product_attention of (B, Sq, Hq, D) q over (B, Sk, Hkv, D)
    K/V as they lie (head-major views, no copy) with a boolean (B, 1, Sq,
    Sk) mask and enable_gqa, as a closure: a yardstick only, the port never
    calls it."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid, enable_gqa=True)


def _time_text_kernels(attention, dec, starts16: torch.Tensor) -> dict:
    """#1 at the text prefill (256 rows of 1095 queries into a 1664-key
    cache, causal, kv_starts the batch's pad counts) and at compute_log_probs
    (16 rows of 1663, causal, kv_starts and the valid lengths of a greedy
    batch), #5 at 256 rows and #4 at 256 rows over 16 prefixes, both at
    decode step TEXT_MID (kv_lens 1095 + 285), bf16 'hd' caches, 14/2 heads
    of 64.  Each is held against its twin (#1 at the prefill on 16-row
    slices, whose twin would not fit in one call), called three times for
    the same bits, timed from a CUDA-graph replay beside its twin and a
    masked scaled_dot_product_attention, with its bound."""
    from vla_rft_tpu_torch.ops.attention import _valid

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    P, R, D, Hq, Hkv = TEXT_PROMPT, TEXT_R, 64, 14, 2
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev).bfloat16()
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32, device=dev)
    out = {}

    def flash_case(key, B, Sq, Sk, kv_lens, kv_starts, slice_rows):
        q, k, v = rnd(B, Sq, Hq, D), rnd(B, Sk, Hkv, D), rnd(B, Sk, Hkv, D)
        rows = {"kv_lens": kv_lens, "kv_starts": kv_starts, "q_offset": i32([0] * B)}
        kern = lambda: attention.flash_fwd(q, k, v, causal=True, **rows)
        cut = lambda i: {a: x[i:i + slice_rows] for a, x in rows.items()}
        twin_part = lambda i: attention.attention_plain(q[i:i + slice_rows], k[i:i + slice_rows],
                                                        v[i:i + slice_rows], causal=True,
                                                        return_lse=True, **cut(i))
        o, lse = kern()
        e_o = e_l = 0.0
        for i in range(0, B, slice_rows):
            o_ref, lse_ref = twin_part(i)
            e_o = max(e_o, (o[i:i + slice_rows].float() - o_ref.float()).abs().max().item())
            valid = lse_ref > attention.NEG_INF  # rows with a valid key (not left pads)
            e_l = max(e_l, (lse[i:i + slice_rows] - lse_ref)[valid].abs().max().item())
            dead = o[i:i + slice_rows][~valid].float().abs().max().item() if (~valid).any() else 0
            if dead != 0.0 or not bool((lse[i:i + slice_rows][~valid] == attention.NEG_INF).all()):
                raise AssertionError(f"{key}: left-pad queries not 0 / -1e30 ({dead})")
            del o_ref, lse_ref
        if not (e_o <= O_TOL and e_l <= LSE_TOL and torch.isfinite(o.float()).all()):
            raise AssertionError(f"flash at {key}: max|dO|={e_o} max|dLSE|={e_l}")
        del o, lse
        if not repeats_bit_for_bit(kern):
            raise AssertionError(f"flash at {key}: three calls gave different bits")
        mask = _valid(B, Sq, Sk, dev, True, kv_lens, None, kv_starts)[:, 0]  # (B, 1, Sq, Sk)
        twin_all = lambda: [twin_part(i) for i in range(0, B, slice_rows)]
        t = {"B": B, "Sq": Sq, "Sk": Sk, "Hq": Hq, "Hkv": Hkv, "D": D, "causal": True,
             "kv_starts": kv_starts.tolist()[:: max(1, B // 16)], "max_abs_err_o": e_o,
             "max_abs_err_lse": e_l, "repeats_bit_for_bit": True,
             "kernel_ms": graph_ms(kern), "eager_ms": cuda_ms(kern, 10),
             "plain_ms": graph_ms(twin_all, 2, 2),
             "plain_rows_per_call": slice_rows, **_library_ms(_masked_sdpa(q, k, v, mask)),
             **bound(*flash_work(q, k, kv_lens, kv_starts, rows["q_offset"], True))}
        del q, k, v, mask
        torch.cuda.empty_cache()
        return t

    starts256 = starts16.repeat_interleave(TEXT_N)
    out["text_prefill"] = flash_case("text_prefill", 256, P, 1664, i32([P] * 256), starts256, 16)
    lens16 = (P + torch.linspace(R // 4, R, 16, device=dev)).to(torch.int32)  # ragged EOS
    out["text_logprob"] = flash_case("text_logprob", 16, P + R, P + R, lens16, starts16, 16)
    # the reference policies' log-prob chunks (ref.log_prob_micro_batch_size_per_gpu)
    out["text_logprob_b8"] = flash_case("text_logprob_b8", 8, P + R, P + R,
                                        lens16[::2].contiguous(), starts16[::2].contiguous(), 8)

    # the decode kernels at step TEXT_MID: keys [kv_starts, P + TEXT_MID]
    L = P + TEXT_MID + 1
    B = 256
    q = rnd(B, 1, Hq, D)
    kv_lens, q_off = i32([L] * B), i32([L - 1] * B)
    ck, cv = rnd(B, 1664, Hkv * D), rnd(B, 1664, Hkv * D)
    kw = dict(kv_lens=kv_lens, q_offset=q_off, kv_starts=starts256)
    cases = {"text_b256": (lambda: dec.decode_kernel(q, ck, cv, **kw),
                           lambda: dec.decode_plain(q, ck, cv, **kw),
                           dec.dequantize(ck, None, D, torch.bfloat16),
                           dec.dequantize(cv, None, D, torch.bfloat16), starts256,
                           int((L - starts256).sum()), int((L - starts256).sum()))}
    sck, scv = rnd(16, 1096, Hkv * D), rnd(16, 1096, Hkv * D)
    own_k, own_v = rnd(B, R, Hkv * D), rnd(B, R, Hkv * D)
    pm = torch.arange(16, dtype=torch.int32, device=dev).repeat_interleave(TEXT_N)
    skw = dict(shared_len=P, kv_lens=kv_lens, q_offset=q_off, shared_starts=starts256)
    k_all, v_all = dec.shared_kv(own_k, own_v, sck, scv, pm, P, D, torch.bfloat16)
    cases["text_shared_b256"] = (
        lambda: dec.decode_shared_kernel(q, own_k, own_v, sck, scv, pm, **skw),
        lambda: dec.decode_shared_plain(q, own_k, own_v, sck, scv, pm, **skw),
        k_all, v_all, starts256, int((L - starts256).sum()),
        int((P - starts16).sum()) + B * (TEXT_MID + 1))
    for key, (kern, twin, k_all, v_all, starts, row_keys, read_keys) in cases.items():
        o, ref = kern(), twin().float()
        if not bool(((o.float() - ref).abs() <= DEC_RTOL * ref.abs() + DEC_ATOL).all()):
            raise AssertionError(f"decode at {key}: max|dO| {(o.float() - ref).abs().max()}")
        if not repeats_bit_for_bit(kern):
            raise AssertionError(f"decode at {key}: three calls gave different bits")
        mask = _valid(B, 1, k_all.shape[1], dev, True, kv_lens, q_off, starts)[:, 0]
        out[key] = {"B": B, "Sq": 1, "Hq": Hq, "Hkv": Hkv, "D": D, "cache": "bf16 hd",
                    "kv_len": L, "step": TEXT_MID, "max_abs_err": (o.float() - ref).abs().max()
                    .item(), "repeats_bit_for_bit": True, "kernel_ms": graph_ms(kern),
                    "eager_ms": cuda_ms(kern, 100), "plain_ms": graph_ms(twin, 10),
                    **_library_ms(_masked_sdpa(q, k_all, v_all, mask)),
                    **bound(*decode_work(q, row_keys, read_keys, Hkv))}
        if key == "text_shared_b256":
            out[key]["prefixes"] = 16
        del o, ref, mask
    del q, ck, cv, sck, scv, own_k, own_v, k_all, v_all, cases
    torch.cuda.empty_cache()
    return out


def write_text_inputs(root: str) -> tuple:
    """The text phases' inputs under `root`: a seeded random Qwen2.5-0.5B
    checkpoint under HF names and a word-level chat tokenizer of its 151,936
    ids in `root`/qwen, and the gsm8k-style prompt parquet of TEXT_WORDS.
    Returns (checkpoint dir, parquet, the written state dict on the host,
    the tokenizer's vocabulary, checkpoint bytes, seconds)."""
    from sft_data import write_chat_tokenizer, write_rlhf_parquet

    from vla_rft_tpu_torch.models.factory import build_decoder
    from vla_rft_tpu_torch.models.transformer import TransformerConfig

    t0 = time.perf_counter()
    ckpt = os.path.join(root, "qwen")
    os.makedirs(ckpt)
    vocab = write_chat_tokenizer(ckpt, TEXT_VOCAB)
    prompts = os.path.join(root, "prompts.parquet")
    write_rlhf_parquet(prompts, TEXT_WORDS, TEXT_VOCAB - 8, seed=0)
    model = build_decoder(TransformerConfig.qwen25_0_5b(), device="cuda", seed=18)
    written = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    ckpt_bytes = write_safetensors(os.path.join(ckpt, "model.safetensors"),
                                   hf_decoder_names(written))
    return ckpt, prompts, written, vocab, ckpt_bytes, time.perf_counter() - t0


def phase_text_gen(mods, fda) -> dict:
    """Text generation at Qwen2.5-0.5B width through main_generation.run,
    the kernel route against the plain route, prefix sharing, the log-probs
    and main_eval's scorers (module docstring, phase text_gen)."""
    import tempfile

    import pandas as pd
    from transformers import AutoTokenizer

    from vla_rft_tpu_torch.data.rlhf_dataset import RLHFDataset
    from vla_rft_tpu_torch.serving.profile_request import _busy_us
    from vla_rft_tpu_torch.trainer import main_eval, main_generation
    from vla_rft_tpu_torch.workers.llm_rollout import (LLMRolloutConfig, compute_log_probs,
                                                       generate_sequences)

    attention, dec = mods[0], mods[1]
    L_layers = 24
    root = tempfile.mkdtemp(prefix="text_gen_")
    try:
        # ---------------------------------------------------------- inputs
        ckpt, prompts, written, vocab, ckpt_bytes, inputs_s = write_text_inputs(root)

        # the tokenizer through the card's transformers: chat ids are ids
        tok = AutoTokenizer.from_pretrained(ckpt)
        pad = tok.pad_token_id or 0
        ds = RLHFDataset(prompts, tok, max_prompt_length=TEXT_PROMPT, pad_token_id=pad)
        raw = tok.apply_chat_template(list(ds._rows[0][1]["prompt"]), add_generation_prompt=True)
        for ids, row in ds._rows:
            text = tok.apply_chat_template(list(row["prompt"]), tokenize=False,
                                           add_generation_prompt=True)
            if ids != tok.encode(text, add_special_tokens=False):
                raise AssertionError("text_gen: RLHFDataset's chat ids are not the template's")
        lens = sorted(len(ids) for ids, _ in ds._rows)
        if len(ds) != TEXT_PROMPTS or lens[-1] != TEXT_PROMPT or len(ds.df) != TEXT_PROMPTS + 1:
            raise AssertionError(f"text_gen: {len(ds)} prompts of {lens[0]}..{lens[-1]} tokens")
        batch = ds.sample_batch(TEXT_PROMPTS)  # main_generation's draw (same seed)
        ids16 = torch.as_tensor(batch["input_ids"], device="cuda")
        starts16 = (ids16 == pad).sum(dim=1).to(torch.int32)

        # ------------------------------------------------------- main path
        out_parquet = os.path.join(root, "generations.parquet")
        argv = [f"actor_rollout_ref.model.ckpt_path={ckpt}", f"data.train_files={prompts}",
                f"data.output_path={out_parquet}"]
        calls, state, batches, profs = [], {}, [], []

        def pre(_mod, args, _kw):
            S = args[0].shape[1]
            n_dec = sum(1 for c in calls if c[0] == 1)
            if S == 1 and n_dec in (TEXT_PROFILE_FROM, TEXT_PROFILE_FROM + TEXT_PROFILE_CALLS):
                torch.cuda.synchronize()
                if n_dec == TEXT_PROFILE_FROM:
                    profs.append(torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]))
                    profs[0].start()
                    state["prof_t0"] = time.perf_counter()
                else:
                    state["prof_wall_us"] = (time.perf_counter() - state["prof_t0"]) * 1e6
                    profs[0].stop()
            if not calls:
                state["gen_t0"] = time.perf_counter()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            calls.append([S, ev, None])

        def post(_mod, _args, _kw, _out):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            calls[-1][2] = ev

        # main_generation's own calls, wrapped: the loaded model and each
        # batch's generate_sequences output
        load, generate = main_generation.load_decoder, main_generation.generate_sequences

        def load_decoder(*a):
            llm = state["llm"] = load(*a)
            state["loaded_bit_equal"] = all(torch.equal(v.cpu(), written[k])
                                            for k, v in llm.state_dict().items())
            state["hooks"] = [llm.register_forward_pre_hook(pre, with_kwargs=True),
                              llm.register_forward_hook(post, with_kwargs=True)]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_all_counts(mods, fda)  # the main path starts here
            return llm

        def generate_sequences_(*a, **kw):
            out = generate(*a, **kw)
            torch.cuda.synchronize()
            batches.append({"launches": _all_counts(mods, fda),
                            "generate_s": time.perf_counter() - state["gen_t0"],
                            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                            "responses": out["responses"].cpu(),
                            "response_mask": out["response_mask"].cpu(),
                            # one row per prompt, for compute_log_probs
                            "seqs": {k: out[k][::TEXT_N].clone() for k in
                                     ("input_ids", "attention_mask", "position_ids",
                                      "response_mask")}})
            _zero_all_counts(mods, fda)
            return out

        main_generation.load_decoder = load_decoder
        main_generation.generate_sequences = generate_sequences_
        try:
            t0 = time.perf_counter()
            main_generation.run(argv)
            run_s = time.perf_counter() - t0
        finally:
            main_generation.load_decoder, main_generation.generate_sequences = load, generate
        for h in state.pop("hooks"):
            h.remove()
        llm = state.pop("llm")
        if not state["loaded_bit_equal"]:
            raise AssertionError("text_gen: the loaded weights are not the written ones")
        rows = TEXT_PROMPTS * TEXT_N
        expect = _text_expect(flash_fwd=L_layers, decode_hd=L_layers * TEXT_R)
        if len(batches) != 1 or batches[0]["launches"] != expect:
            raise AssertionError(f"text_gen: launches {[b['launches'] for b in batches]}, "
                                 f"expected one batch of {expect}")
        b0 = batches[0]
        resp = b0["responses"]
        if resp.shape != (rows, TEXT_R) or int(resp.min()) < 0 or int(resp.max()) >= vocab:
            raise AssertionError(f"text_gen: responses {tuple(resp.shape)} "
                                 f"ids {int(resp.min())}..{int(resp.max())}")
        if None in tok.convert_ids_to_tokens(resp.flatten().tolist()):
            raise AssertionError("text_gen: a generated id has no word")
        written_df = pd.read_parquet(out_parquet)
        responses = list(written_df["response"])
        if list(written_df.columns) != ["response"] or len(responses) != rows:
            raise AssertionError(f"text_gen: the parquet is {written_df.shape}, "
                                 f"columns {list(written_df.columns)}")
        for i, k in enumerate(b0["response_mask"].sum(dim=1).tolist()):  # every row, decoded
            want = tok.decode(resp[i, :k].tolist())
            if responses[i] != want:
                raise AssertionError(f"text_gen: parquet row {i} is {responses[i][:200]!r}, "
                                     f"its {k} generated ids decode to {want[:200]!r}")
        torch.cuda.synchronize()
        ms = [calls[i][1].elapsed_time(calls[i][2]) for i in range(len(calls))]
        cadence = [calls[i][1].elapsed_time(calls[i + 1][1]) for i in range(1, len(calls) - 1)]
        kernels = [e for e in profs[0].events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = _busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
        dec_us = sum(e.time_range.end - e.time_range.start for e in kernels
                     if "decode_attend_kernel" in e.name)
        valid_tokens = int(b0["response_mask"].sum())
        main_path = {
            "rows": rows, "prompts": TEXT_PROMPTS, "n": TEXT_N, "response_length": TEXT_R,
            "prompt_tokens": {"min": lens[0], "max": lens[-1]},
            "kv_starts": starts16.tolist(), "launches": b0["launches"],
            "prefill_ms": ms[0], "decode_call_ms_median": float(np.median(ms[1:])),
            "decode_ms_per_step_median": float(np.median(cadence)),
            "generate_s": b0["generate_s"],
            "generated_tokens_per_s": rows * TEXT_R / b0["generate_s"],
            "valid_tokens": valid_tokens, "peak_mem_gib": b0["peak_mem_gib"],
            "run_s": run_s, "inputs_s": inputs_s, "checkpoint_bytes": ckpt_bytes,
            "decode_step_trace": {
                "calls": TEXT_PROFILE_CALLS, "from_call": TEXT_PROFILE_FROM,
                "wall_ms_per_call": state["prof_wall_us"] / 1e3 / TEXT_PROFILE_CALLS,
                "device_busy_ms_per_call": busy / 1e3 / TEXT_PROFILE_CALLS,
                "device_idle_share": 1.0 - busy / state["prof_wall_us"],
                "kernels_per_call": len(kernels) / TEXT_PROFILE_CALLS,
                "decode_kernel_ms_per_launch": dec_us / 1e3 / max(1, sum(
                    1 for e in kernels if "decode_attend_kernel" in e.name))}}
        del calls, profs
        torch.cuda.empty_cache()

        # ------------------------------------------- kernel vs plain route
        greedy = lambda R: LLMRolloutConfig(response_length=R, do_sample=False, pad_token_id=pad,
                                            eos_token_id=tok.eos_token_id)
        gen = torch.Generator(device="cuda").manual_seed(0)
        routes = {}
        for impl in ("auto", "plain"):
            llm.attn_impl = impl
            grab = {}

            def prefill(_mod, args, _kw, out, grab=grab):  # the first call: the prefill
                if "logits" not in grab:
                    grab["logits"] = out[0][:, -1].float().clone()

            h = llm.register_forward_hook(prefill, with_kwargs=True)
            t = time.perf_counter()
            seqs = generate_sequences(llm, gen, ids16, greedy(TEXT_R_CMP))
            torch.cuda.synchronize()
            routes[impl] = {"logits": grab["logits"], "seqs": seqs, "s": time.perf_counter() - t}
            h.remove()
        # the log-probs of the main path's sequences (one row per prompt,
        # 1095 + 568 tokens) on both routes
        k_seq = b0.pop("seqs")
        args = (k_seq["input_ids"], k_seq["attention_mask"], k_seq["position_ids"], TEXT_R)
        logp = {}
        for impl in ("auto", "plain"):
            llm.attn_impl = impl
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_all_counts(mods, fda)
            (lp, ent), lp_ms = host_ms(lambda: compute_log_probs(llm, *args))
            logp[impl] = {"lp": lp, "ent": ent, "ms": lp_ms, "launches": _all_counts(mods, fda),
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        llm.attn_impl = "auto"
        if logp["auto"]["launches"] != _text_expect(flash_fwd=L_layers):
            raise AssertionError(f"text_gen: compute_log_probs launched {logp['auto']['launches']}")
        with torch.no_grad():  # max|logit| over the response positions (one row at a time)
            starts = (1 - k_seq["attention_mask"][:, :TEXT_PROMPT]).sum(dim=1).to(torch.int32)
            _, hidden = llm(k_seq["input_ids"], positions=k_seq["position_ids"],
                            kv_starts=starts, kv_lens=k_seq["attention_mask"].sum(dim=1).int()
                            + starts, compute_logits=False)
            max_logit = max(llm.logits(hidden[i:i + 1, -TEXT_R - 1:-1]).abs().max().item()
                            for i in range(hidden.shape[0]))
            del hidden
        mask = k_seq["response_mask"].bool()
        d_lp = (logp["auto"]["lp"] - logp["plain"]["lp"]).abs()[mask]
        d_ent = (logp["auto"]["ent"] - logp["plain"]["ent"]).abs()[mask]
        lp_bound = 2 * TEXT_LOGIT_TOL * max_logit
        # a faulted reading the bound must catch: the kernel route with
        # kv_starts dropped (the prompts' pad keys unmasked, kv_lens as before)
        no_starts = k_seq["attention_mask"].clone()
        no_starts[:, :TEXT_PROMPT] = 1
        lp_fault, _ = compute_log_probs(llm, k_seq["input_ids"], no_starts,
                                        k_seq["position_ids"], TEXT_R)
        d_fault = (lp_fault - logp["auto"]["lp"]).abs()[mask].max().item()
        del lp_fault, no_starts
        prefill_rel = _rel(routes["auto"]["logits"], routes["plain"]["logits"])
        if not d_fault > lp_bound:
            raise AssertionError(f"text_gen: log-probs with kv_starts dropped move {d_fault}, "
                                 f"inside the bound {lp_bound}")
        if not (prefill_rel <= TEXT_LOGIT_TOL and d_lp.max().item() <= lp_bound
                and d_ent.max().item() <= lp_bound
                and torch.isfinite(logp["auto"]["lp"]).all()):
            raise AssertionError(f"text_gen kernel vs plain: prefill {prefill_rel}, logp "
                                 f"{d_lp.max().item()}, entropy {d_ent.max().item()} "
                                 f"(bound {lp_bound})")
        kernel_vs_plain = {
            "rows": TEXT_PROMPTS, "greedy": True, "prefill_rel_logit_err": prefill_rel,
            "prefill_argmax_agreement": (routes["auto"]["logits"].argmax(-1)
                                         == routes["plain"]["logits"].argmax(-1))
            .float().mean().item(),
            "steps": TEXT_R_CMP,
            "tokens": _first_diff(routes["auto"]["seqs"]["responses"],
                                  routes["plain"]["seqs"]["responses"]),
            "generate_s": {k: v["s"] for k, v in routes.items()},
            "log_probs": {"max_abs_err": d_lp.max().item(), "mean_abs_err": d_lp.mean().item(),
                          "entropy_max_abs_err": d_ent.max().item(), "bound": lp_bound,
                          "kv_starts_dropped_max_abs_err": d_fault,
                          "max_abs_logit": max_logit, "valid_tokens": int(mask.sum())}}
        log_probs = {"B": TEXT_PROMPTS, "S": TEXT_PROMPT + TEXT_R,
                     "launches": logp["auto"]["launches"], "ms": logp["auto"]["ms"],
                     "plain_route_ms": logp["plain"]["ms"],
                     "peak_mem_gib": logp["auto"]["peak_mem_gib"],
                     "plain_route_peak_mem_gib": logp["plain"]["peak_mem_gib"]}
        cmp_tokens = routes["auto"]["seqs"]["responses"]
        del routes, logp, args
        torch.cuda.empty_cache()

        # ------------------------------------ shared prefix vs one cache a row
        ids256 = ids16.repeat_interleave(TEXT_N, dim=0)
        shared_runs = {}
        # both for TEXT_R_CMP steps, as far as the comparisons read
        for name, n in (("unshared", 1), ("shared", TEXT_N)):
            grab = {}

            def first_decode(_mod, args, _kw, out, grab=grab):
                if args[0].shape[1] == 1 and "logits" not in grab:
                    grab["logits"] = out[0][:, 0].float().clone()

            h = llm.register_forward_hook(first_decode, with_kwargs=True)
            torch.cuda.synchronize()
            _zero_all_counts(mods, fda)
            t = time.perf_counter()
            seqs = generate_sequences(llm, gen, ids256, greedy(TEXT_R_CMP), prefix_share_n=n)
            torch.cuda.synchronize()
            shared_runs[name] = {"s": time.perf_counter() - t, "launches": _all_counts(mods, fda),
                                 "responses": seqs["responses"], "logits": grab["logits"]}
            h.remove()
            del seqs
        sh, un = shared_runs["shared"], shared_runs["unshared"]
        if sh["launches"] != _text_expect(flash_fwd=L_layers,
                                          decode_shared_hd=L_layers * TEXT_R_CMP) \
                or un["launches"] != _text_expect(flash_fwd=L_layers,
                                                  decode_hd=L_layers * TEXT_R_CMP):
            raise AssertionError(f"text_gen shared: launches {sh['launches']} / {un['launches']}")
        same0 = sh["responses"][:, 0] == un["responses"][:, 0]  # step 0's logits see this token
        step0_rel = _rel(sh["logits"][same0], un["logits"][same0])
        if step0_rel > TEXT_LOGIT_TOL or int(same0.sum()) == 0:
            raise AssertionError(f"text_gen shared: step-0 logits {step0_rel}")
        shared = {"rows": rows, "prefixes": TEXT_PROMPTS, "launches": sh["launches"],
                  "generate_s": sh["s"], "unshared_generate_s": un["s"],
                  "step0_rel_logit_err": step0_rel, "step0_rows_compared": int(same0.sum()),
                  "unshared_steps": TEXT_R_CMP,
                  "tokens_vs_unshared": _first_diff(sh["responses"][:, :TEXT_R_CMP],
                                                    un["responses"]),
                  "tokens_vs_16_row_kernel_route": _first_diff(
                      sh["responses"][::TEXT_N, :TEXT_R_CMP],
                      cmp_tokens)}
        del shared_runs, sh, un, k_seq
        torch.cuda.empty_cache()

        # ------------------------------------------------- main_eval's scorers
        code = "```python\na, b = map(int, input().split())\nprint(a + b)\n```"
        cases = json.dumps({"inputs": ["1 2\n", "5 7\n"], "outputs": ["3\n", "12\n"]})
        eval_rows = {"prompt": [], "data_source": [], "reward_model": [], "responses": []}
        for i in range(TEXT_PROMPTS):  # the generations, n per prompt
            eval_rows["prompt"].append(f"prompt {i}")
            eval_rows["data_source"].append(batch["data_sources"][i])
            eval_rows["reward_model"].append({"ground_truth": batch["ground_truths"][i]})
            eval_rows["responses"].append(responses[i * TEXT_N:(i + 1) * TEXT_N])
        crafted = [("gsm8k", "17", ["w5 w9 #### 17", "#### 18"]),
                   ("numina_cn_k12", "(x+1)^2", ["so \\boxed{x^2+2x+1}"]),
                   ("apps", cases, [code]),
                   ("codeforces", cases, [code.replace("a + b", "a * b")])]
        for src, gt, responses in crafted:
            eval_rows["prompt"].append(src)
            eval_rows["data_source"].append(src)
            eval_rows["reward_model"].append({"ground_truth": gt})
            eval_rows["responses"].append(responses)
        eval_path = os.path.join(root, "eval.parquet")
        pd.DataFrame(eval_rows).to_parquet(eval_path)
        scores, eval_ms = host_ms(lambda: main_eval.evaluate_parquet(eval_path))
        want = {"test_score/gsm8k/pass@1": 0.5, "test_score/gsm8k/best@n": 1.0,
                "test_score/numina_cn_k12/pass@1": 1.0, "test_score/apps/pass@1": 1.0,
                "test_score/codeforces/pass@1": 0.0,
                f"test_score/{batch['data_sources'][0]}/count": TEXT_PROMPTS}
        if any(scores.get(k) != v for k, v in want.items()):
            raise AssertionError(f"text_gen main_eval: {scores}, expected {want}")

        timed = _time_text_kernels(attention, dec, starts16)
        out = {"phase": "text_gen", "model": "qwen25_0_5b", "vocab": vocab,
               "chat_template_returns": type(raw).__name__, "main_generation": main_path,
               "kernel_vs_plain": kernel_vs_plain, "compute_log_probs": log_probs,
               "prefix_shared": shared, "main_eval": {"scores": scores, "ms": eval_ms},
               "timed": timed, "tolerance": {"logits": TEXT_LOGIT_TOL,
                                             "log_probs": "2 * logits tol * max|logit|"}}
        del llm
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


# ppo: trainer/main_ppo.run at the config's sizes on text_gen's inputs: one
# grpo step of 16 prompts x n = 16 = 256 rows, responses of 568, 16 actor
# updates of 16 rows, old log-probs in chunks of 16 rows and the reference
# policy's in chunks of 8 (rollout. / ref.log_prob_micro_batch_size_per_gpu),
# then validate() (data.val_batch_size 4 x val_kwargs.n 1); and one gae step
# of PPO_GAE_PROMPTS prompts x 16 (the cut: 16 would double the phase's
# time) at PPO_RAISED_LR for the actor and the critic, so that every bf16
# parameter moves (the config's 1e-6 is below half a bf16 ulp of most
# weights; the main step reports how many moved at 1e-6).  Both run with
# actor_rollout_ref.model.enable_gradient_checkpointing (the decoder's
# remat): without it the 16-row update needs more than the card's 80 GB
# (PERF.md section 6, text RL)
PPO_GAE_PROMPTS, PPO_RAISED_LR = 2, 5e-3
# the cut steps (gae, the value-head RM, PRIME's dpo branch) generate a
# quarter of the config's 568 tokens: their decode loop is host-paced, so
# its time follows the response length, not the rows
TEXT_R_CUT = 142
PPO_KL_TOL = 1e-6  # on-policy identity: first mini-batch ppo_kl, ref vs old log-probs


def _ppo_expect(prompts: int, config, critic: bool, validate: bool, ranks: int = 1) -> dict:
    """Launches of one PPO step (or validate()) derived from its rows,
    chunks and mini-batches, on each of `ranks` data ranks: the rollout's
    prefill (#1) and R decode calls (#5) per layer; per layer one #1 for
    each chunk of the rank's old and reference log-probs; with a critic one
    #1 for its values; per global mini-batch (a rank takes its share of
    each) and layer one #1, #2 and #3 for the actor update (and for the
    critic's), and one more #1 when the layers are recomputed in the
    backward (enable_gradient_checkpointing)."""
    L, R = 24, config.actor_rollout_ref.rollout.response_length
    roll, n = config.actor_rollout_ref.rollout, config.actor_rollout_ref.rollout.n
    if validate:
        return _text_expect(flash_fwd=L, decode_hd=L * R)
    rows = prompts * n
    chunks = lambda c: -(-(rows // ranks) // c)
    updates = -(-rows // config.actor_rollout_ref.actor.ppo_mini_batch_size) * (2 if critic else 1)
    fwd = (L + L * chunks(roll.log_prob_micro_batch_size_per_gpu)
           + L * chunks(config.actor_rollout_ref.ref.log_prob_micro_batch_size_per_gpu)
           + (L if critic else 0) + L * updates * (1 + _remat(config)))
    return _text_expect(flash_fwd=fwd, decode_hd=L * R, flash_bwd_dq=L * updates,
                        flash_bwd_dkv=L * updates)


def _remat(config) -> int:
    return int(bool(config.actor_rollout_ref.model.enable_gradient_checkpointing))


def _drive_ppo(mods, fda, argv, written: dict, on_load=None) -> dict:
    """main_ppo.run(argv) on the card with a recording trainer: every count
    set to 0 just before each training_step and validate() and read just
    after; per step its metrics, seconds, peak memory and launches (#1's
    also by the rows of each launch), each
    actor mini-batch's metrics, the first mini-batch itself and every
    chunk's log-probs; whether the loaded policy and reference policy are
    bit-equal to `written` (when given); the attention mask of each
    mini-batch's first row; then on_load(trainer, record), when given,
    just after the load.
    Returns the record (the trainer under "trainer")."""
    from vla_rft_tpu_torch.trainer import main_ppo, ppo_trainer

    rec = {"steps": [], "minibatches": [], "logp": {"policy": [], "ref": []}}

    def timed_call(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_all_counts(mods, fda)  # the main path starts here
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = {"s": time.perf_counter() - t, "launches": _all_counts(mods, fda),
               "flash_fwd_by_rows": dict(mods[0].launches_by_rows),
               "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        _zero_all_counts(mods, fda)
        return out, got

    class Recording(ppo_trainer.PPOTrainer):
        def load_actor(self, state_dict):
            super().load_actor(state_dict)
            rec["trainer"] = self
            if written is not None:
                rec["loaded_bit_equal"] = all(
                    torch.equal(v.cpu(), written[k]) for m in (self.llm, self.ref)
                    for k, v in m.state_dict().items())
            if self.critic is not None:  # its seeded initialisation
                rec["critic_start"] = {k: v.clone() for k, v in self.critic.state_dict().items()}
            if on_load is not None:
                on_load(self, rec)

        def training_step(self, batch, gen):
            m, got = timed_call(lambda: super(Recording, self).training_step(batch, gen))
            rec["steps"].append({"metrics": m, **got,
                                 "kv_starts": (np.asarray(batch["input_ids"]) == self.roll_cfg
                                               .pad_token_id).sum(1).tolist()})
            return m

        def validate(self, gen=None):
            m, got = timed_call(lambda: super(Recording, self).validate(gen))
            rec["validate"] = {"metrics": m, **got}
            return m

        def _logp(self, model, g, chunk):
            lp = super()._logp(model, g, chunk)
            rec["logp"]["ref" if model is self.ref else "policy"].append(lp.clone())
            return lp

        def _actor_update(self, mb, share=(1.0, 1.0)):
            if not rec["minibatches"]:
                rec["first_mb"] = {k: v.clone() for k, v in mb.items()}
            rec.setdefault("first_rows", []).append(mb["attention_mask"][:1].clone())
            m = super()._actor_update(mb, share)
            rec["minibatches"].append(m)
            return m

    main_ppo.PPOTrainer = Recording
    try:
        main_ppo.run(argv)
    finally:
        main_ppo.PPOTrainer = ppo_trainer.PPOTrainer
    return rec


def _moved(module, start: dict) -> list:
    """Names of the parameters of `module` that differ from `start` (host)."""
    return [k for k, v in module.state_dict().items() if not torch.equal(v.cpu(), start[k])]


def _bwd_at_update_shape(attention, mask: torch.Tensor) -> dict:
    """#2 and #3 at the update's shape: 16 rows of 1663 whose kv_starts and
    kv_lens are the pad counts and valid ends of `mask` (the step's rows,
    one per prompt: kv_starts up to 945), 14/2 heads of 64, causal, seeded
    bf16 q / k / v / dO: against the backward twin under
    the flash_bwd bound, dq of every query before kv_starts and dk / dv of
    every key outside [kv_starts, kv_lens) exactly 0, every gradient
    finite, three calls of each the same bits; timed from a CUDA-graph
    replay beside the twin and the masked enable_gqa SDPA backward."""
    from vla_rft_tpu_torch.ops.attention import _valid

    dev = mask.device
    gen = torch.Generator(device=dev).manual_seed(19)
    B, S = mask.shape
    P = S - TEXT_R
    starts = (1 - mask[:, :P]).sum(1).to(torch.int32)
    rows = {"kv_starts": starts, "kv_lens": mask.sum(1).to(torch.int32) + starts,
            "q_offset": torch.zeros(B, dtype=torch.int32, device=dev)}
    q, do = (torch.randn(B, S, 14, 64, generator=gen, device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(B, S, 2, 64, generator=gen, device=dev).bfloat16() for _ in range(2))
    kw = dict(causal=True, **rows)
    o, lse = attention.flash_fwd(q, k, v, **kw)
    got = attention.flash_bwd(q, k, v, o, lse, do, **kw)
    ref = attention.attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    pos = torch.arange(S, device=dev)[None]
    dead_q = pos < starts[:, None]  # (B, S): queries with no valid key
    dead_k = dead_q | (pos >= rows["kv_lens"][:, None])
    errs = {}
    for name, g, r, dead in zip(("dq", "dk", "dv"), got, ref, (dead_q, dead_k, dead_k)):
        e, top = (g.float() - r.float()).abs().max().item(), r.float().abs().max().item()
        if not (e <= BWD_RTOL * top + BWD_ATOL and bool(torch.isfinite(g.float()).all())):
            raise AssertionError(f"ppo update shape: max|d{name}| {e} > {BWD_RTOL} * {top} + "
                                 f"{BWD_ATOL}, or not finite")
        if bool(g[dead].ne(0).any()):
            raise AssertionError(f"ppo update shape: {name} of pad positions not 0")
        errs[name] = e
    delta = (do.float() * o.float()).sum(dim=-1)
    dq = lambda: attention.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dkv = lambda: attention.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    for name, fn in (("flash_bwd_dq", dq), ("flash_bwd_dkv", dkv)):
        if not repeats_bit_for_bit(fn):
            raise AssertionError(f"{name} at the ppo update shape: three calls gave different bits")
    plain_ms = graph_ms(lambda: attention.attention_bwd_plain(q, k, v, o, lse, do, **kw), 2, 2)
    valid = _valid(B, S, S, dev, True, rows["kv_lens"], None, starts)[:, 0]
    leaves = [x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v)]
    sdpa = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=valid, enable_gqa=True)
    do_lib = do.transpose(1, 2)
    library_ms = (graph_ms(lambda: torch.autograd.grad(sdpa(), leaves, do_lib), 3, 2)
                  - graph_ms(sdpa, 3, 2))
    work = bwd_work(q, k, rows["kv_lens"], starts, rows["q_offset"], True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    common = {"B": B, "S": S, "Hq": 14, "Hkv": 2, "D": 64, "causal": True,
              "kv_starts": starts.tolist(), "kv_lens": rows["kv_lens"].tolist(),
              "repeats_bit_for_bit": True, "pad_gradients_zero": True, "plain_ms": plain_ms,
              "library_ms": library_ms}
    out = {"max_abs_err": errs,
           "dq": {**common, "kernel_ms": graph_ms(dq), "eager_ms": cuda_ms(dq, 10),
                  "plan": attention.dq_plan(B, S, 14, True), **bound(*work["dq"])},
           "dkv": {**common, "kernel_ms": graph_ms(dkv), "eager_ms": cuda_ms(dkv, 10),
                   "plan": attention.dkv_plan(B, S, 14, 2, sms), **bound(*work["dkv"])}}
    del q, k, v, o, lse, do, got, ref, leaves, valid
    torch.cuda.empty_cache()
    return out


def phase_ppo(mods, fda) -> dict:
    """Text RL through main_ppo.run at Qwen2.5-0.5B width (module docstring,
    phase ppo)."""
    import tempfile

    from vla_rft_tpu_torch.config import vla_rft_default_config

    attention = mods[0]
    L = 24
    root = tempfile.mkdtemp(prefix="ppo_")
    try:
        ckpt, prompts, written, _, _, inputs_s = write_text_inputs(root)
        common = [f"actor_rollout_ref.model.ckpt_path={ckpt}", f"data.train_files={prompts}",
                  "trainer.total_training_steps=1",
                  "actor_rollout_ref.model.enable_gradient_checkpointing=true"]

        # ------------------------------------------- main path: grpo + validate
        argv = common + ["trainer.test_freq=1"]
        config = vla_rft_default_config().apply_overrides(argv)
        rec = _drive_ppo(mods, fda, argv, written)
        tr = rec.pop("trainer")
        (step,) = rec["steps"]
        m = step["metrics"]
        prompts_n = config.data.train_batch_size
        expect = _ppo_expect(prompts_n, config, critic=False, validate=False)
        if step["launches"] != expect or rec["validate"]["launches"] != _ppo_expect(
                0, config, False, True):
            raise AssertionError(f"ppo: launches {step['launches']} / validate "
                                 f"{rec['validate']['launches']}, expected {expect}")
        if not rec["loaded_bit_equal"]:
            raise AssertionError("ppo: the loaded policy or reference policy is not the file's")
        if not (np.isfinite(list(m.values())).all()
                and np.isfinite(list(rec["validate"]["metrics"].values())).all()):
            raise AssertionError(f"ppo: metrics not finite {m} {rec['validate']['metrics']}")
        if max(step["peak_mem_gib"], rec["validate"]["peak_mem_gib"]) >= 80:
            raise AssertionError(f"ppo: peak memory {step['peak_mem_gib']} GiB")
        # (c) on-policy identity
        first = rec["minibatches"][0]
        old, ref_lp = torch.cat(rec["logp"]["policy"]), torch.cat(rec["logp"]["ref"])
        d_ref = (old - ref_lp).abs().max().item()
        ref_moved = _moved(tr.ref, written)
        if not (abs(first["actor/ppo_kl"]) <= PPO_KL_TOL and first["actor/pg_clipfrac"] == 0.0
                and d_ref <= PPO_KL_TOL and not ref_moved):
            raise AssertionError(f"ppo on-policy identity: first mini-batch {first}, ref vs old "
                                 f"log-probs {d_ref}, reference parameters moved {ref_moved[:5]}")
        moved_1e6 = _moved(tr.llm, written)
        # (d) kernel route vs plain route vs f64 attention on the first mini-batch
        mb = rec.pop("first_mb")
        idx = {n: i for i, (n, _) in enumerate(tr.llm.named_parameters())}
        watch = {w: idx[w] for w in [f"layers.{i}.self_attn.{x}_proj.weight"
                                     for i in (0, 6, 12, 18, 23) for x in "qkv"]
                 + ["embed_tokens.weight"]}
        kvp = _kernel_vs_plain(attention, tr.llm, lambda: tr.actor_loss(mb)[0],
                               lambda loss: torch.autograd.grad(loss, tr.actor_params),
                               watch, L, f64=True)
        _require_agreement(kvp, L, "ppo actor update", fwd=1 + _remat(config))
        _require_near_f64(kvp, L, "ppo actor update", fwd=1 + _remat(config))
        # (e) #2 / #3 at the update's shape against the twin, on the step's
        # rows: the first of each mini-batch (n = 16 rows of one prompt each)
        update_shape = _bwd_at_update_shape(attention, torch.cat(rec.pop("first_rows")))
        main = {"prompts": prompts_n, "rows": prompts_n * config.actor_rollout_ref.rollout.n,
                "response_length": TEXT_R, "mini_batch": config.actor_rollout_ref.actor
                .ppo_mini_batch_size, "adv_estimator": "grpo",
                "kv_starts": step["kv_starts"], "launches": step["launches"],
                "expected_launches": expect, "step_s": step["s"],
                "timing_s": {k[9:]: v for k, v in m.items() if k.startswith("timing_s/")},
                "peak_mem_gib": step["peak_mem_gib"],
                "metrics": {k: v for k, v in m.items() if not k.startswith("timing_s/")},
                "first_minibatch": first, "minibatch_ppo_kl": [x["actor/ppo_kl"]
                                                               for x in rec["minibatches"]],
                "ref_vs_old_logp_max_abs": d_ref, "reference_policy_bit_identical": True,
                "advantages_all_zero": bool(mb["advantages"].eq(0).all()),
                "parameters_moved_at_lr_1e-6": {"moved": len(moved_1e6),
                                                "of": len(written), "names": moved_1e6[:8]},
                "validate": {"s": rec["validate"]["s"], "launches": rec["validate"]["launches"],
                             "peak_mem_gib": rec["validate"]["peak_mem_gib"],
                             "metrics": rec["validate"]["metrics"]},
                "input_s": inputs_s}
        print(f"[ppo] grpo step {step['s']:.1f} s, stages {main['timing_s']}, peak "
              f"{step['peak_mem_gib']:.2f} GiB, launches {step['launches']}", flush=True)
        del tr, rec, mb, old, ref_lp
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------------------- gae: critic, raised lr, cut rows
        argv = common + [f"data.train_batch_size={PPO_GAE_PROMPTS}", "algorithm.adv_estimator=gae",
                         f"actor_rollout_ref.actor.optim.lr={PPO_RAISED_LR}",
                         f"critic.optim.lr={PPO_RAISED_LR}",
                         f"actor_rollout_ref.rollout.response_length={TEXT_R_CUT}"]
        config = vla_rft_default_config().apply_overrides(argv)
        rec = _drive_ppo(mods, fda, argv, written)
        tr = rec.pop("trainer")
        (gstep,) = rec["steps"]
        gm = gstep["metrics"]
        gexpect = _ppo_expect(PPO_GAE_PROMPTS, config, critic=True, validate=False)
        if gstep["launches"] != gexpect or "critic/vf_loss" not in gm:
            raise AssertionError(f"ppo gae: launches {gstep['launches']}, expected {gexpect}; "
                                 f"metrics {sorted(gm)}")
        if not np.isfinite(list(gm.values())).all() or gstep["peak_mem_gib"] >= 80:
            raise AssertionError(f"ppo gae: metrics {gm}, peak {gstep['peak_mem_gib']} GiB")
        still = sorted(set(written) - set(_moved(tr.llm, written)))
        ref_moved = _moved(tr.ref, written)
        critic_still = [k for k, v in tr.critic.state_dict().items()
                        if torch.equal(v, rec["critic_start"][k])]
        if still or ref_moved or critic_still:
            raise AssertionError(f"ppo gae at lr {PPO_RAISED_LR}: policy parameters that did not "
                                 f"move {still[:5]} ({len(still)}); critic parameters that did "
                                 f"not move {critic_still[:5]} ({len(critic_still)}); reference "
                                 f"parameters that moved {ref_moved[:5]}")
        gae = {"prompts": PPO_GAE_PROMPTS, "rows": PPO_GAE_PROMPTS * config.actor_rollout_ref
               .rollout.n, "lr": PPO_RAISED_LR, "launches": gstep["launches"],
               "expected_launches": gexpect, "step_s": gstep["s"],
               "timing_s": {k[9:]: v for k, v in gm.items() if k.startswith("timing_s/")},
               "peak_mem_gib": gstep["peak_mem_gib"],
               "metrics": {k: v for k, v in gm.items() if not k.startswith("timing_s/")},
               "policy_parameters_moved": len(written),
               "critic_parameters_moved": len(rec["critic_start"]),
               "reference_policy_bit_identical": True,
               "cut": f"data.train_batch_size={PPO_GAE_PROMPTS} (config 16); "
                      f"actor_rollout_ref.rollout.response_length={TEXT_R_CUT} "
                      f"(config {TEXT_R}); lr {PPO_RAISED_LR}"}
        print(f"[ppo] gae step {gstep['s']:.1f} s, peak {gstep['peak_mem_gib']:.2f} GiB, "
              f"launches {gstep['launches']}", flush=True)
        del tr, rec
        out = {"phase": "ppo", "model": "qwen25_0_5b", "grpo": main, "gae": gae,
               "kernel_vs_plain": kvp, "update_shape_bwd": update_shape,
               "tolerance": {"on_policy": PPO_KL_TOL, "loss_rel": SFT_LOSS_TOL,
                             "grad_rel": SFT_GRAD_TOL,
                             "vs_f64": f"<= {F64_ROUTE_RATIO} x plain + {SFT_GRAD_TOL}"}}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


# reward_models: main_ppo.run with the reward models on text_gen's inputs, bf16,
# enable_gradient_checkpointing (the decoder's remat, for PRIME's RM as for
# the policy).  (a) PRIME at the config's shapes with recipe/prime.sh's
# overrides (ce, token, update after, lr 1e-6), cut to PRIME_PROMPTS of its
# 16 prompts: 8 prompts x n = 16 = 128 rows x 568, the RM's log-probs in
# chunks of 16 rows, the reference's those of the reference policy (chunks
# of 8, temperature 1), the RM's update in micro-batches of 16 rows
# (actor.ppo_mini_batch_size, whole groups of n), then 8 actor updates.  (b) the value-head RM, grpo, cut to
# RM_CUT_PROMPTS prompts x 16: one of a gsm8k prompt, one of a data source
# with no rule scorer.  (c) PRIME's other branch (dpo, bon_rm, whole,
# update before), cut the same way, two steps, at RM_RAISED_LR for the RM so
# that every bf16 RM parameter moves (the config's 1e-6 is below half an ulp
# of most).
PRIME_RECIPE = ["algorithm.adv_estimator=prime", "algorithm.reward_gt_coef=5.0",
                "algorithm.reward_dpo_coef=5.0", "reward_model.enable=True",
                "reward_model.rm_type=prime", "reward_model.prime_granularity=token",
                "reward_model.loss_type=ce", "reward_model.beta_train=0.05",
                "reward_model.lr=1e-6", "actor_rollout_ref.actor.use_kl_loss=False"]
RM_CUT_PROMPTS, RM_RAISED_LR = 2, 5e-3
# the PRIME step's prompts: rows, not the 568-token response, are cut (the
# decode loop is host-paced, so the rows cost the update's time alone)
PRIME_PROMPTS = 8
RM_UNSCORED = "custom/no_rule_scorer"
PRIME_DPO_BRANCH = ["reward_model.loss_type=dpo", "reward_model.bon_mode=bon_rm",
                    "reward_model.prime_granularity=whole", "reward_model.update=before",
                    f"reward_model.lr={RM_RAISED_LR}"]


def _rm_expect(prompts: int, config, rm: str, ranks: int = 1) -> dict:
    """Launches of one reward-model step, derived as `_ppo_expect` derives a
    grpo step's, plus the RM's: with the value-head RM ("value_head") one
    #1 per layer and log-prob chunk of its scores; with PRIME ("prime") one
    #1 per layer and chunk of the RM's log-probs (rollout's chunks), of its
    reference's only at a rollout temperature other than 1 (at 1 they are
    the reference policy's, ref's chunks, already counted), and per update
    micro-batch (ppo_mini_batch_size rounded down to whole groups of n) and
    layer one #1, one more with remat, one #2 and one #3; each on each of
    `ranks` data ranks, over its rows."""
    L, n = 24, config.actor_rollout_ref.rollout.n
    rows = prompts * n // ranks
    chunks = lambda c: -(-rows // c)
    base = _ppo_expect(prompts, config, critic=False, validate=False, ranks=ranks)
    aref = config.actor_rollout_ref
    rm_chunks = chunks(aref.rollout.log_prob_micro_batch_size_per_gpu)
    if rm == "value_head":
        return {**base, "flash_fwd": base["flash_fwd"] + L * rm_chunks}
    mini = aref.actor.ppo_mini_batch_size
    updates = chunks(max(n, mini - mini % n))
    own_ref = 0 if aref.rollout.temperature == 1.0 else chunks(
        aref.ref.log_prob_micro_batch_size_per_gpu)
    return {**base, "flash_fwd": base["flash_fwd"] + L * (rm_chunks + own_ref)
            + L * updates * (1 + _remat(config)),
            "flash_bwd_dq": base["flash_bwd_dq"] + L * updates,
            "flash_bwd_dkv": base["flash_bwd_dkv"] + L * updates}


def _record_rm(written: dict):
    """An on_load for `_drive_ppo`: whether PRIME's RM and its reference
    were loaded bit-equal to `written`; every call of PRIME's score (its
    output), PRIME's first update micro-batch, and the value-head step's
    scores with the rows, data sources and ground truths they came from."""

    def on_load(tr, rec):
        scores = tr._scores

        def scored(g, sources, gts, timing):
            out = scores(g, sources, gts, timing)
            rec["scores"] = (g, sources, gts, out.clone())
            return out

        tr._scores = scored
        pr = tr.prime_rm
        if pr is None:
            return
        rec["prime_loaded_bit_equal"] = all(
            torch.equal(v.cpu(), written[k]) for m in (pr.model, pr.ref)
            for k, v in m.state_dict().items())
        score, loss = pr.compute_rm_score, pr._loss
        rec["prime_scores"] = []

        def prime_scored(*args, **kw):
            out = score(*args, **kw)
            rec["prime_scores"].append(out.clone())
            return out

        def first_loss(mb, B):
            rec.setdefault("prime_first_mb", ({k: v.clone() for k, v in mb.items()}, B))
            return loss(mb, B)

        pr.compute_rm_score, pr._loss = prime_scored, first_loss

    return on_load


def _rm_step(rec: dict, expect: dict, what: str, steps: int = 1) -> dict:
    """The `steps` steps of `rec`, each with launches as `expect`, finite
    metrics and peak memory under 80 GiB, or raise; the first one's
    summary, with the later ones' under "later_steps" when there are any."""
    if len(rec["steps"]) != steps:
        raise AssertionError(f"{what}: {len(rec['steps'])} steps, expected {steps}")
    out = []
    for step in rec["steps"]:
        m = step["metrics"]
        if step["launches"] != expect:
            raise AssertionError(f"{what}: launches {step['launches']}, expected {expect}")
        if not np.isfinite(list(m.values())).all() or step["peak_mem_gib"] >= 80:
            raise AssertionError(f"{what}: metrics {m}, peak {step['peak_mem_gib']} GiB")
        out.append({"kv_starts": step["kv_starts"], "launches": step["launches"],
                    "flash_fwd_by_rows": step["flash_fwd_by_rows"],
                    "expected_launches": expect, "step_s": step["s"],
                    "timing_s": {k[9:]: v for k, v in m.items() if k.startswith("timing_s/")},
                    "peak_mem_gib": step["peak_mem_gib"],
                    "metrics": {k: v for k, v in m.items() if not k.startswith("timing_s/")}})
    return {**out[0], "later_steps": out[1:]} if steps > 1 else out[0]


def _write_mixed_prompts(path: str) -> list:
    """RM_CUT_PROMPTS-prompt draws for the value-head step: a parquet of 4
    rows alternating gsm8k and RM_UNSCORED (146 and 1091 words), of which
    RLHFDataset's first draw (seed 0) takes rows 3 and 2, one of each.
    Returns the data sources of the rows."""
    import pandas as pd
    from sft_data import write_rlhf_parquet

    frames = []
    for i, (source, words) in enumerate([("openai/gsm8k", TEXT_WORDS[0]),
                                         (RM_UNSCORED, TEXT_WORDS[-2])] * 2):
        part = f"{path}.{i}"
        write_rlhf_parquet(part, [words], TEXT_VOCAB - 8, seed=i, data_source=source)
        frames.append(pd.read_parquet(part))
        os.remove(part)
    df = pd.concat(frames, ignore_index=True)
    df.to_parquet(path)
    return df["data_source"].tolist()


def phase_reward_models(mods, fda) -> dict:
    """Text RL's reward models through main_ppo.run at Qwen2.5-0.5B width
    (module docstring, phase reward_models)."""
    import tempfile

    from vla_rft_tpu_torch.config import vla_rft_default_config
    from vla_rft_tpu_torch.models.critic import token_outputs
    from vla_rft_tpu_torch.models.reward_model import compute_rm_score
    from vla_rft_tpu_torch.utils.reward_score import has_scorer

    attention = mods[0]
    L = 24
    root = tempfile.mkdtemp(prefix="rm_")
    try:
        ckpt, prompts, written, _, _, inputs_s = write_text_inputs(root)
        mixed = os.path.join(root, "mixed.parquet")
        _write_mixed_prompts(mixed)
        common = [f"actor_rollout_ref.model.ckpt_path={ckpt}", "trainer.total_training_steps=1",
                  "actor_rollout_ref.model.enable_gradient_checkpointing=true"]

        # ---------- (a) PRIME at the config's shapes, PRIME_PROMPTS prompts (main path)
        argv = common + [f"data.train_files={prompts}",
                         f"data.train_batch_size={PRIME_PROMPTS}"] + PRIME_RECIPE
        config = vla_rft_default_config().apply_overrides(argv)
        rec = _drive_ppo(mods, fda, argv, written, on_load=_record_rm(written))
        tr = rec.pop("trainer")
        prompts_n = config.data.train_batch_size
        main = _rm_step(rec, _rm_expect(prompts_n, config, "prime"), "reward_models prime")
        m = main["metrics"]
        if not (rec["loaded_bit_equal"] and rec["prime_loaded_bit_equal"]):
            raise AssertionError("reward_models prime: a loaded model is not the file's")
        (scores,) = rec["prime_scores"]
        ref_moved = _moved(tr.prime_rm.ref, written)
        rm_moved = _moved(tr.prime_rm.model, written)
        if not (torch.equal(scores, torch.zeros_like(scores)) and not ref_moved and rm_moved
                and all(k in m for k in ("prime/rm_loss", "prime/dpo_acc"))):
            raise AssertionError(
                f"reward_models prime: step 1's process scores max|s| "
                f"{scores.abs().max().item()} (expected exactly 0), PRIME reference "
                f"parameters that moved {ref_moved[:5]}, RM parameters moved {len(rm_moved)}, "
                f"metrics {sorted(m)}")
        # kernel route vs plain route vs f64 attention on PRIME's first update
        # micro-batch at the weights it saw (the RM's start, its reference's),
        # each route taking the reference's log-probs on its own attention:
        # a process score is a sum over 568 tokens of two log-probs' difference,
        # so one route's reference against another's RM, or an RM a step off
        # its reference, leaves the bf16 round-off of every token in the sum
        # (PERF.md section 6: 0.1-0.2 nats a row, 2e-3-1e-2 of the loss)
        mb, B = rec.pop("prime_first_mb")
        pr = tr.prime_rm
        model = pr.model
        model.load_state_dict(written)
        idx = {n: i for i, (n, _) in enumerate(model.named_parameters())}
        watch = {w: idx[w] for w in [f"layers.{i}.self_attn.{x}_proj.weight"
                                     for i in (0, 6, 12, 18, 23) for x in "qkv"]
                 + ["embed_tokens.weight"]}

        def route_loss():
            pr.ref.attn_impl = model.attn_impl
            try:
                ref_lp = pr.ref_log_probs(mb["input_ids"], mb["attention_mask"],
                                          mb["position_ids"])
            finally:
                pr.ref.attn_impl = "auto"
            return pr._loss({**mb, "ref_log_probs": ref_lp}, B)[0]

        kvp = _kernel_vs_plain(attention, model, route_loss,
                               lambda loss: torch.autograd.grad(loss, pr.params), watch, L,
                               f64=True)
        # per layer: the reference's forward per chunk, the RM's and its recompute
        fwd = -(-mb["input_ids"].shape[0] // pr.cfg.ref_micro_batch) + 1 + _remat(config)
        _require_agreement(kvp, L, "PRIME RM update", fwd=fwd)
        _require_near_f64(kvp, L, "PRIME RM update", fwd=fwd)
        # #1 at 8 rows, counted in the step: the reference policy's log-prob
        # chunks, which are PRIME's reference's at temperature 1
        by_rows = main["flash_fwd_by_rows"]
        at_8 = L * -(-prompts_n * config.actor_rollout_ref.rollout.n
                     // config.actor_rollout_ref.ref.log_prob_micro_batch_size_per_gpu)
        if by_rows.get(8) != at_8 or sum(by_rows.values()) != main["launches"]["flash_fwd"]:
            raise AssertionError(f"reward_models prime: #1 launches by rows {by_rows}, "
                                 f"expected {at_8} of 8 rows")
        main.update({
            "prompts": prompts_n, "rows": prompts_n * config.actor_rollout_ref.rollout.n,
            "response_length": config.actor_rollout_ref.rollout.response_length,
            "cut": f"data.train_batch_size={PRIME_PROMPTS} (config 16)",
            "update_micro_batch": mb["input_ids"].shape[0],
            "settings": PRIME_RECIPE, "process_scores_exactly_0": True,
            "flash_fwd_launches_at_8_rows_expected": at_8,
            "prime_reference_bit_identical": True,
            "prime_rm_parameters_moved_at_lr_1e-6": {"moved": len(rm_moved), "of": len(written),
                                                     "names": rm_moved[:8]},
            "input_s": inputs_s})
        print(f"[reward_models] prime step {main['step_s']:.1f} s, stages {main['timing_s']}, "
              f"peak {main['peak_mem_gib']:.2f} GiB, launches {main['launches']}", flush=True)
        del tr, rec, mb, scores, model, pr
        gc.collect()
        torch.cuda.empty_cache()

        # ------------------ (b) the value-head RM, grpo, a prompt of each kind
        argv = common + [f"data.train_files={mixed}", f"data.train_batch_size={RM_CUT_PROMPTS}",
                         "reward_model.enable=True",
                         f"actor_rollout_ref.rollout.response_length={TEXT_R_CUT}"]
        config = vla_rft_default_config().apply_overrides(argv)
        rec = _drive_ppo(mods, fda, argv, written, on_load=_record_rm(written))
        tr = rec.pop("trainer")
        value = _rm_step(rec, _rm_expect(RM_CUT_PROMPTS, config, "value_head"),
                         "reward_models value_head")
        g, sources, gts, got = rec.pop("scores")
        rule = np.asarray([has_scorer(s) for s in sources])
        if not (rule.any() and (~rule).any()):
            raise AssertionError(f"reward_models value_head: the step drew {sources}")
        resp, resp_mask = g["responses"].cpu().numpy(), g["response_mask"].cpu().numpy()
        want_rule = tr.reward_manager(resp[rule], resp_mask[rule],
                                      [s for s, r in zip(sources, rule) if r],
                                      [t for t, r in zip(gts, rule) if r])
        other = torch.as_tensor(~rule, device=got.device)
        with torch.no_grad():  # the plain route on the same rows, and max|score|
            tr.rm.backbone.attn_impl = "plain"
            try:
                plain = compute_rm_score(tr.rm, g["input_ids"][other], g["attention_mask"][other],
                                         g["position_ids"][other], TEXT_R_CUT)
            finally:
                tr.rm.backbone.attn_impl = "auto"
            every = token_outputs(tr.rm, g["input_ids"][other], g["attention_mask"][other],
                                  g["position_ids"][other], TEXT_R_CUT)
            max_score = every[:, -TEXT_R_CUT:].abs().max().item()
        model_rows = got[other]
        last = torch.as_tensor(resp_mask[~rule].sum(1) - 1, device=got.device).clamp_min(0)
        at_last = model_rows.gather(1, last.long()[:, None])[:, 0]
        d_score = (model_rows - plain).abs().max().item()
        score_bound = 2 * TEXT_LOGIT_TOL * max_score
        if not (np.array_equal(got.cpu().numpy()[rule], want_rule)
                and int(model_rows.ne(0).sum(1).max()) <= 1 and bool(at_last.ne(0).all())
                and d_score <= score_bound):
            raise AssertionError(f"reward_models value_head: rule rows equal "
                                 f"{np.array_equal(got.cpu().numpy()[rule], want_rule)}, model "
                                 f"rows' scores at their last token {at_last.tolist()[:4]}, "
                                 f"kernel vs plain {d_score} (bound {score_bound})")
        value.update({"prompts": RM_CUT_PROMPTS, "rows": len(sources),
                      "data_sources": sorted(set(sources)), "rule_rows": int(rule.sum()),
                      "rule_rows_carry_rule_scores": True,
                      "model_rows_scored_at_last_token": True,
                      "model_scores": at_last.tolist()[:4],
                      "kernel_vs_plain_max_abs": d_score, "max_abs_score": max_score,
                      "bound": score_bound,
                      "cut": f"data.train_batch_size={RM_CUT_PROMPTS} (config 16); "
                             f"actor_rollout_ref.rollout.response_length={TEXT_R_CUT} "
                             f"(config {TEXT_R})"})
        print(f"[reward_models] value-head step {value['step_s']:.1f} s, kernel vs plain "
              f"{d_score:.3g} (bound {score_bound:.3g}), launches {value['launches']}",
              flush=True)
        del tr, rec, g, got, plain, every
        gc.collect()
        torch.cuda.empty_cache()

        # ---------------------- (c) PRIME's other branch: dpo, bon_rm, whole, before
        # two steps: step 1 updates the RM while it is its reference (every
        # process score 0, every group's Q values tied: each row's DPO loss is
        # ln 2 and its bon_rm weight n), step 2 a moved RM whose Q values differ.
        # The verifier is a stand-in, the parity of the response text's length:
        # random weights answer no gsm8k prompt, and the DPO loss holds a row's
        # Q against those of its group's members of the other outcome
        argv = common + [f"data.train_files={prompts}", f"data.train_batch_size={RM_CUT_PROMPTS}",
                         *PRIME_RECIPE, *PRIME_DPO_BRANCH, "trainer.total_training_steps=2",
                         f"actor_rollout_ref.rollout.response_length={TEXT_R_CUT}"]
        config = vla_rft_default_config().apply_overrides(argv)
        record = _record_rm(written)

        def parity_verifier(tr, rec):
            tr.reward_manager.compute_score = lambda source, text, gt, extra=None: float(
                len(text) % 2)
            record(tr, rec)

        rec = _drive_ppo(mods, fda, argv, written, on_load=parity_verifier)
        tr = rec.pop("trainer")
        dpo = _rm_step(rec, _rm_expect(RM_CUT_PROMPTS, config, "prime"), "reward_models dpo",
                       steps=2)
        scores = rec["prime_scores"]
        n = config.actor_rollout_ref.rollout.n
        rows = scores[0].shape[0]
        tie = rows * n * float(np.log(2.0))
        rm_loss = [dpo["metrics"]["prime/rm_loss"],
                   dpo["later_steps"][0]["metrics"]["prime/rm_loss"]]
        acc = rec["scores"][3].sum(-1).reshape(-1, n)  # step 2's outcomes by group
        mixed = int(((acc > 0).any(1) & (acc == 0).any(1)).sum())
        still = sorted(set(written) - set(_moved(tr.prime_rm.model, written)))
        ref_moved = _moved(tr.prime_rm.ref, written)
        per_row = [int(s.ne(0).sum(1).max()) for s in scores]
        if not (rec["prime_loaded_bit_equal"] and not still and not ref_moved
                and all(s.abs().max().item() > 0 for s in scores) and max(per_row) <= 1
                and abs(rm_loss[0] - tie) <= 1e-5 * tie and abs(rm_loss[1] - tie) > 1e-5 * tie
                and mixed > 0):
            raise AssertionError(f"reward_models dpo at lr {RM_RAISED_LR}: RM parameters that "
                                 f"did not move {still[:5]} ({len(still)}), reference "
                                 f"parameters that moved {ref_moved[:5]}, most nonzero scores "
                                 f"a row {per_row}, prime/rm_loss {rm_loss} (step 1 must be "
                                 f"the tie value {tie}, step 2 not), step 2's groups with "
                                 f"both outcomes {mixed}")
        dpo.update({"prompts": RM_CUT_PROMPTS, "rows": rows, "rm_lr": RM_RAISED_LR,
                    "settings": PRIME_DPO_BRANCH + ["trainer.total_training_steps=2"],
                    "prime_rm_parameters_moved": len(written),
                    "prime_reference_bit_identical": True,
                    "rm_loss_per_step": rm_loss, "rm_loss_tie_value": tie,
                    "verifier": "parity of the response text's length",
                    "step_2_groups_with_both_outcomes": mixed,
                    "dpo_acc_per_step": [dpo["metrics"]["prime/dpo_acc"],
                                         dpo["later_steps"][0]["metrics"]["prime/dpo_acc"]],
                    "process_scores": [{"max_abs": s.abs().max().item(),
                                        "nonzero_per_row_max": k}
                                       for s, k in zip(scores, per_row)],
                    "cut": f"data.train_batch_size={RM_CUT_PROMPTS} (config 16); "
                           f"actor_rollout_ref.rollout.response_length={TEXT_R_CUT} "
                           f"(config {TEXT_R}); RM lr {RM_RAISED_LR}"})
        print(f"[reward_models] dpo steps {dpo['step_s']:.1f} / "
              f"{dpo['later_steps'][0]['step_s']:.1f} s, rm_loss {rm_loss} (tie {tie:.6g}), "
              f"peak {dpo['peak_mem_gib']:.2f} GiB, launches {dpo['launches']}", flush=True)
        del tr, rec, scores
        out = {"phase": "reward_models", "model": "qwen25_0_5b", "prime": main,
               "value_head": value, "dpo": dpo, "kernel_vs_plain": kvp,
               "tolerance": {"process_scores_step_1": "exactly 0", "loss_rel": SFT_LOSS_TOL,
                             "grad_rel": SFT_GRAD_TOL,
                             "vs_f64": f"<= {F64_ROUTE_RATIO} x plain + {SFT_GRAD_TOL}",
                             "value_head_scores": "2 * logits tol * max|score|"}}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return out


# ------------------------------------------------------------------ parallel
# two ranks share the one card (cuda:{LOCAL_RANK % 1}) over gloo: NCCL
# refuses two ranks on one device
PAR_WORLD = 2
GLOO_PROBES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single", "send_recv")
# what torch's own collectives need: FSDP2 all-gathers its shards and
# reduce-scatters their gradients (a dp x fsdp mesh adds an all-reduce)
FSDP_NEEDS = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce")
PAR_QWEN_BATCH, PAR_QWEN_SEED = 2, 22
# the 2-rank GRPO step (teacher-forced WM reward) against the 1-rank step
# on the same global batch and draws: PAR_COMPARED within WM_LOGIT_TOL
# relative (each rank encodes, rolls out and scores 1 sample where one
# rank does 2: bf16 GEMMs of another shape) plus PAR_ATOL, actor/grad_norm among them (a gradient
# not summed over the ranks is off by 2x); and the expert's update, each
# leaf's max difference within 2 x its 1-rank max step.  Adam's first step
# is +-lr a parameter whatever |g| (|g| >> eps), so every gradient element
# whose sign the bf16 noise of the other shapes decides steps 2 lr apart:
# the share of elements more than 1e-3 x the step apart is a measure of
# that noise (about 0.1 on an H100), gated at PAR_STEP_SHARE, half of what
# an update uncorrelated with the 1-rank one would give
PAR_STEP_SHARE = 0.25
# absolute floors for the near-zero metrics: the on-policy ppo_kl and
# pg_loss are means of bf16 log-prob differences (|log p| ~ 6, a bf16 ulp
# 2^-8 of that), 0 wherever both runs replay with the same shapes
PAR_ATOL = {"actor/ppo_kl": 1e-3, "actor/pg_loss": 1e-3, "actor/pg_clipfrac": 1e-3,
            "critic/advantages/max": 1e-4, "critic/advantages/min": 1e-4}
PAR_COMPARED = ("critic/rewards/mean", "critic/rewards/max", "critic/rewards/min",
                "critic/advantages/max", "critic/advantages/min", "critic/recon_loss/mean",
                "critic/perceptual_loss/mean", "actor/pg_loss", "actor/grad_norm",
                "actor/entropy", "actor/ppo_kl", "actor/pg_clipfrac",
                "actor/old_log_prob_mean", "actor/predicted_action_abs_mean")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


_RANK_PROCS = []  # every rank process started, stopped when the phase ends


def _stop_ranks() -> None:
    for p in _RANK_PROCS:
        if p.poll() is None:
            p.kill()
            p.wait()
    _RANK_PROCS.clear()


def _start_ranks(task: str, world: int, payload: dict, root: str):
    """Start `world` processes of this script on `task` (torchrun's
    variables, one card: LOCAL_RANK % 1 = 0); returns (procs, their dir)."""
    d = tempfile.mkdtemp(prefix=f"rank_{task.replace(':', '_')}_", dir=root)
    torch.save(payload, os.path.join(d, "in.pt"))
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="4", PYTHONUNBUFFERED="1")
    procs = []
    for r in range(world):
        log = open(os.path.join(d, f"log{r}.txt"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-X", "faulthandler", os.path.abspath(__file__), "--rank-task",
             task, d],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=log,
            stderr=subprocess.STDOUT), log))
        _RANK_PROCS.append(procs[-1][0])
    return procs, d


def _wait_ranks(procs, d: str, timeout: float, raise_on_fail: bool = True):
    """Wait for every rank (each is killed at the deadline); returns the
    per-rank results, or None for a rank that failed when not raising."""
    deadline = time.perf_counter() + timeout
    for p, log in procs:
        try:
            p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
        except subprocess.TimeoutExpired:
            pass
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    outs, failed = [], []
    for r, (p, _) in enumerate(procs):
        path = os.path.join(d, f"out{r}.pt")
        if p.returncode == 0 and os.path.exists(path):
            outs.append(torch.load(path, weights_only=False))
            continue
        with open(os.path.join(d, f"log{r}.txt")) as f:
            tail = f.read()[-4000:]
        failed.append(f"rank {r} of {d}: exit {p.returncode}\n{tail}")
        outs.append({"failed": f"exit {p.returncode}: "
                               f"{(tail.strip().splitlines() or [''])[-1][:200]}"})
    if failed and raise_on_fail:  # every failed rank's tail: the first to fail may be any
        raise AssertionError("\n".join(failed))
    return outs


def _rank_probe(op: str) -> dict:
    """One gloo collective on cuda:0 tensors, its result checked."""
    import torch.distributed as dist

    r, dev = dist.get_rank(), torch.device("cuda:0")
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * r
    if op == "all_reduce":
        dist.all_reduce(x)
        ok = torch.equal(x.cpu(), torch.arange(4.0) * 2 + 10)
    elif op == "broadcast":
        dist.broadcast(x, 0)
        ok = torch.equal(x.cpu(), torch.arange(4.0))
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        ok = torch.equal(parts[1].cpu(), torch.arange(4.0) + 10)
    elif op == "all_gather_into_tensor":
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        ok = torch.equal(out.cpu()[4:], torch.arange(4.0) + 10)
    elif op == "reduce_scatter_tensor":
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        ok = torch.equal(out.cpu(), (torch.arange(4.0) * 2 + 10)[2 * r:2 * r + 2])
    elif op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        ok = torch.equal(out.cpu()[2:], (torch.arange(4.0) + 10)[2 * r:2 * r + 2])
    else:  # send_recv
        if r == 0:
            dist.send(x, 1)
            ok = True
        else:
            dist.recv(x, 0)
            ok = torch.equal(x.cpu(), torch.arange(4.0))
    torch.cuda.synchronize()
    return {"ok": bool(ok)}


def probe_gloo(root: str) -> dict:
    """Which collectives a two-rank gloo group carries on cuda:0 tensors.
    One pair of processes runs them in GLOO_PROBES' order, each rank noting
    each result in a file as it goes; a collective that aborts its process
    is refused, and a new pair takes the rest."""
    out, remaining = {}, list(GLOO_PROBES)
    while remaining:
        procs, d = _start_ranks("probe:" + ",".join(remaining), PAR_WORLD, {}, root)
        res = _wait_ranks(procs, d, 120.0, raise_on_fail=False)
        done = []
        for r in range(PAR_WORLD):
            path = os.path.join(d, f"progress{r}.txt")
            lines = open(path).read().split() if os.path.exists(path) else []
            done.append(dict(x.split("=") for x in lines))
        left = []
        for i, op in enumerate(remaining):
            if all(op in x for x in done):
                out[op] = "carried" if all(x[op] == "1" for x in done) else "wrong result"
                continue
            fails = [x["failed"] for x in res if "failed" in x] or ["no result"]
            out[op] = f"refused ({fails[0]})"
            left = remaining[i + 1:]
            break
        remaining = left
    return out


def _digest(sd: dict) -> dict:
    """A fingerprint of each tensor's bits, computed on its device: the sum
    of its elements' bit patterns and their sum weighted by position (mod
    65521), as int64; any changed bit changes it but by coincidence."""
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    out = {}
    for k, v in sd.items():
        bits = v.detach().contiguous().view(ints[v.element_size()]).flatten()
        s, w = 0, 0
        for i in range(0, bits.numel(), 1 << 24):
            b = bits[i:i + (1 << 24)].to(torch.int64)
            s += int(b.sum())
            pos = torch.arange(i, i + b.numel(), device=b.device) % 65521 + 1
            w += int((b * pos).sum())
        out[k] = (s, w)
    return out


def _par_grpo_argv(ckpt_dir: str) -> list:
    # one step without the lr warm-up (whose first step is 0 for the flow
    # head), so that every expert leaf moves
    return ["world_model_rollout.rollout.weights_int8=true",
            "world_model_rollout.rollout.do_sample=false",
            "actor_rollout_ref.actor.optim.lr_warmup_steps=0",
            f"data.train_batch_size={N_SAMPLES}", f"actor_rollout_ref.rollout.n={N_ROLLOUTS}",
            "trainer.total_training_steps=1", f"trainer.default_local_dir={ckpt_dir}"]


def _grpo_run(mods, argv, reward: str, save_expert=None, keep_start: bool = False,
              rank_chunks: int = 1) -> dict:
    """One step of main_vla_rft_grpo.run(argv) on this process's rank(s):
    launches counted from 0 around the step, the digests of this rank's
    own shards of the frozen trees before and after (gathering the whole
    trees cost an fsdp 2 rank half a minute), the expert's before and after (its whole state after
    the step to the file `save_expert`; with `keep_start` its state before
    it too), peak memory, metrics.  Whole trees are gathered from their
    FSDP shards while the process group is up.  `rank_chunks` > 1 runs
    the tokenizer and the teacher-forced WM reward's forward on that many
    equal chunks of the samples and rows (the chunks a 2-rank step's
    ranks hold), so that the 1-rank step's convolutions and GEMMs have the
    2-rank step's shapes."""
    from vla_rft_tpu_torch.parallel import mesh as pm
    from vla_rft_tpu_torch.trainer import grpo_trainer, main_vla_rft_grpo

    real_reward = grpo_trainer.wm_logprob_reward

    def chunked_reward(wm, pc, rc, input_ids, prompt_length, *args):
        parts = [real_reward(wm, pc, rc, x, prompt_length, *args)
                 for x in input_ids.chunk(rank_chunks)]
        return (torch.cat([r for r, _ in parts]),
                {k: torch.stack([m[k] for _, m in parts]).mean() for k in parts[0][1]})

    rec, held, frozen = {}, {}, ("vla", "wm", "tokenizer", "lpips")
    whole = lambda m: pm.full_state_dict(getattr(held["tr"].bundle, m))
    own = lambda m: {k: pm.local(v) for k, v in getattr(held["tr"].bundle, m)
                     .state_dict().items()}  # this rank's shards: no gather

    def on_start(tr):
        held["tr"] = tr
        if rank_chunks > 1:
            tokenize = tr.bundle.tokenizer.tokenize
            tr.bundle.tokenizer.tokenize = lambda px: tuple(
                torch.cat(p) for p in zip(*(tokenize(x) for x in px.chunk(rank_chunks))))
        rec["frozen_before"] = {m: _digest(own(m)) for m in frozen}
        expert = whole("expert")
        rec["expert_before"] = _digest(expert)
        if keep_start:
            rec["expert_start"] = {k: v.detach().float().cpu().clone() for k, v in expert.items()}

    def on_step_start(step):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_decode_counts(mods)

    def on_step_end(step, metrics):
        rec["launches"] = _decode_counts(mods)  # read right after the step
        rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["metrics"] = {k: v for k, v in metrics.items() if not k.startswith("timing_s/")}
        rec["timing_s"] = {k[len("timing_s/"):]: v for k, v in metrics.items()
                           if k.startswith("timing_s/")}
        rec["frozen_after"] = {m: _digest(own(m)) for m in frozen}
        expert = whole("expert")
        rec["expert_after"] = _digest(expert)
        if save_expert:
            torch.save({k: v.detach().float().cpu() for k, v in expert.items()}, save_expert)

    t0 = time.perf_counter()
    if rank_chunks > 1:
        grpo_trainer.wm_logprob_reward = chunked_reward
    try:
        tr = main_vla_rft_grpo.run(argv, on_start, on_step_start, on_step_end)
    finally:
        grpo_trainer.wm_logprob_reward = real_reward
    rec["run_s"] = time.perf_counter() - t0
    rec["expect"] = _par_expect(tr, reward, rank_chunks)
    per = tr.dataset.cfg.batch_size // tr.data_count
    rec["rows"] = {"samples": per, "rollout_rows": per * N_ROLLOUTS,
                   "wm_rows": per * (N_ROLLOUTS + 1)}
    rec["mesh"] = {"world": tr.world, "data_index": tr.data_index, "data_count": tr.data_count,
                   "sharded_expert_leaves": len(getattr(tr, "_sharded", ())),
                   "fsdp_trees": [m for m in ("vla", "expert", "wm", "tokenizer", "lpips")
                                  if pm.is_sharded(getattr(tr.bundle, m))]}
    rec["ckpt_dirs"] = sorted(x for x in os.listdir(tr.config.trainer.default_local_dir)
                              if x.startswith("global_step_"))
    held.clear()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def _rank_grpo(payload: dict) -> dict:
    mods = _kernel_mods()
    rank = int(os.environ["RANK"])
    return _grpo_run(mods, payload["argv"], payload["reward"],
                     save_expert=payload["expert_file"] if rank == 0 else None)


def _qwen_loss(logits: torch.Tensor, valid: int, total: int) -> torch.Tensor:
    """sum over this rank's valid positions of logsumexp over the vocabulary,
    / (B x the whole sequence)."""
    return logits[:, :valid].float().logsumexp(-1).sum() / total


def _rank_qwen(payload: dict) -> dict:
    """Qwen2.5-0.5B at full width on two ranks: the unsharded route, then
    Ulysses (sp 2, the sequence padded to a multiple of 2), TP (tp 2,
    forward) and the GPipe pipeline (pp 2, 12 layers a stage, 2
    micro-batches); each route's logits, loss and (sp, pp) the gradient of
    the embedding output, with #1 / #2 / #3 launches counted per route."""
    import dataclasses as dc

    import torch.distributed as dist

    from vla_rft_tpu_torch.parallel import distributed as pd
    from vla_rft_tpu_torch.models.factory import build_decoder
    from vla_rft_tpu_torch.models.transformer import TransformerConfig
    from vla_rft_tpu_torch.ops import attention
    from vla_rft_tpu_torch.parallel import mesh as pm
    from vla_rft_tpu_torch.parallel.pp import decoder_pp_forward
    from vla_rft_tpu_torch.parallel.tp import shard_decoder_params_tp
    from vla_rft_tpu_torch.parallel.ulysses import ulysses_pad_and_slice

    r, W = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda:0")
    torch.cuda.reset_peak_memory_stats()  # this function's own peak
    cfg = TransformerConfig.qwen25_0_5b()
    B, S = PAR_QWEN_BATCH, WM_SFT_LEN
    gen = torch.Generator(device=dev).manual_seed(PAR_QWEN_SEED)
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)
    total = B * S
    out, held = {"rank": r}, {}

    def emb_grad(dec):
        """Keep the gradient of the embedding's output (the model's input)."""
        box = {}

        def hook(_m, _i, o):
            o.retain_grad()
            box["emb"] = o
        return box, dec.embed_tokens.register_forward_hook(hook)

    def route(name, fn):
        _zero_counts(attention)
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = {"launches": _counts(attention), "s": time.perf_counter() - t}
        held[name] = res

    dec = build_decoder(cfg, device=dev, seed=PAR_QWEN_SEED)

    def plain():
        box, h = emb_grad(dec)
        logits, _ = dec(ids)
        loss = _qwen_loss(logits, S, total)
        loss.backward()
        h.remove()
        return logits.detach(), loss.detach(), box["emb"].grad.detach()

    route("unsharded", plain)
    dec.zero_grad(set_to_none=True)

    # Ulysses: this rank's half of the padded sequence, global positions
    mesh_sp = pm.make_mesh(pm.MeshConfig(dp=1, sp=W), "cuda")
    sp_dec = build_decoder(dc.replace(cfg, ulysses_axis=mesh_sp["sp"].get_group()), device=dev,
                           seed=PAR_QWEN_SEED)
    ids_p, pad = ulysses_pad_and_slice(ids, W)
    s = ids_p.shape[1] // W
    sl = slice(r * s, (r + 1) * s)
    valid = min(s, S - r * s)

    def sp():
        box, h = emb_grad(sp_dec)
        pos = torch.arange(ids_p.shape[1], dtype=torch.int32, device=dev)[None].expand(B, -1)
        logits, _ = sp_dec(ids_p[:, sl], positions=pos[:, sl],
                           kv_lens=torch.full((B,), S, dtype=torch.int32, device=dev))
        loss = _qwen_loss(logits, valid, total)
        loss.backward()
        h.remove()
        whole = pd.all_reduce(loss.detach().clone())
        return logits.detach()[:, :valid], whole, box["emb"].grad.detach()[:, :valid]

    route("sp", sp)
    del sp_dec

    # TP: the split products on this rank's heads / columns / vocabulary
    mesh_tp = pm.make_mesh(pm.MeshConfig(dp=1, tp=W), "cuda")
    tp_dec = shard_decoder_params_tp(mesh_tp, build_decoder(cfg, device=dev,
                                                            seed=PAR_QWEN_SEED))

    def tp():
        with torch.no_grad():
            logits, _ = tp_dec(ids)
        return logits, _qwen_loss(logits, S, total)

    route("tp", tp)
    out["tp_local_heads"] = tp_dec.layers[0].self_attn.q_proj.weight.to_local().shape[0] // cfg.hd
    del tp_dec

    # the pipeline: the world is one pp group
    def pp():
        box, h = emb_grad(dec)
        logits, _ = decoder_pp_forward(dec, ids, dist.group.WORLD, n_microbatches=2)
        loss = _qwen_loss(logits, S, total)
        loss.backward()
        h.remove()
        return logits.detach(), loss.detach(), box["emb"].grad.detach()

    route("pp", pp)
    rel = lambda a, b: ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
    ref_logits, ref_loss, ref_grad = held["unsharded"]
    cmp = {}
    for name in ("sp", "tp", "pp"):
        got = held[name]
        want = ref_logits[:, sl][:, :valid] if name == "sp" else ref_logits
        cmp[name] = {"logits_rel_err": rel(got[0], want),
                     "loss_rel_err": abs(float(got[1]) - float(ref_loss)) / abs(float(ref_loss)),
                     "finite": bool(torch.isfinite(got[0]).all())}
        if name != "tp":
            gw = ref_grad[:, sl][:, :valid] if name == "sp" else ref_grad
            cmp[name]["input_grad_rel_err"] = rel(got[2], gw)
    out["compare"] = cmp
    out["sp_pad"], out["sp_rows_here"] = pad, valid
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def _kernel_mods():
    from vla_rft_tpu_torch.ops import attention
    from vla_rft_tpu_torch.ops import decode_attention as heads
    from vla_rft_tpu_torch.ops import decode_attention_hd as dec
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    return attention, dec, heads, fdl


def rank_main(task: str, d: str) -> int:
    """One rank of the parallel phase (started by _start_ranks)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vla_rft_tpu_torch.parallel import distributed as pd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    payload = torch.load(os.path.join(d, "in.pt"), weights_only=False)
    if task.startswith("probe:"):
        pd.initialize_distributed("gloo", "cuda")
        out = {}
        for op in task.split(":", 1)[1].split(","):
            out[op] = _rank_probe(op)["ok"]
            with open(os.path.join(d, f"progress{os.environ['RANK']}.txt"), "a") as f:
                f.write(f"{op}={int(out[op])}\n")
    elif task == "grpo":  # main_vla_rft_grpo.run starts and ends its own group
        out = _rank_grpo(payload)
    else:  # the Qwen2.5-0.5B pair: text RL, the sp / tp / pp routes, text SFT
        from vla_rft_tpu_torch.parallel import mesh as pm

        pd.initialize_distributed("gloo", "cuda")  # main_ppo.run then leaves it up
        text = _rank_text(payload)
        out = {**_rank_qwen(payload), "text": text,
               "sft": _par_sft_step(_kernel_mods()[0], payload["sft_file"],
                                    pm.MeshConfig(**payload["mesh"]))}
    torch.save(out, os.path.join(d, f"out{os.environ['RANK']}.pt"))
    pd.shutdown()
    return 0


def _step_agreement(got: dict, ref: dict, before: dict) -> dict:
    """The 2-rank expert update against the 1-rank one, leaf by leaf."""
    worst, far, total = 0.0, 0, 0
    for k, v in ref.items():
        step_r, step_g = v - before[k], got[k] - before[k]
        m = step_r.abs().max().item()
        d = (step_g - step_r).abs()
        if not d.max().item() <= 2 * m + 1e-12:
            raise AssertionError(f"parallel grpo: {k} steps {d.max().item()} apart, 1-rank "
                                 f"step {m}")
        worst = max(worst, d.max().item() / max(m, 1e-30))
        far += int((d > 1e-3 * m).sum())
        total += d.numel()
    if far / total > PAR_STEP_SHARE:
        raise AssertionError(f"parallel grpo: {far / total} of the expert's elements step "
                             f"apart from the 1-rank step")
    return {"max_rel_to_step": worst, "share_apart": far / total, "elements": total}


def _par_expect(tr, reward: str, rank_chunks: int = 1) -> dict:
    """A rank's launches in one step: with the int8 WM rollout ("wm")
    grpo_expect's (its rows make one WM call); with the teacher-forced WM
    reward ("wm_logprob") #1 for the Qwen encode and each chunk's WM
    forward."""
    if reward == "wm_logprob":
        b = tr.bundle
        return _expect(flash_fwd=b.vla_cfg.llm.num_layers
                       + rank_chunks * b.wm_cfg.num_layers)
    return grpo_expect(_kernel_mods()[3])(tr, None)


def _check_pair(name: str, ranks: list, start_digest: dict) -> dict:
    """What a 2-rank step must show on each rank: its exact launches, the
    experts bit-identical across ranks and every leaf moved from the common
    start, the frozen trees bit-identical, rank 0 alone checkpointing, and
    the two peaks under the card's 80 GiB."""
    if ranks[0]["expert_after"] != ranks[1]["expert_after"]:
        raise AssertionError(f"parallel grpo {name}: the ranks' experts differ")
    for r, rec in enumerate(ranks):
        if rec["launches"] != rec["expect"]:
            raise AssertionError(f"parallel grpo {name} rank {r}: launches {rec['launches']}, "
                                 f"expected {rec['expect']}")
        if rec["frozen_after"] != rec["frozen_before"] or rec["expert_before"] != start_digest:
            raise AssertionError(f"parallel grpo {name} rank {r}: a frozen leaf moved, or the "
                                 f"rank started from other weights")
        still = [k for k in rec["expert_after"] if rec["expert_after"][k] == start_digest[k]]
        if still:
            raise AssertionError(f"parallel grpo {name} rank {r}: expert leaves that did not "
                                 f"move {still[:5]}")
    if ranks[0]["ckpt_dirs"] != ["global_step_1"]:
        raise AssertionError(f"parallel grpo {name}: checkpoints {ranks[0]['ckpt_dirs']}")
    peaks = [rec["peak_mem_gib"] for rec in ranks]
    if not sum(peaks) < 80:
        raise AssertionError(f"parallel grpo {name}: peaks {peaks} GiB")
    return {"ranks": [{k: rec[k] for k in ("launches", "expect", "peak_mem_gib", "timing_s",
                                           "run_s", "rows", "mesh")} for rec in ranks],
            "experts_bit_identical_across_ranks": True, "frozen_bit_identical": True,
            "expert_leaves_moved": len(start_digest),
            "checkpoints_written": ranks[0]["ckpt_dirs"], "peak_mem_sum_gib": sum(peaks),
            "metrics": ranks[0]["metrics"]}


def _metrics_agree(name: str, got: dict, ref: dict, rtol: float, atol: dict) -> dict:
    """PAR_COMPARED (those both runs have) within rtol x |ref| + the metric's
    absolute floor; returns {metric: (got, ref)}."""
    pairs = {k: (got[k], ref[k]) for k in PAR_COMPARED if k in got and k in ref}
    far = {k: v for k, v in pairs.items()
           if not (np.isfinite(v[0]) and abs(v[0] - v[1]) <= rtol * abs(v[1]) + atol.get(k, 0.0))}
    if far:
        raise AssertionError(f"parallel grpo {name}: metrics (got, ref) apart {far}; all {pairs}")
    return pairs


def _parallel_grpo(mods, root: str, fsdp_ranks: int) -> dict:
    """The GRPO step at libero width over two ranks sharing the card.
    (a) The grpo phase's step (int8 WM: #1 / #4 / #8 / #9) over dp = 2 and
    over fsdp = 2: _check_pair.  (b) The step with the teacher-forced WM
    reward (trainer.reward_fn=wm_logprob: #1 alone) at 1 rank and over
    fsdp = 2 on the same global batch and draws: _check_pair, PAR_COMPARED
    within its bounds and _step_agreement.  Where gloo does not carry
    FSDP2's collectives, dp = 2 takes fsdp = 2's place in (b) and (a) runs
    at dp = 2 alone.  (a) is held to the 1-rank step through (b), which
    shares its sharded trees, reward gather, advantage and update: greedy
    decoding over random weights turns the bf16 differences of another
    batch shape (5 WM rows a call on a rank, 10 on one rank) into other
    tokens, and so other rewards, where (b)'s log-probs of the recorded
    future move by round-off only.  Even that round-off is of the order
    of a group's spread of rewards over random weights, and the advantages
    divide by that spread; and the tokenizer's convolutions on 2 samples
    and on 1 pick other tokens at some positions.  So the 1-rank step
    tokenizes and scores the ranks' chunks (`rank_chunks`), with the
    shapes each rank has."""
    lp = ["trainer.reward_fn=wm_logprob"]
    argv = lambda tag: _par_grpo_argv(tempfile.mkdtemp(prefix=f"{tag}_", dir=root))
    pair = lambda tag, extra, reward: _start_ranks("grpo", PAR_WORLD, {
        "argv": argv(tag) + extra + ["--backend=gloo"], "reward": reward,
        "expert_file": os.path.join(root, f"expert_{tag}.pt")}, root)
    load = lambda tag: torch.load(os.path.join(root, f"expert_{tag}.pt"), weights_only=True)
    fsdp = ["mesh.dp=1", "mesh.fsdp=2"]
    t0 = time.perf_counter()
    # at most four processes on the card at once (five LIBERO-width
    # processes exhaust its 80 GB): the dp = 2 WM step beside the 1-rank
    # teacher-forced step, then the fsdp = 2 WM and teacher-forced steps
    started = pair("dp2", ["mesh.dp=2"], "wm")
    one = _grpo_run(mods, argv("one_lp") + lp, "wm_logprob", keep_start=True,
                    save_expert=os.path.join(root, "expert_one_lp.pt"), rank_chunks=PAR_WORLD)
    gc.collect()
    torch.cuda.empty_cache()
    if one["launches"] != one["expect"]:
        raise AssertionError(f"parallel grpo one_lp: launches {one['launches']}, expected "
                             f"{one['expect']}")
    start = one["expert_before"]
    out = {"one_rank_wm_logprob": {k: one[k] for k in ("launches", "peak_mem_gib", "metrics",
                                                       "timing_s", "run_s", "rows")}}
    out["dp2"] = _check_pair("dp2", _wait_ranks(*started, 600.0), start)
    out["block_1_s"] = time.perf_counter() - t0
    lp_tag = "fsdp2_lp" if fsdp_ranks == 2 else "dp2_lp"
    started = [pair(lp_tag, (fsdp if fsdp_ranks == 2 else ["mesh.dp=2"]) + lp, "wm_logprob")]
    if fsdp_ranks == 2:
        started.append(pair("fsdp2", fsdp, "wm"))
    done = [_wait_ranks(*s, 600.0) for s in started]
    out["lp_pair"] = lp_tag
    out[lp_tag] = _check_pair(lp_tag, done[0], start)
    if fsdp_ranks == 2:
        out["fsdp2"] = _check_pair("fsdp2", done[1], start)
        for tag in ("fsdp2", lp_tag):
            m = out[tag]["ranks"][0]["mesh"]
            if not (m["sharded_expert_leaves"] and "wm" in m["fsdp_trees"]):
                raise AssertionError(f"parallel grpo {tag}: nothing sharded {m}")
    out["lp_pair_vs_one_rank"] = {
        "metrics": _metrics_agree(f"{lp_tag} vs 1 rank", out[lp_tag]["metrics"],
                                  one["metrics"], WM_LOGIT_TOL, PAR_ATOL),
        "expert": _step_agreement(load(lp_tag), load("one_lp"), one["expert_start"])}
    out["tolerance"] = {
        "lp_pair_vs_one_rank": f"|d| <= {WM_LOGIT_TOL} |1-rank| + {PAR_ATOL} (absolute floors)",
        "expert_step": f"max|d| <= 2 max|step| per leaf, share of elements > 1e-3 max|step| "
                       f"apart <= {PAR_STEP_SHARE}"}
    out["wall_s"] = time.perf_counter() - t0
    return out


# text RL and text SFT over two ranks at Qwen2.5-0.5B width.  The pair's
# main_ppo step: grpo with the value-head RM over the mixed prompts (a gsm8k
# prompt and one that no rule scores, so that over random weights the
# rewards and the advantages are not all 0), PAR_TEXT_PROMPTS x n = 16 rows
# at TEXT_R_CUT tokens, remat, one mini-batch of all 32 rows (each rank
# takes 16: the update's metrics are on-policy, so that the 1-rank
# comparison does not see a second mini-batch's log-probs moved by another
# first update), the raised lr (every bf16 parameter moves);
# the SFT step: B 4 x 1663 of Qwen's vocabulary, SFT_TEXT_KV_LENS valid
# tokens a row, labels on each row's second half
PAR_TEXT_PROMPTS, PAR_SFT_SEED = 2, 31


def _par_text_argv(ckpt: str, prompts: str) -> list:
    return [f"actor_rollout_ref.model.ckpt_path={ckpt}", f"data.train_files={prompts}",
            "trainer.total_training_steps=1", f"data.train_batch_size={PAR_TEXT_PROMPTS}",
            f"actor_rollout_ref.rollout.response_length={TEXT_R_CUT}",
            "actor_rollout_ref.model.enable_gradient_checkpointing=true",
            f"actor_rollout_ref.actor.ppo_mini_batch_size={PAR_TEXT_PROMPTS * TEXT_N}",
            f"actor_rollout_ref.actor.optim.lr={PPO_RAISED_LR}", "reward_model.enable=True"]


def _par_sft_batch() -> dict:
    rng = np.random.default_rng(PAR_SFT_SEED)
    lens = np.asarray(SFT_TEXT_KV_LENS)[:, None]
    pos = np.arange(WM_SFT_LEN)[None]
    ids = rng.integers(0, TEXT_VOCAB, (len(SFT_TEXT_KV_LENS), WM_SFT_LEN)).astype(np.int32)
    labels = np.where((pos < lens) & (pos >= lens // 2), ids, -100).astype(np.int32)
    return {"input_ids": ids, "labels": labels, "attention_mask": (pos < lens).astype(np.int32)}


def _par_sft_step(attention, llm_file=None, mesh=None) -> dict:
    """One SFTTrainer step of Qwen2.5-0.5B (seed PAR_SFT_SEED) on
    _par_sft_batch, over `mesh` (a MeshConfig; None: the world), at lr
    PPO_RAISED_LR (Adam's first step moves a weight by about lr, above
    bf16's round-off): the loss, the launches counted from 0 around the
    step, seconds, peak memory.  Over ranks, rank 0 writes the decoder
    after the step (gathered whole) to `llm_file`; at world 1 the decoder
    before and after the step are `weights`."""
    from vla_rft_tpu_torch.models.transformer import TransformerConfig
    from vla_rft_tpu_torch.parallel import distributed as pd
    from vla_rft_tpu_torch.parallel import mesh as pm
    from vla_rft_tpu_torch.trainer.sft_trainer import SFTTrainer

    tr = SFTTrainer(TransformerConfig.qwen25_0_5b(), lr=PPO_RAISED_LR, device="cuda",
                    seed=PAR_SFT_SEED, mesh=mesh)
    copy = lambda sd: {k: v.detach().clone() for k, v in sd.items()}
    before = copy(tr.llm.state_dict()) if llm_file is None else None
    batch = _par_sft_batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts(attention)  # the main path starts here
    t = time.perf_counter()
    loss = tr.training_step(batch)
    torch.cuda.synchronize()
    out = {"loss": loss, "launches": _counts(attention), "s": time.perf_counter() - t,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "sharded": pm.is_sharded(tr.llm), "data": [tr.ranks.index, tr.ranks.count]}
    if llm_file is None:
        out["weights"] = {"before": before, "after": copy(tr.llm.state_dict())}
    else:
        after = pm.full_state_dict(tr.llm)  # a collective: every rank gathers
        if pd.rank() == 0:
            torch.save({k: v.cpu() for k, v in after.items()}, llm_file)
        del after
    del tr, before
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _record_step(tr, seen: dict, rollout_file=None) -> None:
    """Keep the step's global batch, rollout, token-level rewards and
    advantages in `seen`; with `rollout_file`, write the batch and the
    rollout there as soon as they are drawn (the 1-rank step's input)."""
    adv, rollout, sample = tr._advantages, tr._rollout, tr.dataset.sample_batch

    def drawn(b):
        seen["batch"] = sample(b)
        return seen["batch"]

    def rolled(fn, prompts, gen, n=1):
        out = rollout(fn, prompts, gen, n)
        if fn == tr._gen and rollout_file:
            part = rollout_file + ".part"
            torch.save({"batch": seen["batch"],
                        "rollout": {k: v.cpu() for k, v in out.items()}}, part)
            os.replace(part, rollout_file)
        return out

    def kept(*a, **kw):
        out = adv(*a, **kw)
        seen["rewards"], seen["advantages"] = a[2].float().cpu(), out[0].float().cpu()
        return out

    tr._advantages, tr._rollout, tr.dataset.sample_batch = kept, rolled, drawn


def _step_record(rec: dict, seen: dict) -> dict:
    """What `_par_text_check` reads of one step of `_drive_ppo`'s record."""
    (step,) = rec["steps"]
    m = step["metrics"]
    return {"metrics": {k: v for k, v in m.items() if not k.startswith("timing_s/")},
            "timing_s": {k[9:]: v for k, v in m.items() if k.startswith("timing_s/")},
            "launches": step["launches"], "step_s": step["s"],
            "peak_mem_gib": step["peak_mem_gib"],
            "old_logp": rec["logp"]["policy"][0].float().cpu(),
            "ref_logp": rec["logp"]["ref"][0].float().cpu(),
            "rewards": seen["rewards"], "advantages": seen["advantages"]}


def _rank_text(payload: dict) -> dict:
    """A rank's text-RL step (the process group is up, gloo, over
    payload["mesh"]): main_ppo.run's one sampled step, taken once
    payload["go_file"] exists (the run is built and loaded before), launches counted
    from 0 around it, its log-probs, rewards, advantages and metrics, the
    digests of this rank's shards of the reference policy before and after
    it, the policy's whole digest after it (gathered with whole_like; rank
    0 also writes it whole, and the step's global rollout and batch, for
    the 1-rank step), peak memory."""
    from vla_rft_tpu_torch.ops import fused_decode_attention as fda
    from vla_rft_tpu_torch.parallel import mesh as pm

    mods = _kernel_mods()
    rank = int(os.environ["RANK"])
    mesh = payload["mesh"]
    own = lambda m: {k: pm.local(v) for k, v in m.state_dict().items()}
    held, seen = {}, {}
    t0 = time.perf_counter()

    def on_load(tr, rec):
        held["ref"] = _digest(own(tr.ref))
        _record_step(tr, seen, payload["rollout_file"] if rank == 0 else None)
        deadline = time.perf_counter() + 900.0
        while not os.path.exists(payload["go_file"]):  # the card is the GRPO pairs' till then
            if time.perf_counter() > deadline:
                raise AssertionError("parallel text: no go from the phase")
            time.sleep(0.2)
        held["go"] = time.perf_counter() - t0

    rec = _drive_ppo(mods, fda, payload["argv"] + [f"mesh.{k}={v}" for k, v in mesh.items()]
                     + ["--backend=gloo"], None, on_load=on_load)
    tr = rec.pop("trainer")
    policy = pm.full_state_dict(tr.llm)  # a collective: both ranks gather
    out = {**_step_record(rec, seen), "setup_s": held["go"],
           "run_s": time.perf_counter() - t0,
           "data": [tr.ranks.index, tr.ranks.count], "policy_digest": _digest(policy),
           "ref_unmoved": _digest(own(tr.ref)) == held["ref"],
           "sharded": {n: pm.is_sharded(x) for n, x in (("policy", tr.llm), ("ref", tr.ref),
                                                        ("rm", tr.rm))}}
    if rank == 0:
        torch.save({k: v.cpu() for k, v in policy.items()}, payload["policy_file"])
    del policy, tr, rec
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _par_text_one_rank(mods, fda, argv: list, written: dict, rollout_file: str) -> dict:
    """The pair's main_ppo step on this process alone (world 1), from the
    same checkpoint on the pair's rollout and batch (`rollout_file`, all
    its rows)."""
    given = torch.load(rollout_file, weights_only=False)
    g = {k: v.cuda() for k, v in given["rollout"].items()}
    seen = {}

    def on_load(tr, rec):
        def rows(prompts, _gen):
            if not torch.equal(prompts.to(torch.int32), g["prompts"]):
                raise AssertionError("parallel text: the prompts are not the rollout's")
            return {k: v.clone() for k, v in g.items()}

        tr._gen, tr.dataset.sample_batch = rows, lambda b: given["batch"]
        _record_step(tr, seen)

    rec = _drive_ppo(mods, fda, argv, written, on_load)
    tr = rec.pop("trainer")
    out = {**_step_record(rec, seen), "loaded_bit_equal": rec["loaded_bit_equal"],
           "policy": {k: v.detach().clone() for k, v in tr.llm.state_dict().items()}}
    del tr, rec, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tensors_agree(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float) -> float:
    """max|got - ref| <= WM_LOGIT_TOL x max|ref| + atol (PAR_COMPARED's rule
    on a tensor), or raise; returns the max difference."""
    d = (got.float() - ref.float()).abs().max().item()
    if not d <= WM_LOGIT_TOL * ref.float().abs().max().item() + atol:
        raise AssertionError(f"parallel text {name}: max|d| {d}, 1-rank max "
                             f"{ref.float().abs().max().item()}")
    return d


def _par_text_check(ranks: list, one: dict, config, written: dict, policy_file: str,
                    sft_file: str) -> dict:
    """The pair against its bounds: (a) launches per rank = its share of
    `_rm_expect`, the policy bit-identical across the ranks, the reference
    policy unmoved, metrics finite, the peaks; against the 1-rank step on
    the same rollout from the same weights (its launches `_rm_expect`'s
    without the rollout's), the log-probs, rewards, advantages and
    PAR_COMPARED's metrics within PAR_COMPARED's rule, the updated policy
    within 2 x the 1-rank step (`_step_agreement`); (b) each rank's SFT
    loss within SFT_LOSS_TOL of the 1-rank step's, 24 / 24 / 24 launches,
    and the pair's updated decoder (`sft_file`) within 2 x the 1-rank
    step."""
    L, R = 24, config.actor_rollout_ref.rollout.response_length
    expect = _rm_expect(PAR_TEXT_PROMPTS, config, "value_head", ranks=PAR_WORLD)
    one_expect = _rm_expect(PAR_TEXT_PROMPTS, config, "value_head")
    one_expect = {**one_expect, "flash_fwd": one_expect["flash_fwd"] - L,
                  "decode_hd": one_expect["decode_hd"] - L * R}
    if ranks[0]["text"]["policy_digest"] != ranks[1]["text"]["policy_digest"]:
        raise AssertionError("parallel text: the ranks' policies differ after the step")
    for r, rec in enumerate(ranks):
        a = rec["text"]
        if a["launches"] != expect:
            raise AssertionError(f"parallel text rank {r}: launches {a['launches']}, expected "
                                 f"{expect}")
        if not (a["ref_unmoved"] and np.isfinite(list(a["metrics"].values())).all()
                and all(a["sharded"].values())):
            raise AssertionError(f"parallel text rank {r}: {a}")
        sft = rec["sft"]
        if sft["launches"] != {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L} or not (
                abs(sft["loss"] - one["sft"]["loss"]) <= SFT_LOSS_TOL * abs(one["sft"]["loss"])):
            raise AssertionError(f"parallel text sft rank {r}: {sft} vs 1 rank {one['sft']}")
    if not one["loaded_bit_equal"] or one["launches"] != one_expect:
        raise AssertionError(f"parallel text 1 rank: launches {one['launches']}, expected "
                             f"{one_expect}")
    peaks = [r["text"]["peak_mem_gib"] for r in ranks]
    if not sum(peaks) < 80:
        raise AssertionError(f"parallel text: peaks {peaks} GiB")
    c = ranks[0]["text"]
    diffs = {"old_logp": _tensors_agree("old_logp", c["old_logp"], one["old_logp"], 0.0),
             "ref_logp": _tensors_agree("ref_logp", c["ref_logp"], one["ref_logp"], 0.0),
             "rewards": _tensors_agree("rewards", c["rewards"], one["rewards"], 1e-4),
             "advantages": _tensors_agree("advantages", c["advantages"], one["advantages"],
                                          1e-4)}
    if not one["rewards"].abs().max() > 0:
        raise AssertionError("parallel text: the 1-rank rewards are all 0")
    pairs = _metrics_agree("text fsdp2 vs 1 rank", c["metrics"], one["metrics"], WM_LOGIT_TOL,
                           PAR_ATOL)
    dev = lambda sd: {k: v.cuda().float() for k, v in sd.items()}
    policy = dev(torch.load(policy_file, weights_only=True))
    step = _step_agreement(policy, dev(one["policy"]), dev(written))
    del policy
    one_sft = one["sft"].pop("weights")
    sft_step = _step_agreement(dev(torch.load(sft_file, weights_only=True)),
                               dev(one_sft["after"]), dev(one_sft["before"]))
    del one_sft
    torch.cuda.empty_cache()
    strip = lambda x: {k: v for k, v in x.items()
                       if k not in ("policy", "sft") and not isinstance(v, torch.Tensor)}
    return {"prompts": PAR_TEXT_PROMPTS, "rows": PAR_TEXT_PROMPTS * TEXT_N,
            "response_length": R, "expected_launches_per_rank": expect,
            "ranks": [strip(r["text"]) for r in ranks],
            "policy_bit_identical_across_ranks": True, "reference_policy_unmoved": True,
            "one_rank_on_the_pair_rollout": {**strip(one), "expected_launches": one_expect},
            "vs_one_rank": {"max_abs_diff": diffs, "metrics": pairs, "policy": step},
            "sft": {"ranks": [r["sft"] for r in ranks], "one_rank": one["sft"],
                    "decoder_vs_one_rank": sft_step, "tolerance": SFT_LOSS_TOL},
            "tolerance": {"tensors": f"max|d| <= {WM_LOGIT_TOL} max|1-rank| + 1e-4 (rewards, "
                                     f"advantages) or + 0 (log-probs)",
                          "metrics": f"|d| <= {WM_LOGIT_TOL} |1-rank| + {PAR_ATOL}",
                          "policy_and_sft_decoder": f"max|d| <= 2 max|step| per leaf, share "
                                                    f"of elements > 1e-3 max|step| apart <= "
                                                    f"{PAR_STEP_SHARE}"}}


def phase_parallel(mods) -> dict:
    """parallel/ on the card: the gloo probe, the GRPO step at libero width
    over dp = 2 and fsdp = 2 ranks sharing the card (_parallel_grpo), and
    the Qwen2.5-0.5B pair: text RL and text SFT over fsdp = 2 against the
    1-rank steps (`_rank_text`, `_par_text_check`) and the Ulysses / TP /
    pipeline routes against the unsharded route."""
    from vla_rft_tpu_torch.parallel import distributed as pd

    attention = mods[0]
    root = tempfile.mkdtemp(prefix="parallel_")
    try:
        probe = probe_gloo(root)
        fsdp_ranks = 2 if all(probe[op] == "carried" for op in FSDP_NEEDS) else 1
        axes = {
            "dp": {"ranks": 2, "why": "the trainer's all-reduces and all-gathers: gloo on "
                                      "CUDA"},
            "fsdp": {"ranks": fsdp_ranks,
                     "why": ("FSDP2 runs on gloo's CUDA collectives" if fsdp_ranks == 2 else
                             "FSDP2's all_gather_into_tensor / reduce_scatter_tensor: gloo "
                             f"{probe['all_gather_into_tensor']} / "
                             f"{probe['reduce_scatter_tensor']} on CUDA, and NCCL refuses two "
                             "ranks on one card; the GRPO steps run at dp = 2 alone")},
            "sp": {"ranks": 2, "why": "the port's all-to-alls: gloo on CUDA"},
            "tp": {"ranks": 2, "why": "the port's all-reduces and its logits all-gather: gloo "
                                      "on CUDA"},
            "pp": {"ranks": 2, "why": "the port's sends / receives (staged) and broadcasts "
                                      "(gloo on CUDA)"}}
        emit({"parallel_backends": probe, "axes": axes,
              "staged_by_the_port": [op for op in ("all_reduce", "broadcast", "all_gather",
                                                   "all_to_all", "send", "recv")
                                     if op not in pd.GLOO_CUDA]})

        # the Qwen2.5-0.5B pair (fsdp 2; dp 2 where gloo does not carry
        # FSDP2's collectives): it starts here and builds and loads
        # main_ppo's run beside the GRPO pairs, then (after them: the go
        # file) takes its sampled step, whose rollout the 1-rank step here
        # takes as soon as it is written, the sp / tp / pp routes, and one
        # text SFT step (the 1-rank one after the pair)
        from vla_rft_tpu_torch.config import vla_rft_default_config
        from vla_rft_tpu_torch.ops import fused_decode_attention as fda

        ckpt, _, written, _, _, _ = write_text_inputs(root)
        mixed = os.path.join(root, "mixed.parquet")
        _write_mixed_prompts(mixed)
        text_argv = _par_text_argv(ckpt, mixed)
        text_files = {k: os.path.join(root, f"text_{k[:-5]}.pt")
                      for k in ("rollout_file", "policy_file", "go_file", "sft_file")}
        pair = _start_ranks("qwen", PAR_WORLD, {
            "argv": text_argv, **text_files,
            "mesh": {"dp": 1, "fsdp": 2} if fsdp_ranks == 2 else {"dp": 2}}, root)

        grpo = _parallel_grpo(mods, root, fsdp_ranks)

        t_pair = time.perf_counter()
        open(text_files["go_file"], "w").close()
        deadline = time.perf_counter() + 600.0
        while not os.path.exists(text_files["rollout_file"]):
            if time.perf_counter() > deadline or any(p.poll() is not None for p, _ in pair[0]):
                _wait_ranks(*pair, 1.0)  # raises with the ranks' logs
                raise AssertionError("parallel text: no rollout from the pair")
            time.sleep(0.5)
        t_one = time.perf_counter()
        one_text = _par_text_one_rank(mods, fda, text_argv, written, text_files["rollout_file"])
        one_s = time.perf_counter() - t_one
        qwen = _wait_ranks(*pair, 600.0)
        pair_s = time.perf_counter() - t_pair
        one_text["sft"] = _par_sft_step(attention)  # alone: 30 GiB at its peak
        text = _par_text_check(qwen, one_text,
                               vla_rft_default_config().apply_overrides(text_argv), written,
                               text_files["policy_file"], text_files["sft_file"])
        text.update(mesh="fsdp2" if fsdp_ranks == 2 else "dp2", pair_s=pair_s, one_rank_s=one_s)
        del one_text, written
        r0 = text["ranks"][0]
        print(f"[parallel] Qwen pair {pair_s:.1f} s: text step {r0['step_s']:.1f} s, "
              f"{r0['peak_mem_gib']:.2f} GiB a rank; 1-rank steps {one_s:.1f} s; SFT loss "
              f"{text['sft']['ranks'][0]['loss']:.6f} vs {text['sft']['one_rank']['loss']:.6f}, "
              f"decoder {text['sft']['decoder_vs_one_rank']['share_apart']:.4f} apart",
              flush=True)
        L = 24
        want = {"unsharded": (L, L, L), "sp": (L, L, L), "tp": (L, 0, 0), "pp": (L, L, L)}
        for r, q in enumerate(qwen):
            for name, (f, dq_, dkv) in want.items():
                n = q[name]["launches"]
                if n != {"flash_fwd": f, "flash_bwd_dq": dq_, "flash_bwd_dkv": dkv}:
                    raise AssertionError(f"qwen {name} rank {r}: launches {n}")
            for name, c in q["compare"].items():
                bad = (not c["finite"] or c["logits_rel_err"] > SFT_GRAD_TOL
                       or c["loss_rel_err"] > SFT_LOSS_TOL
                       or c.get("input_grad_rel_err", 0.0) > SFT_GRAD_TOL)
                if bad:
                    raise AssertionError(f"qwen {name} rank {r}: {c}")
            if q["tp_local_heads"] != 7:
                raise AssertionError(f"qwen tp: {q['tp_local_heads']} local heads")
        # #1 / #2 / #3 at the shapes sp and tp give them: Qwen 14/2 -> 7/1 a
        # rank (2 x 1663), the WM's prefill 16/16 -> 8/8 (no path splits the WM)
        gen = torch.Generator(device="cuda").manual_seed(23)
        timed = {"qwen_7_1": time_flash(attention, gen, "qwen_7_1", PAR_QWEN_BATCH, WM_SFT_LEN,
                                        WM_SFT_LEN, 7, 1, WM_SFT_LEN),
                 "wm_prefill_8_8": time_flash(attention, gen, "wm_prefill_8_8", 2, WM_PREFIX,
                                              1152, 8, 8, WM_PREFIX),
                 "qwen_7_1_bwd": time_flash_bwd(attention, gen, "qwen_7_1", PAR_QWEN_BATCH,
                                                WM_SFT_LEN, 7, 1, WM_SFT_LEN, check=True)}
    finally:
        _stop_ranks()
        shutil.rmtree(root, ignore_errors=True)
    out = {"phase": "parallel", "world": PAR_WORLD, "device_per_rank": "cuda:0 (LOCAL_RANK % 1)",
           "backends": probe, "axes": axes, "grpo": grpo, "text": text,
           "qwen": {"batch": PAR_QWEN_BATCH, "seq": WM_SFT_LEN,
                    "ranks": [{k: v for k, v in q.items() if k not in ("text", "sft")}
                              for q in qwen],
                    "tolerance": {"logits_and_input_grad_rel": SFT_GRAD_TOL,
                                  "loss_rel": SFT_LOSS_TOL}},
           "timed": timed}
    emit(out)
    return out


def ppo_entries(ppo: dict, entry, bwd_src: str, rm: dict, par: dict) -> list:
    """The kernel line's rows of #2 and #3 at the PPO update's shape (PRIME's
    RM update's micro-batches have it too), with the parallel phase's text
    step's launches a rank."""
    t, n = ppo["update_shape_bwd"], ppo["grpo"]["launches"]
    S, kv = TEXT_PROMPT + TEXT_R, t["dq"]["kv_starts"]
    return [{**entry(f"{kernel}@ppo", bwd_src, f"vla_rft_tpu/ops/attention.py:{line}",
                     n[kernel], t["max_abs_err"][key] if key == "dq" else
                     max(t["max_abs_err"]["dk"], t["max_abs_err"]["dv"]), t[key]),
             "shape": f"B={t[key]['B']} S={S} Hq/Hkv=14/2 D=64 causal, left-padded (kv_starts "
                      f"{min(kv)}-{max(kv)}), ragged ends: the PPO update's shape, the step's "
                      f"rows one per prompt; launches: one main_ppo grpo step (16 updates x "
                      f"24 layers); reward_models_prime_step_launches: one PRIME step "
                      f"({PRIME_PROMPTS} RM and {PRIME_PROMPTS} actor updates of 16 rows x 24 "
                      f"layers)",
             "gae_step_launches": ppo["gae"]["launches"][kernel],
             **_rm_launches(rm, kernel), **_par_text_launches(par, kernel)}
            for kernel, line, key in (("flash_bwd_dq", 175, "dq"), ("flash_bwd_dkv", 239, "dkv"))]


def _par_text_launches(par: dict, kernel: str) -> dict:
    """The parallel phase's text step's launches of `kernel`, a rank."""
    return {"parallel_text_step_launches_per_rank": par["text"]["ranks"][0]["launches"][kernel]}


def _rm_launches(rm: dict, kernel: str) -> dict:
    """The reward_models phase's launches of `kernel`, per step."""
    return {f"reward_models_{k}_step_launches": rm[k]["launches"][kernel]
            for k in ("prime", "value_head", "dpo")}


def text_entries(text: dict, entry, flash_src: str, dec_src: str, ppo: dict, rm: dict,
                 par: dict) -> list:
    """The kernel line's rows of the text_gen phase's shapes, with the ppo,
    reward_models and parallel phases' launches of #1 and #5 (their update
    forwards have the log-prob row's shape)."""
    t, gen = text["timed"], text["main_generation"]
    ppo_n = {"ppo_grpo_step_launches": ppo["grpo"]["launches"]["flash_fwd"],
             "ppo_validate_launches": ppo["grpo"]["validate"]["launches"]["flash_fwd"]}
    P, S = TEXT_PROMPT, TEXT_PROMPT + TEXT_R
    shape = lambda key, desc: {"shape": desc, "kv_starts": t[key].get("kv_starts")}
    return [
        {**entry("flash_fwd@text_prefill", flash_src, "vla_rft_tpu/ops/attention.py:108",
                 gen["launches"]["flash_fwd"], t["text_prefill"]["max_abs_err_o"],
                 t["text_prefill"]),
         **shape("text_prefill", f"B=256 Sq={P} Sk=1664 kv_lens={P} Hq/Hkv=14/2 D=64 causal, "
                                 f"left-padded (kv_starts per prompt, x16 rows); launches: "
                                 f"one main_generation batch (16 prompts x n=16)")},
        {**entry("flash_fwd@text_logprob", flash_src, "vla_rft_tpu/ops/attention.py:108",
                 text["compute_log_probs"]["launches"]["flash_fwd"],
                 t["text_logprob"]["max_abs_err_o"], t["text_logprob"]),
         **shape("text_logprob", f"B=16 Sq=Sk={S} Hq/Hkv=14/2 D=64 causal, left-padded, "
                                 f"ragged valid ends; launches: one compute_log_probs call "
                                 f"(log_prob_micro_batch_size_per_gpu=16); ppo_*: #1's "
                                 f"launches in a main_ppo grpo step (prefill, 16 + 32 "
                                 f"log-prob chunks of 16 / 8 rows, 16 update forwards) "
                                 f"and in validate(); reward_models_*: #1's launches in "
                                 f"its steps (every shape); parallel_text_*: a rank's in "
                                 f"the parallel phase's text step"), **ppo_n,
         **_rm_launches(rm, "flash_fwd"), **_par_text_launches(par, "flash_fwd")},
        {**entry("flash_fwd@text_logprob_b8", flash_src, "vla_rft_tpu/ops/attention.py:108",
                 rm["prime"]["launches"]["flash_fwd"], t["text_logprob_b8"]["max_abs_err_o"],
                 t["text_logprob_b8"]),
         **shape("text_logprob_b8", f"B=8 Sq=Sk={S} Hq/Hkv=14/2 D=64 causal, left-padded, "
                                    f"ragged valid ends: the reference policy's log-prob "
                                    f"chunks (ref.log_prob_micro_batch_size_per_gpu=8), "
                                    f"PRIME's reference's at temperature 1; launches: one "
                                    f"reward_models PRIME step (every shape); "
                                    f"launches_at_this_shape: that step's launches of 8 "
                                    f"rows"),
         "launches_at_this_shape": rm["prime"]["flash_fwd_by_rows"][8]},
        {**entry("decode_hd@text_b256", dec_src, "vla_rft_tpu/ops/decode_attention_hd.py:272",
                 gen["launches"]["decode_hd"], t["text_b256"]["max_abs_err"], t["text_b256"]),
         "shape": f"B=256 Sq=1 Hq/Hkv=14/2 D=64 bf16 hd cache (256, 1664, 128), step "
                  f"{TEXT_MID} (kv_len {P + TEXT_MID + 1}), per-row kv_starts; launches: one "
                  f"main_generation batch ({TEXT_R} decode calls x 24 layers); "
                  f"ppo_grpo_step_launches: the main_ppo grpo step's rollout (the same), "
                  f"reward_models_*: its steps' rollouts",
         "ppo_grpo_step_launches": ppo["grpo"]["launches"]["decode_hd"],
         **_rm_launches(rm, "decode_hd"), **_par_text_launches(par, "decode_hd")},
        {**entry("decode_shared_hd@text_b256", dec_src,
                 "vla_rft_tpu/ops/decode_attention_hd.py:226",
                 text["prefix_shared"]["launches"]["decode_shared_hd"],
                 t["text_shared_b256"]["max_abs_err"], t["text_shared_b256"]),
         "shape": f"B=256 Sq=1 Hq/Hkv=14/2 D=64 bf16, 16 prefixes of {P} (16 rows each, "
                  f"shared_starts = kv_starts) + own (256, {TEXT_R}, 128), step {TEXT_MID}; "
                  f"launches: generate_sequences(prefix_share_n=16) at 256 rows, "
                  f"{TEXT_R_CMP} decode steps"},
    ]


def eval_entries(ev: dict, entry, flash_src: str) -> list:
    """The kernel line's rows of #1 at the eval phase's 2- and 3-view request
    shapes, with that phase's launches."""
    rows = []
    for name, part, desc in (
            ("libero_eval_2view", ev["libero_main_eval"],
             "main_eval --scripted_env at its defaults (2 views, center crop)"),
            ("aloha_3view", ev["aloha"],
             f"the ALOHA harness through the action server ({ALOHA_ROLLOUTS} rollouts x "
             f"{ALOHA_STEPS} steps)")):
        t = ev["timed"][name]
        rows.append({**entry(f"flash_fwd@{name}", flash_src, "vla_rft_tpu/ops/attention.py:108",
                             part["launches"]["flash_fwd"], t["max_abs_err_o"], t),
                     "shape": f"B=1 Sq=Sk={t['Sq']} Hq/Hkv=14/2 D=64 causal: a "
                              f"{part['views']['views']}-view request (text + "
                              f"{part['views']['views']} x 256 patches); launches: {desc}, "
                              f"{part['queries']} queries x {part['launches_per_query']}"})
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    sys.path.append(os.path.join(root, "tests"))  # sft_data.py: the SFT phases' files
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
    build = timed("build", phase_build)
    flash = timed("flash", phase_flash, attention)
    flash_bwd = timed("flash_bwd", phase_flash_bwd, attention)
    decode = timed("decode", phase_decode, dec)
    decode_heads = timed("decode_heads", phase_decode, heads, True)
    fused_attn = timed("fused_decode_attention", phase_fused_decode_attention, fda, heads)
    fused = timed("fused_decode", phase_fused_decode, fdl)
    serving = timed("serving", phase_serving, attention)
    ev = timed("eval", phase_eval, attention)
    wm = timed("wm_reward", phase_wm_reward, mods)
    plain = timed("wm_plain", phase_wm_plain, mods, wm)
    wm["plain_tokens"] = plain["tokens"]
    plain_heads = timed("wm_plain_heads", phase_wm_plain, mods, wm, True)
    timed("wm_kernel_vs_plain", phase_wm_kernel_vs_plain, wm)
    wm_launches = wm["json"]["run"]["launches"]
    del wm  # frees the WM reward models before the training phases
    torch.cuda.empty_cache()
    grpo = timed("grpo", phase_grpo, mods)
    torch.cuda.empty_cache()
    grpo_heads = timed("grpo_heads", phase_grpo_heads, mods)
    torch.cuda.empty_cache()
    variants = timed("grpo_variants", phase_grpo_variants, mods)
    torch.cuda.empty_cache()
    timed("grpo_pretrained", phase_grpo_pretrained, mods)
    torch.cuda.empty_cache()
    rlds = timed("grpo_rlds", phase_grpo_rlds, mods, build)
    torch.cuda.empty_cache()
    par = timed("parallel", phase_parallel, mods)
    torch.cuda.empty_cache()
    sft = timed("sft", phase_sft, attention)
    sft_text = timed("sft_text", phase_sft_text, attention)
    sft_align = timed("sft_align", phase_sft_align, attention)
    torch.cuda.empty_cache()
    text = timed("text_gen", phase_text_gen, mods, fda)
    ppo = timed("ppo", phase_ppo, mods, fda)
    rm = timed("reward_models", phase_reward_models, mods, fda)
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
    text_n, align_n = sft_text["launches_total"], sft_align["launches_total"]
    n_align = sum(len(r["steps"]) for r in sft_align["runs"].values())
    vla_n = {k: adapter_n[k] + align_n[k] for k in adapter_n}
    bwd_entries = []
    for kernel, line, key in (("flash_bwd_dq", 175, "dq"), ("flash_bwd_dkv", 239, "dkv")):
        for shape, n, desc in (("vla_adapter", vla_n,
                                f"B=16 S=352 (351 valid) Hq/Hkv=14/2 D=64 causal; launches: "
                                f"{SFT_STEPS} vla_adapter steps and {n_align} sft_align steps "
                                f"(B=16 S=352, caption rows of other lengths)"),
                               ("wm_sft", wm_n, "B=4 S=1663 Hq=Hkv=16 D=64 causal; 1 step"),
                               ("sft_text", text_n,
                                f"B={SFT_TEXT_BATCH} S=1663 kv_lens={SFT_TEXT_KV_LENS} "
                                f"Hq/Hkv=14/2 D=64 causal; launches: {SFT_TEXT_STEPS} sft_text "
                                f"steps (their own ragged rows)")):
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
    logprob_n = variants["wm_logprob"]["steps"][0]["launches"]
    spec_n = variants["spec"]["steps"][0]["launches"]
    spec_roll = variants["spec"]["rollout"]
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
    # the parallel phase: a rank's launches in the 2-rank WM steps, and in
    # the Qwen routes (sp / tp / pp forward, sp / pp backward) on rank 0
    par_n = par["grpo"]["dp2"]["ranks"][0]["launches"]
    par_fsdp_n = (par["grpo"]["fsdp2"]["ranks"][0]["launches"] if "fsdp2" in par["grpo"]
                  else None)
    q0 = par["qwen"]["ranks"][0]
    qwen_fwd = sum(q0[r]["launches"]["flash_fwd"] for r in ("sp", "tp", "pp"))
    qwen_bwd = {k: sum(q0[r]["launches"][k] for r in ("sp", "pp"))
                for k in ("flash_bwd_dq", "flash_bwd_dkv")}
    par_shape = (f"B=2 S=1663 Hq/Hkv=7/1 D=64 causal: a rank's heads of Qwen2.5-0.5B under "
                 f"sp = 2 (the sequence padded to 1664) or tp = 2; launches: rank 0 of the "
                 f"parallel phase's sp, tp and pp routes")
    par_entries = [
        {**entry("flash_fwd@qwen_7_1", flash_src, "vla_rft_tpu/ops/attention.py:108", qwen_fwd,
                 par["timed"]["qwen_7_1"]["max_abs_err_o"], par["timed"]["qwen_7_1"]),
         "shape": par_shape},
        {**entry("flash_fwd@wm_prefill_8_8", flash_src, "vla_rft_tpu/ops/attention.py:108", 0,
                 par["timed"]["wm_prefill_8_8"]["max_abs_err_o"],
                 par["timed"]["wm_prefill_8_8"]),
         "shape": "B=2 Sq=1088 Sk=1152 Hq=Hkv=8 D=64 causal: the WM prefill's heads a rank "
                  "under sp or tp = 2; no path splits the WM"},
        *({**entry(f"{kernel}@qwen_7_1", bwd_src, f"vla_rft_tpu/ops/attention.py:{line}",
                   qwen_bwd[kernel], par["timed"]["qwen_7_1_bwd"][key]["max_abs_err"],
                   par["timed"]["qwen_7_1_bwd"][key]), "shape": par_shape}
          for kernel, line, key in (("flash_bwd_dq", 175, "dq"), ("flash_bwd_dkv", 239, "dkv")))]
    rlds_n = rlds["steps"][0]["launches"]  # grpo_rlds: per step, as the grpo phase's
    for e in fused_entries:
        if "@" not in e["name"]:
            key = "fused_qkv" if e["name"] == "fused_rmsnorm_qkv" else "fused_o_mlp"
            e["grpo_rlds_launches_per_step"] = rlds_n[key]
            e["parallel_launches_per_rank"] = par_n[key]
            e["parallel_fsdp2_launches_per_rank"] = par_fsdp_n and par_fsdp_n[key]
    emit({"kernels": [
        {**entry("flash_fwd", flash_src, "vla_rft_tpu/ops/attention.py:108",
                 serving["main_path_launches"], flash["timed"]["serving"]["max_abs_err_o"],
                 flash["timed"]["serving"]),
         "grpo_rlds_launches_per_step": rlds_n["flash_fwd"],
         "parallel_launches_per_rank": par_n["flash_fwd"],
         "parallel_fsdp2_launches_per_rank": par_fsdp_n and par_fsdp_n["flash_fwd"],
         "sft_align_launches": align_n["flash_fwd"],
         "sft_align_shape": f"B=16 S=352 Hq/Hkv=14/2 D=64 causal, {n_align} steps",
         "eval_bridge_launches": ev["bridge"]["launches"]["flash_fwd"]},
        *eval_entries(ev, entry, flash_src),
        {**entry("flash_fwd@sft_text", flash_src, "vla_rft_tpu/ops/attention.py:108",
                 text_n["flash_fwd"], flash["timed"]["sft_text"]["max_abs_err_o"],
                 flash["timed"]["sft_text"]),
         "shape": f"B={SFT_TEXT_BATCH} Sq=Sk=1663 kv_lens={SFT_TEXT_KV_LENS} Hq/Hkv=14/2 D=64 "
                  f"causal; launches: {SFT_TEXT_STEPS} sft_text steps (their own ragged rows)"},
        {**entry("flash_fwd@wm_prefill", flash_src, "vla_rft_tpu/ops/attention.py:108",
                 wm_launches["flash_fwd"], flash["timed"]["wm_prefill"]["max_abs_err_o"],
                 flash["timed"]["wm_prefill"]),
         "shape": "B=2 Sq=1088 Sk=1152 Hq=Hkv=16 D=64 causal"},
        {**entry("flash_fwd@wm_logprob", flash_src, "vla_rft_tpu/ops/attention.py:108",
                 logprob_n["flash_fwd"], flash["timed"]["wm_logprob"]["max_abs_err_o"],
                 flash["timed"]["wm_logprob"]),
         "shape": f"B={N_SAMPLES * N_ROLLOUTS} Sq=Sk={WM_SFT_LEN} Hq=Hkv=16 D=64 causal: "
                  f"compute_log_prob's WM forward; launches: the grpo_variants wm_logprob step, "
                  f"the Qwen encode's 24 (another shape) included",
         "launches_at_this_shape": variants["wm_layers"]},
        {**entry("decode_shared_hd", dec_src, "vla_rft_tpu/ops/decode_attention_hd.py:226",
                 wm_launches["decode_shared_hd"], decode["max_abs_err"]["shared"],
                 decode["timed"]["shared"]),
         "grpo_rlds_launches_per_step": rlds_n["decode_shared_hd"],
         "parallel_launches_per_rank": par_n["decode_shared_hd"],
         "parallel_fsdp2_launches_per_rank": par_fsdp_n and par_fsdp_n["decode_shared_hd"]},
        {**entry("decode_shared_hd@b128", dec_src, "vla_rft_tpu/ops/decode_attention_hd.py:226",
                 0, decode["max_abs_err"]["shared"], decode["timed"]["shared_b128"]),
         "shape": f"B=128 Sq=1 Hq=Hkv=16 D=64 int8, 16 prefixes of {WM_PREFIX} (8 rows each) "
                  f"+ 291 own: the configured rows of a WM call; the main path runs B=10"},
        {**entry("decode_shared_hd@spec5", dec_src, "vla_rft_tpu/ops/decode_attention_hd.py:226",
                 spec_n["decode_shared_hd"], decode["timed"]["spec5"]["max_abs_err"],
                 decode["timed"]["spec5"]),
         "shape": f"B=10 Sq=5 Hq=Hkv=16 D=64 int8, 2 prefixes of {WM_PREFIX} + 287..296 own, "
                  f"a different offset per row: the speculative rollout's verify call (k=4); "
                  f"launches: the grpo_variants spec step (prompt tail and action calls "
                  f"included)",
         "launches_at_this_shape": variants["wm_layers"] * int(spec_roll["verify_calls"])},
        entry("decode_hd", dec_src, "vla_rft_tpu/ops/decode_attention_hd.py:272",
              plain["launches"]["decode_hd"], decode["max_abs_err"]["plain"],
              decode["timed"]["plain"]),
        *bwd_entries,
        *fused_entries,
        {**entry("decode_shared_heads", heads_src, "vla_rft_tpu/ops/decode_attention.py:183",
                 heads_n["decode_shared_heads"], decode_heads["max_abs_err"]["shared"],
                 decode_heads["timed"]["shared"]),
         "shape": f"B=10 Sq=1 Hq=Hkv=16 D=64 int8, 2 prefixes of {WM_PREFIX} + 291 own; "
                  f"launches: 1 grpo_heads step"},
        {**entry("decode_heads", heads_src, "vla_rft_tpu/ops/decode_attention.py:36",
                 plain_heads["launches"]["decode_heads"], decode_heads["max_abs_err"]["plain"],
                 decode_heads["timed"]["plain"]),
         "shape": "B=10 Sq=1 Hq=Hkv=16 D=64 int8, 1379 keys; launches: wm_plain_heads "
                  "(2 rows, 2 frames)"},
        *fda_entries,
        *text_entries(text, entry, flash_src, dec_src, ppo, rm, par),
        *ppo_entries(ppo, entry, bwd_src, rm, par),
        *par_entries,
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-task"]:  # a rank of the parallel phase
        sys.exit(rank_main(sys.argv[2], sys.argv[3]))
    sys.exit(main())
