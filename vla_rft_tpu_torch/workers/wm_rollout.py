"""World-model interactive rollout: eager decode with a growing KV cache.

Port of vla_rft_tpu/workers/wm_rollout.py (`generate_sequences` without the
speculative path).  The reference
compiles the loop with `lax.scan`; here it is a Python loop over frames and
tokens: per frame `interact_max_tokens` sampled visual tokens, each fed back
as a one-token decode call, then the policy's `action_dim` action tokens
teacher-forced as one chunk.  The frame loop runs in `cache_segments`
segments, and the per-row cache grows between them to that segment's
largest valid length.

With `shared_prefix`, the prompt head shared by a group of rows (the n
rollouts of a sample and its gt-action row) is prefilled once per unique
row into a read-only prefix cache, and every decode call reads it through
`prefix_map` (CUDA kernel #4 on the card, #6 with the WM's 'heads' cache
layout); the per-row cache holds only the tail and the response.  Without
it, the whole prompt is prefilled per row and decode calls read one cache
(kernel #5, or #7 for 'heads').  `grow_cache` pads each array along the
sequence axis of the WM's layout (`Decoder.cache_seq_axes`).  The TPU kernel's batch-block
clamp (`prefix_run`) is not needed: the CUDA kernel reads prefix_map per row.

With an int8-weight WM (`weights_int8`), an int8 KV cache in the 'hd'
layout and no qkv bias, every decode call on the card goes through
`decode_step_fused` (kernels #8, #4 or #5, and #9 per layer); on the CPU,
and with the 'heads' layout anywhere, the calls take the unfused int8
route (`Decoder.forward` with `QuantLinear`), as the reference's do
(vla_rft_tpu/workers/wm_rollout.py:198-206).  The prompt prefill always takes the unfused route (kernel #1 for
attention).
Each call samples from the one `torch.Generator` it is given; the trainer
passes one per WM chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig, decode_step_fused
from vla_rft_tpu_torch.ops.sampling import sample_token


@dataclasses.dataclass(frozen=True)
class WMRolloutConfig:
    """world_model_rollout.rollout (reference WMRolloutConfig)."""

    prompt_length: int = 1095
    response_length: int = 568
    num_frames: int = 8  # segment_length - 1
    interact_max_tokens: int = 64  # visual tokens per frame
    action_dim: int = 7
    temperature: float = 1.0
    top_k: int = -1
    top_p: float = 0.8
    do_sample: bool = True
    # the frame loop runs in this many segments, each with a cache sized to
    # its largest valid length (1 = one full-size cache)
    cache_segments: int = 4

    @property
    def tokens_per_frame(self) -> int:
        return self.interact_max_tokens + self.action_dim

    @property
    def total_length(self) -> int:
        return self.prompt_length + self.response_length


def grow_cache(cache: Tuple[torch.Tensor, ...], new_len: int, align: int,
               seq_axes: Sequence[int]) -> Tuple[torch.Tensor, ...]:
    """Zero-pad every cache array's sequence axis up to `new_len` rounded up
    to `align` (Decoder.init_cache's rule); arrays already that long stay."""
    new_len = (new_len + align - 1) // align * align
    out = []
    for arr, ax in zip(cache, seq_axes):
        s = arr.shape[ax]
        if s >= new_len:
            out.append(arr)
            continue
        pad = [0, 0] * (arr.dim() - 1 - ax) + [0, new_len - s]
        out.append(F.pad(arr, pad))
    return tuple(out)


def fused_route(cfg: TransformerConfig, on_cuda: bool) -> bool:
    """Whether a rollout's decode calls go through `decode_step_fused`: an
    int8-weight WM with an int8 KV cache in the 'hd' layout and no qkv
    bias, on the card (the reference's guard, wm_rollout.py:198-206)."""
    return bool(cfg.weights_int8 and cfg.kv_cache_dtype == "int8" and cfg.kv_layout == "hd"
                and not cfg.qkv_bias and on_cuda)


def uniform_prefix_run(local) -> int:
    """Largest r dividing len(local) such that `local` (a prefix_map) is
    uniform over every aligned r-row block."""
    Bc = len(local)
    edges = [i for i in range(Bc - 1) if local[i] != local[i + 1]]
    for r in sorted((d for d in range(1, Bc + 1) if Bc % d == 0), reverse=True):
        if all((i + 1) % r == 0 for i in edges):
            return r
    return 1


@torch.no_grad()
def generate_sequences(
    wm: Decoder,
    gen: torch.Generator,
    input_ids: torch.Tensor,  # (B, prompt tail) or (B, prompt_length)
    action_ids: torch.Tensor,  # (B, T, action_dim) offset action tokens
    cfg: WMRolloutConfig,
    shared_prefix: Optional[torch.Tensor] = None,  # (B_u, P0) unique prompt heads
    prefix_map=None,  # (B,) row -> unique prefix
) -> torch.Tensor:
    """Response tokens (B, num_frames * (V + A)), int32 as the reference
    returns them: per frame V sampled visual tokens then the A action tokens
    of frame f + 1."""
    B = action_ids.shape[0]
    dev = input_ids.device
    P0 = 0 if shared_prefix is None else shared_prefix.shape[1]
    P = P0 + input_ids.shape[1]
    Fn, V, A = cfg.num_frames, cfg.interact_max_tokens, cfg.action_dim
    n_seg = max(1, min(int(cfg.cache_segments), Fn))
    bounds = [round(Fn * (s + 1) / n_seg) for s in range(n_seg)]
    f_starts = [0] + bounds[:-1]

    shared_kw = {}
    if shared_prefix is not None:
        # prefill the unique prefixes; that B_u-row cache is the shared cache
        shared = wm.init_cache(shared_prefix.shape[0], P0)
        wm(shared_prefix, cache=shared, cache_index=0, compute_logits=False)
        pm = torch.as_tensor(prefix_map, device=dev).to(torch.int32)
        shared_kw = dict(shared_cache=shared, shared_len=P0, prefix_map=pm)
        cache = wm.init_cache(B, (P - P0) + bounds[0] * (V + A))
        logits, _ = wm(input_ids, cache=cache, cache_index=P0, kv_lens=P,
                       logits_last_only=True, **shared_kw)
    else:
        cache = wm.init_cache(B, P + bounds[0] * (V + A))
        logits, _ = wm(input_ids, cache=cache, cache_index=0, logits_last_only=True)
    last = logits[:, -1]

    use_fused = fused_route(wm.cfg, input_ids.is_cuda)

    def step(toks, ci, **kw):
        """One decode call: the fused kernels when eligible, else the module."""
        if use_fused:
            return decode_step_fused(wm, toks, cache, ci, **shared_kw, **kw)
        return wm(toks, cache=cache, cache_index=ci, **shared_kw, **kw)

    align = 128 if wm.cfg.kv_cache_dtype == "int8" else 8
    sample = lambda lg: sample_token(gen, lg, cfg.temperature, cfg.top_k, cfg.top_p,
                                     cfg.do_sample)
    frames = []
    for f0, f1 in zip(f_starts, bounds):
        cache = grow_cache(cache, (P - P0) + f1 * (V + A), align, wm.cache_seq_axes())
        for f in range(f0, f1):
            base = P + f * (V + A)
            toks = []
            for i in range(V):
                tok = sample(last)
                logits, _ = step(tok[:, None], base + i)
                last = logits[:, 0]
                toks.append(tok)
            act = action_ids[:, f + 1].to(torch.int32)
            logits, _ = step(act, base + V, logits_last_only=True)
            last = logits[:, -1]
            frames.append(torch.cat([torch.stack(toks, dim=1), act], dim=1))
    return torch.cat(frames, dim=1)
