"""World-model interactive rollout: eager decode with a growing KV cache.

Port of vla_rft_tpu/workers/wm_rollout.py (`generate_sequences` and
`compute_log_prob`).  The reference
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
with the 'heads' layout anywhere, with `fused_layers` off and under
speculation, the calls take the unfused int8 route (`Decoder.forward` with
`QuantLinear`), as the reference's do
(vla_rft_tpu/workers/wm_rollout.py:198-206).  The prompt prefill always
takes the unfused route (kernel #1 for attention).

With `speculative_k = k > 0` a frame is decoded by verify calls (reference
:219-319): each row's drafts are the same frame positions' tokens of the
previous frame (the prompt's dyn_0 tokens for the first frame), and one
call sends `[pending, k drafts]` (1 + k tokens, kernel #4 / #6 at Sq = 1 +
k) at the row's own cache offset: rows accept different numbers of drafts
and advance at different rates.  Drafts are accepted by exact rejection
sampling (greedy: a draft is accepted when it is the argmax), the token
after the accepted run is drawn from the residual with the rejected draft
masked out, so the decode distribution is unchanged, and greedy tokens are
plain decode's up to the rounding of a (1 + k)-token call against a
one-token one (bit-equal in f32 on the CPU).  The host loops while some row has visual tokens left; rows
that are done ride through the verify call and keep their state.  The
frame ends with one action call `[pending, actions]` of 1 + A tokens.
Each call samples from the one `torch.Generator` it is given; the trainer
passes one per WM chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from vla_rft_tpu_torch.models.transformer import Decoder, TransformerConfig, decode_step_fused
from vla_rft_tpu_torch.ops.masked import logprobs_from_logits
from vla_rft_tpu_torch.ops.sampling import categorical, filtered_logits, sample_token, uniform


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
    # decode calls of an int8-weight WM through the fused layer kernels where
    # `fused_route` allows them; False keeps every call on the module route
    fused_layers: bool = True
    # speculative decoding's draft length (0 = off); at most 7, so that a
    # verify call of 1 + k tokens fits the decode kernel's Sq <= 8
    speculative_k: int = 0

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


def fused_route(cfg: TransformerConfig, on_cuda: bool,
                roll: Optional[WMRolloutConfig] = None) -> bool:
    """Whether a rollout's decode calls go through `decode_step_fused`: an
    int8-weight WM with an int8 KV cache in the 'hd' layout and no qkv
    bias, on the card, and given the rollout's config, `fused_layers` on and
    no speculation (the reference's guard, wm_rollout.py:198-206)."""
    if roll is not None and (not roll.fused_layers or roll.speculative_k > 0):
        return False
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
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Response tokens (B, num_frames * (V + A)), int32 as the reference
    returns them: per frame V sampled visual tokens then the A action tokens
    of frame f + 1.  A `stats` dict gets this call's counts added to its
    own: "rows", "calls" (every cached WM call after the shared prefix's
    prefill: the prompt tail's, the decode calls, the verify calls and the
    action calls), and under speculation "verify_calls", "proposed" and
    "accepted" (drafts, summed over rows)."""
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
    counts = {"rows": B, "calls": 1, "verify_calls": 0, "proposed": 0, "accepted": 0}

    use_fused = fused_route(wm.cfg, input_ids.is_cuda, cfg)

    def step(toks, ci, **kw):
        """One decode call: the fused kernels when eligible, else the module."""
        counts["calls"] += 1
        if use_fused:
            return decode_step_fused(wm, toks, cache, ci, **shared_kw, **kw)
        return wm(toks, cache=cache, cache_index=ci, **shared_kw, **kw)

    align = 128 if wm.cfg.kv_cache_dtype == "int8" else 8
    sample = lambda lg: sample_token(gen, lg, cfg.temperature, cfg.top_k, cfg.top_p,
                                     cfg.do_sample)
    spec_k = int(cfg.speculative_k)
    sampled = cfg.do_sample and cfg.temperature != 0

    def spec_frame(last, draft_prev, base):
        """The frame's V visual tokens by verify calls (reference :238-311).
        Per row, `j` counts the tokens decided this frame (`pending`
        included) and `pending` is the token at frame position j - 1 whose
        k/v is not in the cache yet; position V - 1 is always a sampled
        token (drafts are capped at V - 1 - j), so the action call can
        prepend `pending` in every row."""
        c = 1 + spec_k
        pending = sample(last)
        j = torch.ones(B, dtype=torch.long, device=dev)
        buf = torch.zeros(B, V, dtype=torch.int32, device=dev)
        buf[:, 0] = pending
        ar_k = torch.arange(spec_k, device=dev)[None]
        pos = torch.arange(V, device=dev)[None]
        rows = torch.arange(B, device=dev)
        while bool((j < V).any()):
            done = j >= V
            drafts = torch.gather(draft_prev, 1, (j[:, None] + ar_k).clamp(0, V - 1))  # (B, k)
            pos0 = base + j - 1  # pending's absolute position, per row
            counts["calls"] += 1
            counts["verify_calls"] += 1
            logits, _ = wm(torch.cat([pending[:, None], drafts], dim=1), cache=cache,
                           cache_index=pos0, kv_lens=pos0 + c, **shared_kw)  # (B, c, vocab)
            if sampled:
                fl = filtered_logits(logits, cfg.temperature, cfg.top_k, cfg.top_p)
                probs = torch.softmax(fl[:, :spec_k], dim=-1)
                pd = torch.gather(probs, -1, drafts[..., None].long())[..., 0]
                ok = uniform(gen, pd.shape, dev) < pd
            else:
                fl = logits.float()
                ok = drafts == fl[:, :spec_k].argmax(dim=-1)
            # drafts are proposed only for frame positions < V - 1
            k_eff = (V - 1 - j).clamp(0, spec_k)
            proposed = ar_k < k_eff[:, None]
            n_acc = torch.cumprod((ok & proposed).to(torch.int32), dim=1).sum(dim=1)
            counts["proposed"] += int(k_eff[~done].sum())
            counts["accepted"] += int(n_acc[~done].sum())
            l_acc = fl[rows, n_acc]  # the logits after the accepted run
            d_acc = drafts[rows, n_acc.clamp(max=spec_k - 1)]
            rejected = n_acc < k_eff  # stopped by a rejection, not by the cap
            vocab = torch.arange(l_acc.shape[-1], device=dev)[None]
            resid = torch.where(rejected[:, None] & (vocab == d_acc[:, None]),
                                torch.full_like(l_acc, -1e30), l_acc)
            t_star = (categorical(gen, resid) if sampled
                      else resid.argmax(dim=-1).to(torch.int32))
            live = ~done[:, None]
            buf = torch.where((pos >= j[:, None]) & (pos < (j + n_acc)[:, None]) & live,
                              draft_prev, buf)
            buf = torch.where((pos == (j + n_acc)[:, None]) & live, t_star[:, None], buf)
            pending = torch.where(done, pending, t_star)
            j = torch.where(done, j, j + n_acc + 1)
        return buf, pending

    if spec_k:
        # the first frame's drafts: the prompt's dyn_0 tokens, the shared
        # prefix's last V columns or the V tokens before the prompt's actions
        draft = (shared_prefix[:, -V:][pm.long()] if shared_prefix is not None
                 else input_ids[:, P - A - V:P - A]).to(torch.int32)
    frames = []
    for f0, f1 in zip(f_starts, bounds):
        cache = grow_cache(cache, (P - P0) + f1 * (V + A), align, wm.cache_seq_axes())
        for f in range(f0, f1):
            base = P + f * (V + A)
            act = action_ids[:, f + 1].to(torch.int32)
            if spec_k:
                vis, pending = spec_frame(last, draft, base)
                draft = vis
                # pending's k/v rides along with the actions
                logits, _ = step(torch.cat([pending[:, None], act], dim=1), base + V - 1,
                                 logits_last_only=True)
            else:
                toks = []
                for i in range(V):
                    tok = sample(last)
                    logits, _ = step(tok[:, None], base + i)
                    last = logits[:, 0]
                    toks.append(tok)
                vis = torch.stack(toks, dim=1)
                logits, _ = step(act, base + V, logits_last_only=True)
            last = logits[:, -1]
            frames.append(torch.cat([vis, act], dim=1))
    if stats is not None:
        for k, v in counts.items():
            stats[k] = stats.get(k, 0) + v
    return torch.cat(frames, dim=1)


@torch.no_grad()
def compute_log_prob(wm: Decoder, input_ids: torch.Tensor, response_length: int,
                     temperature: float = 1.0) -> torch.Tensor:
    """The teacher-forced WM log-prob of every response token (B,
    response_length) f32 (reference :364-379): one full forward over the
    prompt and response (kernel #1 per layer on the card), the logits that
    predict each response token divided by the temperature, then
    `logprobs_from_logits`."""
    logits, _ = wm(input_ids)
    pred = logits[:, -response_length - 1:-1] / temperature
    return logprobs_from_logits(pred, input_ids[:, -response_length:])
