"""Ulysses-style sequence parallelism over a process group (port of
vla_rft_tpu/parallel/ulysses.py; DeepSpeed-Ulysses as the reference uses it,
train/verl/verl/utils/ulysses.py:61-194).

Each rank holds a (B, S/sp, H, D) slice of the sequence; around attention
an all-to-all swaps the sequence and head dimensions so that each rank
attends over the whole sequence with H/sp heads (`ops.attention`: kernel #1
forward, #2 / #3 backward on the card), then the inverse all-to-all brings
the sequence slices back.  The backward of each all-to-all is the inverse
all-to-all.  KV heads are repeated when sp exceeds their number
(monkey_patch.py:76-78).  The all-to-all goes through
`parallel/distributed.py`; gloo and NCCL both carry it on CUDA tensors.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from vla_rft_tpu_torch.ops.attention import attention
from vla_rft_tpu_torch.parallel import distributed as pd


def _seq2head(x: torch.Tensor, group) -> torch.Tensor:
    sp = dist.get_world_size(group)
    B, s_local, H, D = x.shape
    assert H % sp == 0, f"heads {H} not divisible by sp {sp}"
    # split heads into sp groups; group j goes to rank j
    x = x.reshape(B, s_local, sp, H // sp, D).movedim(2, 0)  # (sp, B, s, H/sp, D)
    x = pd.all_to_all_single(x, group)
    # dim 0 now indexes the source rank, i.e. the sequence chunk
    return x.movedim(0, 1).reshape(B, sp * s_local, H // sp, D)


def _head2seq(x: torch.Tensor, group) -> torch.Tensor:
    sp = dist.get_world_size(group)
    B, S, h_local, D = x.shape
    assert S % sp == 0
    x = x.reshape(B, sp, S // sp, h_local, D).movedim(1, 0)  # (sp, B, S/sp, h, D)
    x = pd.all_to_all_single(x, group)
    # dim 0 now indexes the source rank, i.e. the head group: keep it
    # before h_local
    return x.movedim(0, 2).reshape(B, S // sp, sp * h_local, D)


class _SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq2head(x, group)

    @staticmethod
    def backward(ctx, g):
        return _head2seq(g, ctx.group), None


class _HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _head2seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq2head(g, ctx.group), None


def all_to_all_seq2head(x: torch.Tensor, group) -> torch.Tensor:
    """(B, S/sp, H, D) per rank -> (B, S, H/sp, D) per rank (ulysses.py
    SeqAllToAll forward: scatter heads, gather the sequence)."""
    return _SeqToHead.apply(x, group)


def all_to_all_head2seq(x: torch.Tensor, group) -> torch.Tensor:
    """(B, S, H/sp, D) per rank -> (B, S/sp, H, D) per rank (the inverse)."""
    return _HeadToSeq.apply(x, group)


def repeat_kv_heads(k: torch.Tensor, sp: int) -> torch.Tensor:
    """Repeat KV heads so they divide sp (monkey_patch.py:76-78)."""
    nkv = k.shape[2]
    if nkv % sp == 0:
        return k
    reps = (sp + nkv - 1) // nkv
    return k.repeat_interleave(reps, dim=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, group,
                      causal: bool = True, kv_lens: Optional[torch.Tensor] = None,
                      kv_starts: Optional[torch.Tensor] = None,
                      impl: str = "auto") -> torch.Tensor:
    """Sequence-parallel attention: this rank's (B, S/sp, H, D) slice of q
    and (B, S/sp, Hkv, D) of k / v in, its slice of the output out.  q and k
    carry rope at their global positions; kv_lens / kv_starts are global."""
    sp = dist.get_world_size(group)
    B, s_local = q.shape[:2]
    k, v = repeat_kv_heads(k, sp), repeat_kv_heads(v, sp)
    qh = all_to_all_seq2head(q, group)
    kh = all_to_all_seq2head(k, group)
    vh = all_to_all_seq2head(v, group)
    if kv_lens is None:
        kv_lens = torch.full((B,), sp * s_local, dtype=torch.int32, device=q.device)
    out = attention(qh, kh, vh, causal=causal, kv_lens=kv_lens, kv_starts=kv_starts, impl=impl)
    return all_to_all_head2seq(out, group)


def ulysses_pad_and_slice(x: torch.Tensor, sp: int, axis: int = 1):
    """Pad the sequence to a multiple of sp (ulysses_pad_and_slice_inputs,
    ulysses.py:252-288).  Returns (padded, pad)."""
    S = x.shape[axis]
    pad = (-S) % sp
    if pad:
        shape = list(x.shape)
        shape[axis] = pad
        x = torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=x.device)], dim=axis)
    return x, pad
