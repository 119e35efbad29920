"""Pipeline parallelism (GPipe schedule) over the decoder's layers (port of
vla_rft_tpu/parallel/pp.py; the role of verl's Megatron pipeline stages).

The layer stack is split over the ranks of a `pp` process group: stage p
runs layers [p L/P, (p+1) L/P).  Micro-batch activations go from stage to
stage by point-to-point sends and receives (`parallel/distributed.py`,
staged through host memory on a gloo group).  Fill-drain: with P stages and
M micro-batches stage p works on micro-batch t - p at step t, T = M + P - 1
steps in all; each rank runs its micro-batches in order and the receives
pace it.  The last stage's outputs are broadcast to every stage (the
reference's psum of the masked outputs).

Training goes through the pipeline: the backward of a send is a receive of
the gradient from the next stage, and each stage runs its micro-batches'
backward in order, so the layer gradients land on the stage that owns the
layers and the gradient of the pipeline's input (the embedding's) is
broadcast from stage 0.  Gradients of the replicated embedding, final norm
and head are whole on every rank, as in the reference.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from vla_rft_tpu_torch.parallel import distributed as pd


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_mb, stage_fn, group, *params):
        P, p = dist.get_world_size(group), dist.get_rank(group)
        M = x_mb.shape[0]
        shape, dtype, dev = x_mb.shape[1:], x_mb.dtype, x_mb.device
        ins, outs = [], []
        for m in range(M):
            x = x_mb[m].detach() if p == 0 else pd.recv(shape, dtype, dev, p - 1, group)
            x.requires_grad_(True)
            with torch.enable_grad():
                y = stage_fn(x)
            if p < P - 1:
                pd.send(y.detach(), p + 1, group)
            ins.append(x)
            outs.append(y)
        res = (torch.stack([y.detach() for y in outs]) if p == P - 1
               else torch.empty_like(x_mb))
        pd.broadcast(res, dist.get_global_rank(group, P - 1), group)
        ctx.group, ctx.ins, ctx.outs = group, ins, outs
        return res

    @staticmethod
    def backward(ctx, g):
        group, ins, outs = ctx.group, ctx.ins, ctx.outs
        P, p = dist.get_world_size(group), dist.get_rank(group)
        grads = []
        for m in range(len(outs)):
            gy = g[m] if p == P - 1 else pd.recv(outs[m].shape, outs[m].dtype, outs[m].device,
                                                 p + 1, group)
            torch.autograd.backward(outs[m], gy)
            gx = ins[m].grad if ins[m].grad is not None else torch.zeros_like(ins[m])
            if p > 0:
                pd.send(gx, p - 1, group)
            grads.append(gx)
        gx_mb = torch.stack(grads) if p == 0 else torch.empty_like(g)
        pd.broadcast(gx_mb, dist.get_global_rank(group, 0), group)
        ctx.ins = ctx.outs = None
        return (gx_mb, None, None) + (None,) * (len(ctx.needs_input_grad) - 3)


def _pipeline_no_grad(stage_fn, x_mb, group):
    P, p = dist.get_world_size(group), dist.get_rank(group)
    outs = []
    for m in range(x_mb.shape[0]):
        x = x_mb[m] if p == 0 else pd.recv(x_mb.shape[1:], x_mb.dtype, x_mb.device, p - 1, group)
        y = stage_fn(x)
        if p < P - 1:
            pd.send(y, p + 1, group)
        outs.append(y)
    res = torch.stack(outs) if p == P - 1 else torch.empty_like(x_mb)
    return pd.broadcast(res, dist.get_global_rank(group, P - 1), group)


def pipeline_spmd(stage_fn: Callable[[torch.Tensor], torch.Tensor], x_mb: torch.Tensor, group,
                  params: Sequence[torch.Tensor] = ()) -> torch.Tensor:
    """GPipe over the ranks of `group`.  stage_fn applies THIS stage's
    layers and keeps shape and dtype; x_mb (M, ...) is stage 0's input
    (every rank passes one of that shape); `params` are the stage's trained
    tensors (their gradients accumulate in `.grad` through the backward).
    Returns the last stage's (M, ...) outputs on every rank."""
    if torch.is_grad_enabled() and (x_mb.requires_grad or any(q.requires_grad for q in params)):
        return _Pipeline.apply(x_mb, stage_fn, group, *params)
    return _pipeline_no_grad(stage_fn, x_mb, group)


def stage_layers(num_layers: int, group) -> range:
    """The layer indices of this rank's stage."""
    P, p = dist.get_world_size(group), dist.get_rank(group)
    assert num_layers % P == 0, (num_layers, P)
    per = num_layers // P
    return range(p * per, (p + 1) * per)


def decoder_pp_forward(decoder: nn.Module, input_ids: torch.Tensor, group, *,
                       n_microbatches: Optional[int] = None, logits_last_only: bool = False):
    """The full causal forward of a port Decoder with its layer stack
    pipelined over `group` (the same numbers as `decoder(input_ids)`).  The
    embedding and the final norm + head run replicated on every rank; stage
    p runs only its own layers.  Returns (logits f32, hidden)."""
    cfg = decoder.cfg
    n_stages = dist.get_world_size(group)
    layers = stage_layers(cfg.num_layers, group)
    emb = decoder(input_ids, embed_only=True)
    B, S, D = emb.shape
    M = n_microbatches or n_stages
    assert B % M == 0, f"batch {B} must divide into {M} microbatches"
    x_mb = emb.reshape(M, B // M, S, D)

    def stage(x):
        b = x.shape[0]
        pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(b, S)
        kvl = torch.full((b,), S, dtype=torch.int32, device=x.device)
        for li in layers:
            x = decoder.layers[li](x, pos, kvl, True, decoder.attn_impl, li)
        return x

    params = [q for li in layers for q in decoder.layers[li].parameters() if q.requires_grad]
    x = pipeline_spmd(stage, x_mb, group, params).reshape(B, S, D)
    x = decoder.norm(x)
    logits = decoder.logits(x[:, -1:] if logits_last_only else x)
    return logits, x
