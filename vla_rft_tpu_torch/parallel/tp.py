"""Tensor-parallel placement of the Decoder (port of
vla_rft_tpu/parallel/tp.py; the reference's Megatron ColumnParallel /
RowParallel layers).

`shard_decoder_params_tp` makes each parameter a DTensor on the mesh's tp
axis by the reference's rule (`_decoder_tp_spec`): q/k/v weights and biases
column-parallel (split by heads), o_proj row-parallel, gate/up
column-parallel, down row-parallel, the embedding and lm_head split on the
vocabulary; a parameter whose dimension does not divide stays replicated.
Each split product then computes on its local shard: a column-parallel
product gives this rank's heads (or MLP columns), so the attention runs on
the local head counts (kernel #1 on the card); a row-parallel product sums
its partial result over the tp group (all-reduce); the vocabulary-split
embedding looks up its own rows and sums, the vocabulary-split logits are
gathered.  TP covers the uncached forward (the reference tests no more);
a cached decode of a TP-sharded decoder raises.
"""
from __future__ import annotations

import types
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vla_rft_tpu_torch.parallel import distributed as pd

_ROW = ("o_proj", "down_proj")


def _decoder_tp_spec(name: str, shape: Tuple[int, ...], tp: int, num_heads: int,
                     num_kv_heads: int) -> Optional[int]:
    """The dimension of a port Decoder parameter that the reference's rule
    splits over tp, or None (replicated).  Port layouts: a product's weight
    is (out, in), its bias (out,); heads are blocks of head_dim along q/k/v's
    out and o_proj's in."""
    mod, _, leaf = name.rpartition(".")
    last = mod.rpartition(".")[2]
    heads = num_kv_heads if last in ("k_proj", "v_proj") else num_heads
    if last in ("q_proj", "k_proj", "v_proj"):
        # (..., in, heads, hd) in the reference: shard heads
        return 0 if heads % tp == 0 else None
    if last == "o_proj" and leaf == "weight":
        # (..., heads, hd, out): shard heads (row-parallel in-dim)
        return 1 if num_heads % tp == 0 else None
    if last in ("gate_proj", "up_proj") and leaf == "weight":
        return 0 if shape[0] % tp == 0 else None  # shard inter
    if last == "down_proj" and leaf == "weight":
        return 1 if shape[1] % tp == 0 else None  # shard inter (row-parallel)
    if (last == "embed_tokens" or last == "lm_head") and leaf == "weight":
        return 0 if shape[0] % tp == 0 else None  # vocab
    return None


def _gather_last(y: torch.Tensor, group) -> torch.Tensor:
    """Concatenate the group's tensors along the last dimension."""
    return pd.all_gather(y.movedim(-1, 0).contiguous(), group).movedim(0, -1)


def _column_forward(self, x):
    dt = self.dtype
    b = None if self.bias is None else self.bias.to_local().to(dt)
    y = F.linear(x.to(dt), self.weight.to_local().to(dt), b)
    return _gather_last(y, self._tp_group) if self._tp_gather else y


def _row_forward(self, x):
    dt = self.dtype
    y = pd.all_reduce(F.linear(x.to(dt), self.weight.to_local().to(dt)), group=self._tp_group)
    return y if self.bias is None else y + self.bias.to_local().to(dt)


def _embed_forward(self, ids):
    w = self.weight.to_local()
    rows = w.shape[0]
    start = dist.get_rank(self._tp_group) * rows
    mine = (ids >= start) & (ids < start + rows)
    out = w[(ids - start).clamp(0, rows - 1)] * mine[..., None].to(w.dtype)
    out = pd.all_reduce(out, group=self._tp_group)
    return out if self.dtype is None else out.to(self.dtype)


def _embed_attend(self, x):
    y = x @ self.weight.to_local().to(self.dtype or self.weight.dtype).t()
    return _gather_last(y, self._tp_group)


@torch.no_grad()
def shard_decoder_params_tp(mesh, decoder: nn.Module) -> nn.Module:
    """Place a port Decoder's parameters over the mesh's tp axis (in place;
    replicated over the other axes) and switch its split products to their
    tensor-parallel forwards.  Returns the decoder."""
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    cfg = decoder.cfg
    if cfg.weights_int8:
        raise ValueError("shard_decoder_params_tp takes a bf16 / f32 Decoder, not its int8 twin")
    tp_mesh = mesh["tp"]
    tp = tp_mesh.size()
    if tp <= 1:
        return decoder
    if cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp:
        raise ValueError(f"tp {tp} splits the {cfg.num_heads} query heads but not the "
                         f"{cfg.num_kv_heads} kv heads: the local heads would lose their kv heads")
    group = tp_mesh.get_group()
    for mname, mod in decoder.named_modules():
        own = list(mod.named_parameters(recurse=False))
        if not own:
            continue
        dims = {leaf: _decoder_tp_spec(f"{mname}.{leaf}", tuple(p.shape), tp, cfg.num_heads,
                                       cfg.num_kv_heads) for leaf, p in own}
        if all(d is None for d in dims.values()):
            continue
        for leaf, p in own:
            d = dims[leaf]
            placement = [Shard(d)] if d is not None else [Replicate()]
            dt = distribute_tensor(p.data, tp_mesh, placement, src_data_rank=None)
            setattr(mod, leaf, nn.Parameter(dt, requires_grad=p.requires_grad))
        last = mname.rpartition(".")[2]
        mod._tp_group = group
        if last == "embed_tokens":
            mod.forward = types.MethodType(_embed_forward, mod)
            mod.attend = types.MethodType(_embed_attend, mod)
        elif last in _ROW:
            mod.forward = types.MethodType(_row_forward, mod)
        else:  # column-parallel: q/k/v, gate/up, lm_head (gathered logits)
            mod._tp_gather = last == "lm_head"
            mod.forward = types.MethodType(_column_forward, mod)
    return decoder
