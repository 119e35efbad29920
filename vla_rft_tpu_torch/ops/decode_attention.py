"""Split-cache decode attention over the head-blocked ('heads') KV cache + its
plain twins.

Port of vla_rft_tpu/ops/decode_attention.py (kernels #6
`_shared_decode_kernel` and #7 `_decode_kernel`).  The cache of one layer is
(rows, Hkv, S, D), int8 with bf16 per-(position, head) scales laid out
(rows, Hkv, S), or in the compute dtype without scales.  Every function
takes that layer's slice (`ck[li]` of the stacked cache, a contiguous view)
and q (B, Sq, Hq, D), and returns O (B, Sq, Hq, D) in q's dtype.

The semantics are those of the reference's XLA fallback
(models/transformer.py:503-545 shared, :569-596 plain), as for the 'hd'
layout (ops/decode_attention_hd.py): dequantise to the compute dtype,
gather each row's shared prefix through `prefix_map` and cut it to
`shared_len`, put it before the row's own cache, then masked causal
attention in f32 with `q_offset`, `kv_lens` and `kv_starts` /
`shared_starts`, 0 for a row with no valid key.  The reference's Pallas
#7 takes one query token and leaves 2-8 token chunks to the fallback; the
port's #7 takes Sq <= 8, the same function over a wider contract.  Not
ported (TPU rules): the head-pair packing of the cache (`pack_kv`), the
batch blocking (`block_b`, `row_chunk`) and the int8 requantisation of q
and p.

* `decode_shared_plain` / `decode_plain` are the twins in PyTorch; they run
  for CPU tensors, and on the card the kernels are checked against them.
* `decode_shared_kernel` / `decode_kernel` launch csrc/decode_heads.cu (the
  kernel of csrc/decode_attend.cuh over this layout's strides) and count
  their launches in `shared_heads_launches` / `heads_launches`.
* `decode_attention_shared` / `decode_attention` are the front ends: a CUDA
  tensor always goes to the kernel (or raises), a CPU tensor to the twin;
  `impl="plain"` asks for the twin on either device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from vla_rft_tpu_torch.ops import decode_attention_hd as _hd
from vla_rft_tpu_torch.ops.attention import attention_plain

MAX_SQ = _hd.MAX_SQ

# kernel launches since the counts were last set to 0 (read by chip_smoke.py)
shared_heads_launches = 0
heads_launches = 0


# ================================================================ plain twins
def dequantize(c: torch.Tensor, s: Optional[torch.Tensor], D: int, dtype) -> torch.Tensor:
    """(rows, Hkv, S, D) cache [+ (rows, Hkv, S) scales] -> contiguous (rows,
    S, Hkv, D) in `dtype`: int8 values times their f32-cast bf16 scale, then
    rounded to the compute dtype, as the fallback does.  D is the cache's
    last axis; it is an argument so that this and shared_kv take the 'hd'
    module's arguments."""
    x = c.to(dtype) if s is None else (c.float() * s.float()[..., None]).to(dtype)
    return x.transpose(1, 2).contiguous()


def shared_kv(ck, cv, sck, scv, prefix_map, shared_len: int, D: int, dtype,
              scales: Optional[Tuple] = None, shared_scales: Optional[Tuple] = None):
    """The split cache as one sequence per row, (B, shared_len + S, Hkv, D)
    K and V in `dtype`: [prefix row prefix_map[b] cut to shared_len | own
    cache of row b], dequantised."""
    sk, sv = scales if scales is not None else (None, None)
    ssk, ssv = shared_scales if shared_scales is not None else (None, None)
    pm = torch.as_tensor(prefix_map, device=ck.device).long()
    k_sh = dequantize(sck, ssk, D, dtype)[pm][:, :shared_len]
    v_sh = dequantize(scv, ssv, D, dtype)[pm][:, :shared_len]
    return (torch.cat([k_sh, dequantize(ck, sk, D, dtype)], dim=1),
            torch.cat([v_sh, dequantize(cv, sv, D, dtype)], dim=1))


def decode_shared_plain(q, ck, cv, sck, scv, prefix_map, *, shared_len: int, kv_lens,
                        q_offset, shared_starts=None, scales: Optional[Tuple] = None,
                        shared_scales: Optional[Tuple] = None) -> torch.Tensor:
    """The shared-prefix fallback: one masked softmax over `shared_kv`."""
    k_all, v_all = shared_kv(ck, cv, sck, scv, prefix_map, shared_len, q.shape[-1], q.dtype,
                             scales, shared_scales)
    return attention_plain(q, k_all, v_all, causal=True, kv_lens=kv_lens, q_offset=q_offset,
                           kv_starts=shared_starts)


def decode_plain(q, ck, cv, *, kv_lens, q_offset, kv_starts=None,
                 scales: Optional[Tuple] = None) -> torch.Tensor:
    """The single-cache fallback: masked causal attention over the
    dequantised layer slice."""
    D, dt = q.shape[-1], q.dtype
    sk, sv = scales if scales is not None else (None, None)
    return attention_plain(q, dequantize(ck, sk, D, dt), dequantize(cv, sv, D, dt), causal=True,
                           kv_lens=kv_lens, q_offset=q_offset, kv_starts=kv_starts)


# ==================================================================== kernels
def decode_shared_kernel(q, ck, cv, sck, scv, prefix_map, *, shared_len: int, kv_lens,
                         q_offset, shared_starts=None, scales: Optional[Tuple] = None,
                         shared_scales: Optional[Tuple] = None) -> torch.Tensor:
    """Launch kernel #6 (split cache); same arguments as `decode_shared_plain`,
    all on one CUDA device, q bf16 (int8 or bf16 caches) or f32 (f32
    caches) with D = 64 and Sq <= 8.  Per-row
    arguments are (B,) integer tensors.  prefix_map must index rows of the
    shared cache (not checked: that would synchronise)."""
    global shared_heads_launches
    ssk, ssv = shared_scales if shared_scales is not None else (None, None)
    o = _hd._launch(q, ck, cv, scales, (sck, scv, ssk, ssv), prefix_map, shared_len, kv_lens,
                    q_offset, shared_starts, layout="heads")
    shared_heads_launches += 1
    return o


def decode_kernel(q, ck, cv, *, kv_lens, q_offset, kv_starts=None,
                  scales: Optional[Tuple] = None) -> torch.Tensor:
    """Launch kernel #7 (single cache); same arguments as `decode_plain`."""
    global heads_launches
    o = _hd._launch(q, ck, cv, scales, None, None, 0, kv_lens, q_offset, kv_starts,
                    layout="heads")
    heads_launches += 1
    return o


# ================================================================= front ends
def decode_attention_shared(q, ck, cv, sck, scv, prefix_map, *, shared_len: int, kv_lens,
                            q_offset, shared_starts=None, scales=None, shared_scales=None,
                            impl: str = "auto") -> torch.Tensor:
    fn = decode_shared_plain if _hd._use_plain(q, impl) else decode_shared_kernel
    return fn(q, ck, cv, sck, scv, prefix_map, shared_len=shared_len, kv_lens=kv_lens,
              q_offset=q_offset, shared_starts=shared_starts, scales=scales,
              shared_scales=shared_scales)


def decode_attention(q, ck, cv, *, kv_lens, q_offset, kv_starts=None, scales=None,
                     impl: str = "auto") -> torch.Tensor:
    fn = decode_plain if _hd._use_plain(q, impl) else decode_kernel
    return fn(q, ck, cv, kv_lens=kv_lens, q_offset=q_offset, kv_starts=kv_starts, scales=scales)
