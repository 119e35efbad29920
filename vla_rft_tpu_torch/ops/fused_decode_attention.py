"""One-token decode attention that writes its own K/V row into the cache +
its plain twin.

Port of vla_rft_tpu/ops/fused_decode_attention.py (kernel #10, `_kernel`,
behind `fused_decode_attention`).  The cache is the stacked 'heads' layout
(L, B, Hkv, S, D) in bf16 or f32; q is (B, 1, Hq, D), the current token's
k_new / v_new (B, 1, Hkv, D).  One call:

  * casts k_new / v_new to the cache dtype and writes them into row
    `cache_index` of layer `layer_idx`, in place (the reference aliases the
    cache into the kernel's outputs and returns it; here the same tensors
    are returned);
  * attends q over the history rows [kv_starts[b], cache_index) plus the
    current token, which is always attended: f32 scores of q * D^-0.5,
    exp(max(x, -80)), o = acc / max(l, 1e-30), in q's dtype.

The reference calls it only from its tests (tests/test_ops.py:225); no path
of the port calls it either.  It is ported, tested and timed as an op.

* `fused_decode_attention_plain` is the twin in PyTorch (one masked
  softmax); it runs for CPU tensors, and on the card the kernel is checked
  against it.
* `fused_decode_attention_kernel` launches csrc/fused_decode_attention.cu
  and counts its launches in `launches`.
* `fused_decode_attention` is the front end: a CUDA tensor always goes to
  the kernel (or raises), a CPU tensor to the twin; `impl="plain"` asks for
  the twin on either device.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from vla_rft_tpu_torch.ops import cuda_build
from vla_rft_tpu_torch.ops.attention import _row_arg

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16  # query heads per kv head

# kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0

_fn = None


def fused_decode_attention_plain(q, k_new, v_new, ck, cv, layer_idx: int, cache_index: int,
                                 kv_starts=None, scale: Optional[float] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(attn_out (B, 1, Hq, D), ck, cv): the write, then one masked softmax
    over rows [kv_starts[b], cache_index] of layer `layer_idx`."""
    B, _, Hq, D = q.shape
    Hkv = ck.shape[2]
    li, idx = int(layer_idx), int(cache_index)
    scale = D ** -0.5 if scale is None else scale
    ck[li, :, :, idx] = k_new[:, 0].to(ck.dtype)
    cv[li, :, :, idx] = v_new[:, 0].to(cv.dtype)
    qf = q.float().reshape(B, Hkv, Hq // Hkv, D) * scale
    k, v = ck[li, :, :, :idx + 1].float(), cv[li, :, :, :idx + 1].float()
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k)
    pos = torch.arange(idx + 1, device=q.device)
    starts = _row_arg(kv_starts, B, 0, q.device).long()
    valid = ((pos[None] >= starts[:, None]) | (pos[None] == idx))[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(torch.clamp(s - m, min=-80.0)), 0.0)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v) / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return o.reshape(B, 1, Hq, D).to(q.dtype), ck, cv


def _load():
    global _fn
    if _fn is None:
        fn = cuda_build.load("fused_decode_attention").fused_decode_attention
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_decode_attention_kernel(q, k_new, v_new, ck, cv, layer_idx: int, cache_index: int,
                                  kv_starts=None, scale: Optional[float] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel #10; same arguments and result as the twin, all on one
    CUDA device: q bf16 or f32 (B, 1, Hq, D) with D in HEAD_DIMS and at
    most MAX_GROUP query heads per kv head, k_new / v_new (B, 1, Hkv, D) in
    any float dtype (cast to the cache's), the caches contiguous bf16 or
    f32 (L, B, Hkv, S, D); layer_idx and cache_index are ints, kv_starts a
    (B,) integer tensor or None."""
    global launches
    fdt = (torch.bfloat16, torch.float32)
    if not q.is_cuda or q.dim() != 4 or q.shape[1] != 1 or q.dtype not in fdt \
            or not q.is_contiguous():
        raise ValueError("fused decode attention: q must be a contiguous bf16 or f32 CUDA "
                         "tensor (B, 1, Hq, D)")
    B, _, Hq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"fused decode attention: head dim {D} not in {HEAD_DIMS}")
    for name, c in (("k cache", ck), ("v cache", cv)):
        if (c.device != q.device or c.dim() != 5 or c.dtype not in fdt or not c.is_contiguous()
                or c.shape[1] != B or c.shape[4] != D or c.data_ptr() % 16):
            raise ValueError(f"fused decode attention: {name} must be a contiguous bf16 or "
                             f"f32 (L, {B}, Hkv, S, {D}) tensor on q's device")
    L, _, Hkv, S, _ = ck.shape
    if cv.shape != ck.shape or cv.dtype != ck.dtype:
        raise ValueError("fused decode attention: k/v caches must match")
    if Hq % Hkv or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"fused decode attention: Hq={Hq} over {Hkv} kv heads "
                         f"(at most {MAX_GROUP} per kv head)")
    for name, x in (("k_new", k_new), ("v_new", v_new)):
        if x.device != q.device or x.shape != (B, 1, Hkv, D):
            raise ValueError(f"fused decode attention: {name} must be (B, 1, Hkv, D) on "
                             f"q's device")
    li, idx = int(layer_idx), int(cache_index)
    if not (0 <= li < L and 0 <= idx < S):
        raise ValueError(f"fused decode attention: layer {li} / row {idx} outside the cache "
                         f"({L} layers, {S} rows)")
    kn = k_new.to(ck.dtype).contiguous()
    vn = v_new.to(cv.dtype).contiguous()
    ks = _row_arg(kv_starts, B, 0, q.device)
    fn = _load()
    o = torch.empty_like(q)
    rc = fn(q.data_ptr(), kn.data_ptr(), vn.data_ptr(), ck.data_ptr(), cv.data_ptr(),
            o.data_ptr(), ks.data_ptr(), L, B, Hq, Hkv, S, D, li, idx,
            int(ck.dtype == torch.float32), int(q.dtype == torch.float32),
            float(D ** -0.5 if scale is None else scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused decode attention: launch failed with CUDA error {rc}")
    launches += 1
    return o, ck, cv


def fused_decode_attention(q, k_new, v_new, ck, cv, layer_idx: int, cache_index: int,
                           kv_starts=None, scale: Optional[float] = None, impl: str = "auto"):
    """Returns (attn_out (B, 1, Hq, D), ck, cv), the caches written in place."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    plain = impl == "plain" or q.device.type == "cpu"
    fn = fused_decode_attention_plain if plain else fused_decode_attention_kernel
    return fn(q, k_new, v_new, ck, cv, layer_idx, cache_index, kv_starts, scale)
