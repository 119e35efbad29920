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
  and counts its launches in `launches`; `split_plan` is its launch plan
  (the ranks of each (row, kv head) cluster, from host-known sizes only).
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
from vla_rft_tpu_torch.ops.decode_attention_hd import H100_SMS, _device_sms

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 16  # query heads per kv head
MAX_SPLITS = 8  # ranks of a (row, kv head) cluster: the portable limit
TARGET_BLOCKS_PER_SM = 1  # the splits aim at this many blocks per SM

# kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0

_fn = None


def key_tile(D: int, cache_dtype) -> int:
    """Keys of one of the kernel's tiles: 128, or 64 for an f32 cache at
    D = 128 (its 3-stage ring of 128-key K and V tiles would not fit in
    shared memory)."""
    return 64 if cache_dtype == torch.float32 and D == 128 else 128


def split_plan(B: int, Hq: int, Hkv: int, D: int, idx: int, cache_dtype,
               sms: int = H100_SMS) -> dict:
    """The launch plan of kernel #10: grid (splits, Hkv, B), cluster
    (splits, 1, 1).  Rank r of a (row b, kv head h) cluster takes the key
    tiles [r T / splits, (r + 1) T / splits) of the row's window [lo, idx),
    T = ceil((idx - lo) / key_tile) tiles counted from lo = clamp(kv_starts[b],
    0, idx); the kernel reads kv_starts[b] itself, so the plan uses only
    sizes the host knows and no call reads the device.  `splits` gives
    about TARGET_BLOCKS_PER_SM blocks per SM over the B * Hkv pairs, at most
    MAX_SPLITS and at most the tiles of a window that starts at row 0, so
    no rank is idle at large idx (a late kv_starts can still leave a rank
    without a tile: it contributes nothing).  One block per SM: a block
    streams its tiles at close to its share of the card's rate, so more
    ranks add their fixed costs (set-up, first tile, the cluster merge)
    and no rate; on an H100 this picks the fastest of 1-8 splits at the
    WM's B = 10 (1) and 128 rows (1), and 7 at GQA 14/2, where 4-8 are
    within 3 % (PERF.md section 6).  Hq is not used: the query
    heads of a kv head share its block."""
    del Hq
    tk = key_tile(D, cache_dtype)
    tiles = -(-idx // tk)
    splits = max(1, min(MAX_SPLITS, tiles, -(-TARGET_BLOCKS_PER_SM * sms // (B * Hkv))))
    return {"splits": splits, "key_tile": tk, "grid": (splits, Hkv, B),
            "cluster": (splits, 1, 1)}


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
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def fused_decode_attention_kernel(q, k_new, v_new, ck, cv, layer_idx: int, cache_index: int,
                                  kv_starts=None, scale: Optional[float] = None, *,
                                  splits: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch kernel #10; same arguments and result as the twin, all on one
    CUDA device: q bf16 or f32 (B, 1, Hq, D) with D in HEAD_DIMS and at
    most MAX_GROUP query heads per kv head, k_new / v_new (B, 1, Hkv, D) in
    any float dtype (cast to the cache's), the caches contiguous bf16 or
    f32 (L, B, Hkv, S, D); layer_idx and cache_index are ints, kv_starts a
    (B,) integer tensor or None.  `splits` (1..MAX_SPLITS) overrides
    split_plan's ranks per cluster; the result does not depend on it beyond
    f32 summation order."""
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
    if splits is None:
        splits = split_plan(B, Hq, Hkv, D, idx, ck.dtype, _device_sms(q.device))["splits"]
    if not 1 <= int(splits) <= MAX_SPLITS:
        raise ValueError(f"fused decode attention: splits {splits} not in 1..{MAX_SPLITS}")
    # the kernel copies q, k_new and v_new in 16-byte pieces
    aligned = lambda t: t if t.data_ptr() % 16 == 0 else t.clone()
    kn = aligned(k_new.to(ck.dtype).contiguous())
    vn = aligned(v_new.to(cv.dtype).contiguous())
    qa = aligned(q)
    ks = _row_arg(kv_starts, B, 0, q.device)
    fn = _load()
    o = torch.empty_like(q)
    rc = fn(qa.data_ptr(), kn.data_ptr(), vn.data_ptr(), ck.data_ptr(), cv.data_ptr(),
            o.data_ptr(), ks.data_ptr(), L, B, Hq, Hkv, S, D, li, idx,
            int(ck.dtype == torch.float32), int(q.dtype == torch.float32), int(splits),
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
