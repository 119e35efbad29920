"""Split-cache decode attention over the head-dense KV cache + its plain twins.

Port of vla_rft_tpu/ops/decode_attention_hd.py (kernels #4
`_shared_kernel_hd` and #5 `_plain_kernel_hd`).  The cache of one layer is
(rows, S, Hkv*D), int8 with bf16 per-(position, head) scales laid out
(rows, Hkv, S), or in the compute dtype without scales.  Every function
takes that layer's slice (`ck[li]` of the stacked cache, a contiguous view)
and q (B, Sq, Hq, D), and returns O (B, Sq, Hq, D) in q's dtype.

The semantics are those of the reference's XLA fallback
(models/transformer.py:503-545 shared, :569-596 plain): dequantise to the
compute dtype, gather each row's shared prefix through `prefix_map` and cut
it to `shared_len`, put it before the row's own cache, then masked causal
attention in f32 with `q_offset` (the cache index), `kv_lens` (absolute end
of the valid keys) and `kv_starts` / `shared_starts` (absolute start), 0 for
a row with no valid key.  The Pallas kernels' int8 requantisation of q and
p is a TPU trick and is not ported.

* `decode_shared_plain` / `decode_plain` are those twins in PyTorch; they
  run for CPU tensors, and on the card the kernels are checked against them.
* `decode_shared_kernel` / `decode_kernel` launch csrc/decode_hd.cu (one
  source, a template flag for the shared segment) and count their launches
  in `shared_launches` / `plain_launches`.  `_launch` checks and launches
  for both cache layouts: ops/decode_attention.py (kernels #6 / #7 over
  the 'heads' layout, csrc/decode_heads.cu) goes through it too.
  `decode_plan` is the kernel's launch plan: its chunks of rows that share
  a prefix, the grid slots that hold them, and the key splits (one
  cluster) over each chunk's 128-key tiles.
* `decode_attention_shared_hd` / `decode_attention_hd` are the front ends:
  a CUDA tensor always goes to the kernel (or raises), a CPU tensor to the
  twin; `impl="plain"` asks for the twin on either device.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from vla_rft_tpu_torch.ops import cuda_build
from vla_rft_tpu_torch.ops.attention import _row_arg, attention_plain

HEAD_DIM = 64
MAX_QUERY_ROWS = 64  # query rows of a block: a chunk's rows times G * Sq
MAX_SQ = 8
KEY_TILE = 128  # keys of a tile
MAX_SPLITS = 8  # blocks of a chunk: one cluster (the portable limit)
MAX_ROWS = 1024  # batch rows and prefix rows the kernel's chunk search takes
H100_SMS = 132  # the plan is made for the device's SM count; this when none is given
TARGET_BLOCKS_PER_SM = 4  # the splits aim at this many blocks per SM ...
MIN_TILES_PER_SPLIT = 3  # ... with at least this many key tiles each

# kernel launches since the counts were last set to 0 (read by chip_smoke.py)
shared_launches = 0
plain_launches = 0

_libs = {}  # library name -> its loaded C entry point
_sms = {}  # device index -> SM count


# ================================================================ plain twins
def dequantize(c: torch.Tensor, s: Optional[torch.Tensor], D: int, dtype) -> torch.Tensor:
    """(rows, S, Hkv*D) cache [+ (rows, Hkv, S) scales] -> (rows, S, Hkv, D)
    in `dtype`: int8 values times their f32-cast bf16 scale, then rounded to
    the compute dtype, as the fallback does."""
    rows, S, HD = c.shape
    c = c.reshape(rows, S, HD // D, D)
    if s is None:
        return c.to(dtype)
    return (c.float() * s.float().transpose(1, 2)[..., None]).to(dtype)


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
_LIBRARIES = {"hd": "decode_hd", "heads": "decode_heads"}  # layout -> csrc/<name>.cu


def _load(layout: str = "hd"):
    """The decode library of a cache layout: csrc/decode_hd.cu (kernels #4 /
    #5) or csrc/decode_heads.cu (#6 / #7), one C entry point each."""
    name = _LIBRARIES[layout]
    if name not in _libs:
        fn = getattr(cuda_build.load(name), name)
        fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 10 + [
            ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _libs[name] = fn
    return _libs[name]


@functools.lru_cache(maxsize=1024)
def decode_plan(B: int, Sq: int, G: int, Hkv: int, Sr: int, shared: bool, n_prefix: int = 0,
                shared_len: int = 0, sms: int = H100_SMS) -> dict:
    """The launch plan of the decode kernel (#4-#7): grid (splits, Hkv,
    slots), cluster (splits, 1, 1).

    * `chunk_rows`: with a shared prefix, the rows of one prefix group are
      cut in row order into chunks of this many rows, as many as fill the
      kernel's query tile: `m_tiles` m16 tiles, 1 when one row's G * Sq
      query rows fit 16 (16 rows at G * Sq = 1), else 4 (MAX_QUERY_ROWS);
      each chunk reads its prefix tiles once for all its rows.  Without
      one, a chunk is one row.
    * `slots`: grid slots for the chunks.  The kernel finds its chunk from
      prefix_map on the device (group u's chunks follow group u - 1's);
      sum_u ceil(n_u / chunk_rows) <= min(B, n_prefix + B // chunk_rows),
      and slots past the last chunk return at once.
    * `splits`: ranks of a chunk's cluster, each taking a contiguous share
      of the chunk's key tiles (prefix tiles, then each row's own tiles),
      merged in rank order: enough to give about TARGET_BLOCKS_PER_SM
      blocks per SM over the slots (a block of int8 tiles holds a 50 KB
      ring and at most 128 registers a thread: four fit on an SM), at most
      MAX_SPLITS and at most one per MIN_TILES_PER_SPLIT tiles of a chunk
      (estimated from shared_len, Sr and the mean group size; the kernel
      counts them from the rows).  On an H100 this picks the fastest of 1,
      2, 3, 4 and 8 splits at the WM's B = 10 with and without a prefix and
      at 128 rows (PERF.md section 6, PR 11).
    Cached: callers must not change the result."""
    gsq = G * Sq
    m_tiles = 1 if gsq <= 16 else 4
    tiles_per_row = -(-Sr // KEY_TILE)
    if shared:
        chunk_rows = (16 * m_tiles) // gsq
        slots = min(B, n_prefix + B // chunk_rows)
        tiles = -(-shared_len // KEY_TILE) + min(chunk_rows, -(-B // n_prefix)) * tiles_per_row
    else:
        chunk_rows, slots, tiles = 1, B, tiles_per_row
    splits = max(1, min(MAX_SPLITS, tiles // MIN_TILES_PER_SPLIT,
                        -(-TARGET_BLOCKS_PER_SM * sms // (slots * Hkv))))
    return {"chunk_rows": chunk_rows, "m_tiles": m_tiles, "slots": slots, "splits": splits,
            "grid": (splits, Hkv, slots)}


def _device_sms(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _cache_dims(c, layout: str, D: int):
    """(rows, S, Hkv) of one layer's cache slice, or None if its shape is
    not the layout's: (rows, S, Hkv*D) for "hd", (rows, Hkv, S, D) for
    "heads"."""
    if layout == "hd" and c.dim() == 3 and c.shape[2] % D == 0:
        return c.shape[0], c.shape[1], c.shape[2] // D
    if layout == "heads" and c.dim() == 4 and c.shape[3] == D:
        return c.shape[0], c.shape[2], c.shape[1]
    return None


def _check_cache(name, c, s, q, layout):
    if not c.is_cuda or c.device != q.device:
        raise ValueError(f"decode kernel: {name} must be on q's CUDA device")
    dims = _cache_dims(c, layout, q.shape[-1])
    if dims is None or not c.is_contiguous():
        want = "(rows, S, Hkv*D)" if layout == "hd" else "(rows, Hkv, S, D)"
        raise ValueError(f"decode kernel: {name} must be a contiguous {want} tensor with "
                         f"D = {q.shape[-1]}, got {tuple(c.shape)}")
    rows, S, Hkv = dims
    if c.dtype == torch.int8:
        if s is None:
            raise ValueError(f"decode kernel: int8 {name} needs its scales")
        if (s.dtype != torch.bfloat16 or s.shape != (rows, Hkv, S)
                or not s.is_contiguous() or s.device != q.device):
            raise ValueError(f"decode kernel: scales of {name} must be contiguous bf16 "
                             f"(rows, Hkv, S) on q's device")
    elif c.dtype != torch.bfloat16 or s is not None:
        raise ValueError(f"decode kernel: {name} must be int8 with scales or bf16 without, "
                         f"got {c.dtype}")
    if c.data_ptr() % 16:
        raise ValueError(f"decode kernel: {name} must start on a 16-byte boundary")
    return dims


def _launch(q, ck, cv, scales, shared, prefix_map, shared_len, kv_lens, q_offset, kv_starts,
            layout: str = "hd"):
    """Check the arguments and launch the decode kernel of `layout` (#4 / #5
    for "hd", #6 / #7 for "heads"); `shared` is (sck, scv, ssk, ssv) or
    None."""
    if q.dtype != torch.bfloat16 or q.dim() != 4 or not q.is_contiguous():
        raise ValueError("decode kernel: q must be a contiguous 4-D bf16 CUDA tensor")
    B, Sq, Hq, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"decode kernel: head dim {D} != {HEAD_DIM}")
    if not 1 <= Sq <= MAX_SQ:
        raise ValueError(f"decode kernel: {Sq} query positions, the kernel takes 1..{MAX_SQ}")
    if not q.is_cuda:
        raise ValueError("decode kernel: q must be a contiguous 4-D bf16 CUDA tensor")
    if q.data_ptr() % 16:
        raise ValueError("decode kernel: q must start on a 16-byte boundary")
    sk, sv = scales if scales is not None else (None, None)
    rows, Sr, Hkv = _check_cache("k cache", ck, sk, q, layout)
    _check_cache("v cache", cv, sv, q, layout)
    if Hkv == 0 or Hq % Hkv or (Hq // Hkv) * Sq > MAX_QUERY_ROWS:
        raise ValueError(f"decode kernel: Hq={Hq}, {Hkv} kv heads and Sq={Sq} do not fit")
    if ck.shape != cv.shape or ck.dtype != cv.dtype or rows != B:
        raise ValueError("decode kernel: k/v caches must match each other and q's batch")
    int8 = ck.dtype == torch.int8
    dev = q.device
    null = 0
    if shared is not None:
        sck, scv, ssk, ssv = shared
        _, Sp, sh_heads = _check_cache("shared k cache", sck, ssk, q, layout)
        _check_cache("shared v cache", scv, ssv, q, layout)
        if (sck.shape != scv.shape or sck.dtype != ck.dtype or scv.dtype != ck.dtype
                or sh_heads != Hkv):
            raise ValueError("decode kernel: shared caches must match the own cache's type "
                             "and heads")
        if not 0 <= shared_len <= Sp:
            raise ValueError(f"decode kernel: shared_len {shared_len} outside the prefix cache")
        n_prefix = sck.shape[0]
        if n_prefix < 1 or max(B, n_prefix) > MAX_ROWS:
            raise ValueError(f"decode kernel: {B} rows over {n_prefix} prefixes, the kernel "
                             f"takes at most {MAX_ROWS} of each")
        pm = _row_arg(prefix_map, B, 0, dev)
        sh_ptrs = (sck.data_ptr(), scv.data_ptr(), ssk.data_ptr() if int8 else null,
                   ssv.data_ptr() if int8 else null, pm.data_ptr())
    else:
        sh_ptrs, Sp, n_prefix = (null,) * 5, 0, 0
    plan = decode_plan(B, Sq, Hq // Hkv, Hkv, Sr, shared is not None, n_prefix, int(shared_len),
                       _device_sms(dev))
    kl = _row_arg(kv_lens, B, 0, dev)
    qo = _row_arg(q_offset, B, 0, dev)
    ks = _row_arg(kv_starts, B, 0, dev)
    fn = _load(layout)
    o = torch.empty_like(q)
    rc = fn(
        q.data_ptr(), o.data_ptr(), ck.data_ptr(), cv.data_ptr(),
        sk.data_ptr() if int8 else null, sv.data_ptr() if int8 else null, *sh_ptrs,
        kl.data_ptr(), qo.data_ptr(), ks.data_ptr(),
        B, Sq, Hq, Hkv, D, Sr, Sp, int(shared_len), int(int8), int(shared is not None),
        float(D ** -0.5), n_prefix, plan["chunk_rows"], plan["slots"], plan["splits"],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"decode kernel: launch failed with CUDA error {rc}")
    return o


def decode_shared_kernel(q, ck, cv, sck, scv, prefix_map, *, shared_len: int, kv_lens,
                         q_offset, shared_starts=None, scales: Optional[Tuple] = None,
                         shared_scales: Optional[Tuple] = None) -> torch.Tensor:
    """Launch kernel #4 (split cache); same arguments as `decode_shared_plain`,
    all on one CUDA device, q bf16 with D = 64 and Sq <= 8.  Per-row
    arguments are (B,) integer tensors.  prefix_map must index rows of the
    shared cache (not checked: that would synchronise)."""
    global shared_launches
    ssk, ssv = shared_scales if shared_scales is not None else (None, None)
    o = _launch(q, ck, cv, scales, (sck, scv, ssk, ssv), prefix_map, shared_len, kv_lens,
                q_offset, shared_starts)
    shared_launches += 1
    return o


def decode_kernel(q, ck, cv, *, kv_lens, q_offset, kv_starts=None,
                  scales: Optional[Tuple] = None) -> torch.Tensor:
    """Launch kernel #5 (single cache); same arguments as `decode_plain`."""
    global plain_launches
    o = _launch(q, ck, cv, scales, None, None, 0, kv_lens, q_offset, kv_starts)
    plain_launches += 1
    return o


# ================================================================= front ends
def _use_plain(q, impl: str) -> bool:
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown decode impl {impl!r}")
    return impl == "plain" or q.device.type == "cpu"


def decode_attention_shared_hd(q, ck, cv, sck, scv, prefix_map, *, shared_len: int, kv_lens,
                               q_offset, shared_starts=None, scales=None, shared_scales=None,
                               impl: str = "auto") -> torch.Tensor:
    fn = decode_shared_plain if _use_plain(q, impl) else decode_shared_kernel
    return fn(q, ck, cv, sck, scv, prefix_map, shared_len=shared_len, kv_lens=kv_lens,
              q_offset=q_offset, shared_starts=shared_starts, scales=scales,
              shared_scales=shared_scales)


def decode_attention_hd(q, ck, cv, *, kv_lens, q_offset, kv_starts=None, scales=None,
                        impl: str = "auto") -> torch.Tensor:
    fn = decode_plain if _use_plain(q, impl) else decode_kernel
    return fn(q, ck, cv, kv_lens=kv_lens, q_offset=q_offset, kv_starts=kv_starts, scales=scales)
