"""Attention: hand-written CUDA flash kernels for Hopper + their plain twins.

Port of vla_rft_tpu/ops/attention.py.  Layout (B, S, H, D) throughout; GQA
maps query head h to kv head h // (Hq // Hkv); per-row `kv_lens` (right
padding), `kv_starts` (left padding) and `q_offset` (absolute position of
q[:, 0], for chunked prefill); optional causal masking.

* `attention_plain` is the reference's `_attention_xla` in PyTorch: f32
  scores, bounded softmax, fully-masked rows give 0.  It runs for CPU
  tensors, and on the card it is the twin the kernel is checked against.
* `flash_fwd` wraps the CUDA kernel in `csrc/flash_fwd.cu` (the port of the
  Pallas `_fwd_kernel`): bf16 q/k/v -> bf16 O and f32 LSE at D 64 / 128, or
  the f32 instance (`csrc/flash_f32.cuh`, for the f32 push models) f32
  q/k/v -> f32 O and LSE at D 32 / 64, launched on the current stream
  without synchronising.  It counts its launches in the
  module-level `launches`, by the batch's rows in `launches_by_rows` and
  by the head dim in `launches_by_head_dim`.
* `attention_bwd_plain` is the backward's twin: the explicit formula of the
  Pallas `_dq_kernel` / `_dkv_kernel` (p recomputed from the LSE with the
  bounded exp, dS = p (dP - delta) scale), in f32.
* `flash_bwd_dq` / `flash_bwd_dkv` wrap the CUDA kernels in
  `csrc/flash_bwd.cu` (ports of `_dq_kernel` and `_dkv_kernel`; bf16 at D
  64 / 128, or their f32 instances at D 32 / 64), counted in
  `bwd_dq_launches` / `bwd_dkv_launches`; `flash_bwd` computes delta and
  launches both.  `dkv_plan` is #3's launch plan: its 64-key tiles and the
  blocks (one cluster) that share each tile's (query head, query tile)
  pairs; `dq_plan` is #2's: its grid and the order of its query tiles.
* `FlashAttention` is the autograd Function around them: the forward runs
  #1 (or the twin with its LSE), the backward #2 and #3 (or the backward
  twin), as the reference's `jax.custom_vjp` does.
* `attention` is the front end: when autograd needs a gradient through it,
  it goes through `FlashAttention`; otherwise a CUDA tensor goes straight to
  the forward kernel (or raises) and a CPU tensor to the plain twin.
  `impl="plain"` asks for the twins on either device.

The kernel libraries are compiled by nvcc at first use (`ops/cuda_build.py`:
a plain C interface loaded with ctypes, keyed by a hash of the source and
flags, so an unchanged tree does not rebuild).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from vla_rft_tpu_torch.ops import cuda_build

NEG_INF = -1e30

SUPPORTED_HEAD_DIMS = (64, 128)  # the bf16 instances
F32_HEAD_DIMS = (32, 64)  # the f32 instances (the push preset's policy LLM and WM)
TILE = 64  # queries or keys of a kernel tile
H100_SMS = 132  # #3's plan is made for the device's SM count; this when none is given
DKV_MAX_SPLITS = 4  # blocks per key tile of #3: one cluster

# kernel launches since the count was last set to 0 (read by chip_smoke.py):
# the forward (#1), the backward's dQ (#2) and dK/dV (#3); #1's also by rows
# and by head dim
launches = 0
launches_by_rows = {}  # B -> #1 launches with q of B rows
launches_by_head_dim = {}  # D -> #1 launches at head dim D
bwd_dq_launches = 0
bwd_dkv_launches = 0

_lib = None
_bwd_lib = None
_ready = set()  # device indices whose forward shared-memory limits are set
_bwd_sms = {}  # device index -> SM count, once the backward's shared-memory limits are set


# ================================================================ plain twin
def _as_rows(x, B: int, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(x, device=device).to(torch.int64).reshape(B)


def _valid(B: int, Sq: int, Sk: int, dev, causal, kv_lens, q_offset, kv_starts):
    """(B, 1, 1, Sq, Sk) bool: which keys each query may attend to."""
    kv_pos = torch.arange(Sk, device=dev)[None, :]
    mask = torch.ones((B, 1, 1, Sq, Sk), dtype=torch.bool, device=dev)
    kv_lens = _as_rows(kv_lens, B, dev)
    kv_starts = _as_rows(kv_starts, B, dev)
    if kv_lens is not None:
        mask = mask & (kv_pos < kv_lens[:, None])[:, None, None, None, :]
    if kv_starts is not None:
        mask = mask & (kv_pos >= kv_starts[:, None])[:, None, None, None, :]
    if causal:
        q_pos = torch.arange(Sq, device=dev)[None, :]
        if q_offset is not None:
            q_pos = q_pos + _as_rows(q_offset, B, dev)[:, None]
        cm = q_pos[:, :, None] >= kv_pos[:, None, :]  # (B, Sq, Sk)
        mask = mask & cm[:, None, None, :, :]
    return mask


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens=None,
    q_offset=None,
    kv_starts=None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """`_attention_xla` semantics: f32 scores and softmax, masked lanes 0,
    fully-masked rows give O = 0 (and LSE = -1e30).  Returns O in q's dtype,
    plus the f32 LSE of shape (B, Sq, Hq) when `return_lse`."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qh = q.reshape(B, Sq, Hkv, group, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * scale
    mask = _valid(B, Sq, Sk, q.device, causal, kv_lens, q_offset, kv_starts)
    # bounded arithmetic as in the reference: finite fill for the max,
    # masked lanes see exp(0) and are then zeroed, the denominator is
    # clamped at 0.5 (exact for any row with a valid lane)
    m = torch.where(mask, s, torch.full_like(s, -1e4)).amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(torch.where(mask, s, m) - m), torch.zeros_like(s))
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom.clamp_min(0.5)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(B, Sq, Hq, D).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(
        denom > 0, m + torch.log(denom.clamp_min(1e-30)), torch.full_like(m, NEG_INF)
    )
    lse = lse.reshape(B, Hq, Sq).transpose(1, 2).contiguous()
    return out, lse


def attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens=None,
    q_offset=None,
    kv_starts=None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's twin: the explicit formula of the reference's
    `_dq_kernel` and `_dkv_kernel` (not autograd of `attention_plain`), in
    f32.  delta = sum_D dO * O from the stored O and dO; p = exp(max(s -
    lse, -80)) on valid lanes and 0 elsewhere (a fully-masked row, lse =
    -1e30, gives 0); dS = p (dP - delta) scale; dK/dV sum over the query
    heads of each kv group.  Returns dq, dk, dv in q/k/v's dtypes."""
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    group = Hq // Hkv
    if scale is None:
        scale = D ** -0.5
    qf = q.reshape(B, Sq, Hkv, group, D).float()
    dof = do.reshape(B, Sq, Hkv, group, D).float()
    kf, vf = k.float(), v.float()
    per_row = lambda x: x.reshape(B, Sq, Hkv, group).permute(0, 2, 3, 1)[..., None]
    delta = per_row((do.float() * o.float()).sum(dim=-1))  # (B, Hkv, G, Sq, 1)
    mask = _valid(B, Sq, Sk, q.device, causal, kv_lens, q_offset, kv_starts)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    x = torch.where(mask, s - per_row(lse.float()), torch.zeros_like(s))
    p = torch.where(mask, torch.exp(x.clamp_min(-80.0)), torch.zeros_like(s))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, kf).reshape(B, Sq, Hq, D)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ============================================================ kernel library
def _load():
    global _lib
    if _lib is None:
        lib = cuda_build.load("flash_fwd")
        for fn in (lib.flash_fwd_bf16, lib.flash_fwd_f32):
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
        lib.flash_fwd_setup.restype = ctypes.c_int
        lib.flash_fwd_setup.argtypes = []
        _lib = lib
    return _lib


def _fwd_lib(dev: torch.device):
    """The forward's library, with its shared-memory limits set once on `dev`."""
    lib = _load()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _ready:
        with torch.cuda.device(idx):
            rc = lib.flash_fwd_setup()
        if rc != 0:
            raise RuntimeError(f"flash_fwd: setup failed with CUDA error {rc}")
        _ready.add(idx)
    return lib



def _load_bwd():
    global _bwd_lib
    if _bwd_lib is None:
        lib = cuda_build.load("flash_bwd")
        tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int]
        lib.flash_bwd_dq_bf16.argtypes = [ctypes.c_void_p] * 10 + tail + [ctypes.c_void_p]
        lib.flash_bwd_dkv_bf16.argtypes = ([ctypes.c_void_p] * 11 + tail
                                           + [ctypes.c_int, ctypes.c_void_p])
        lib.flash_bwd_dq_f32.argtypes = [ctypes.c_void_p] * 10 + tail + [ctypes.c_void_p]
        lib.flash_bwd_dkv_f32.argtypes = [ctypes.c_void_p] * 11 + tail + [ctypes.c_void_p]
        lib.flash_bwd_setup.argtypes = []
        for fn in (lib.flash_bwd_dq_bf16, lib.flash_bwd_dkv_bf16, lib.flash_bwd_dq_f32,
                   lib.flash_bwd_dkv_f32, lib.flash_bwd_setup):
            fn.restype = ctypes.c_int
        _bwd_lib = lib
    return _bwd_lib


def _bwd_device_lib(dev: torch.device):
    """The backward's library, with its shared-memory limits set once on
    `dev`, and the device's SM count."""
    lib = _load_bwd()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _bwd_sms:
        with torch.cuda.device(idx):
            rc = lib.flash_bwd_setup()
        if rc != 0:
            raise RuntimeError(f"flash_bwd: setup failed with CUDA error {rc}")
        _bwd_sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return lib, _bwd_sms[idx]


@functools.lru_cache(maxsize=256)
def dkv_plan(B: int, Sk: int, Hq: int, Hkv: int, sms: int = H100_SMS) -> dict:
    """The launch plan of kernel #3: one block per (64-key tile, kv head,
    batch row) or, where those blocks would not fill the three per SM that
    fit and the kv group has several query heads, `splits` blocks per key
    tile (a power of two, at most DKV_MAX_SPLITS and the group size G), one
    cluster, rank r taking the tile's (query head, query tile) pairs r, r +
    splits, ... in head-major order (at the VLA-adapter shape 4 splits ran
    faster than 2 and 1 on an H100: PERF.md §6).  The key tile is the
    grid's slowest axis, so under causal masking the low tiles, which the
    most query tiles see, start first.  Returns {"key_tiles", "splits",
    "grid": (splits, B * Hkv, key_tiles)}.  Cached: callers must not change
    the result."""
    key_tiles = -(-Sk // TILE)
    tiles, cap = B * Hkv * key_tiles, min(Hq // Hkv, DKV_MAX_SPLITS)
    splits = 1
    while 2 * splits <= cap and tiles * splits < 3 * sms:
        splits *= 2
    return {"key_tiles": key_tiles, "splits": splits, "grid": (splits, B * Hkv, key_tiles)}


def dq_plan(B: int, Sq: int, Hq: int, causal: bool) -> dict:
    """The launch plan of kernel #2, as csrc/flash_bwd.cu launches it: one
    block per (64-query tile, query head, batch row), grid (Hq, B,
    query_tiles), the query tile the slowest axis.  Under causal masking
    grid index z runs query tile query_tiles - 1 - z, so the last tiles,
    which see the most keys, start first.  Returns {"query_tiles", "grid",
    "tile_order"} (tile_order[z]: the query tile of grid index z)."""
    n_qt = -(-Sq // TILE)
    order = list(range(n_qt))
    return {"query_tiles": n_qt, "grid": (Hq, B, n_qt),
            "tile_order": order[::-1] if causal else order}


def _row_arg(x, B: int, default: int, device) -> torch.Tensor:
    if x is None:
        return torch.full((B,), default, dtype=torch.int32, device=device)
    t = torch.as_tensor(x, device=device)
    if t.shape != (B,):
        raise ValueError(f"per-row argument must have shape ({B},), got {tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


def _check(fn: str, q, k, v, extra=()):
    """Raise unless q/k/v (and the `extra` (name, tensor) pairs, shaped like
    q) are what the kernels take: all bf16 with D in SUPPORTED_HEAD_DIMS, or
    all f32 with D in F32_HEAD_DIMS; returns (B, Sq, Sk, Hq, Hkv, D)."""
    for name, t in (("q", q), ("k", k), ("v", v), *extra):
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} must be a CUDA tensor")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise ValueError(f"{fn}: {name} must be bfloat16 or float32 like q, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be a contiguous 4-D tensor")
        if t.device != q.device:
            raise ValueError(f"{fn}: q, k and v must share a device")
    for name, t in extra:
        if t.shape != q.shape:
            raise ValueError(f"{fn}: {name} shape {tuple(t.shape)} differs from q's")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"{fn}: k/v shape {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{fn}: Hq={Hq} is not a multiple of Hkv={Hkv}")
    dims = SUPPORTED_HEAD_DIMS if q.dtype == torch.bfloat16 else F32_HEAD_DIMS
    if D not in dims:
        raise ValueError(f"{fn}: head dim {D} not in {dims} for {q.dtype}")
    if min(B, Sq, Sk) == 0:
        raise ValueError(f"{fn}: empty input")
    return B, Sq, Sk, Hq, Hkv, D


def _check_rows_f32(fn: str, q, named):
    """Raise unless each (name, t) is a contiguous f32 (B, Sq, Hq) tensor on
    q's device."""
    for name, t in named:
        if t.dtype != torch.float32 or t.shape != q.shape[:3] or not t.is_contiguous() \
                or t.device != q.device:
            raise ValueError(f"{fn}: {name} must be a contiguous float32 {tuple(q.shape[:3])} "
                             f"tensor on q's device")


def _rows(B: int, Sk: int, dev, kv_lens, q_offset, kv_starts):
    return (_row_arg(kv_lens, B, Sk, dev), _row_arg(q_offset, B, 0, dev),
            _row_arg(kv_starts, B, 0, dev))


def flash_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens=None,
    q_offset=None,
    kv_starts=None,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA flash forward.  q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D),
    contiguous, on one CUDA device: bf16 with D in {64, 128}, or f32 with D
    in {32, 64}.  Returns O (B, Sq, Hq, D) in q's dtype and LSE (B, Sq, Hq)
    f32; does not synchronise."""
    global launches
    B, Sq, Sk, Hq, Hkv, D = _check("flash_fwd", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_fwd: {name} must start on a 16-byte boundary")
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    kl, qo, ks = _rows(B, Sk, dev, kv_lens, q_offset, kv_starts)
    lib = _fwd_lib(dev)
    o = torch.empty_like(q)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    launch = lib.flash_fwd_bf16 if q.dtype == torch.bfloat16 else lib.flash_fwd_f32
    rc = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        kl.data_ptr(), qo.data_ptr(), ks.data_ptr(),
        B, Sq, Sk, Hq, Hkv, D, float(scale), int(bool(causal)), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd: kernel launch failed with CUDA error {rc}")
    launches += 1
    launches_by_rows[B] = launches_by_rows.get(B, 0) + 1
    launches_by_head_dim[D] = launches_by_head_dim.get(D, 0) + 1
    return o, lse


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = False, kv_lens=None,
                 q_offset=None, kv_starts=None, scale: Optional[float] = None) -> torch.Tensor:
    """Launch kernel #2: dq (B, Sq, Hq, D) from q, k, v, dO (all bf16, or all
    f32: the f32 instance) and the f32 forward LSE and delta = sum_D dO * O,
    both (B, Sq, Hq); q/k/v/dO on 16-byte boundaries.  The bf16 plan is
    `dq_plan`'s; the f32 instance takes one block per 32-query tile."""
    global bwd_dq_launches
    B, Sq, Sk, Hq, Hkv, D = _check("flash_bwd_dq", q, k, v, (("do", do),))
    _check_rows_f32("flash_bwd_dq", q, (("lse", lse), ("delta", delta)))
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_bwd_dq: {name} must start on a 16-byte boundary")
    scale = D ** -0.5 if scale is None else scale
    kl, qo, ks = _rows(B, Sk, q.device, kv_lens, q_offset, kv_starts)
    lib, _ = _bwd_device_lib(q.device)
    dq = torch.empty_like(q)
    launch = lib.flash_bwd_dq_bf16 if q.dtype == torch.bfloat16 else lib.flash_bwd_dq_f32
    rc = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), kl.data_ptr(), qo.data_ptr(), ks.data_ptr(),
        B, Sq, Sk, Hq, Hkv, D, float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dq: kernel launch failed with CUDA error {rc}")
    bwd_dq_launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = False, kv_lens=None,
                  q_offset=None, kv_starts=None,
                  scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel #3: dk, dv (B, Sk, Hkv, D) in k's dtype, each summed
    over the query heads of its kv group; inputs as `flash_bwd_dq`, q/k/v/dO
    on 16-byte boundaries.  The bf16 plan is `dkv_plan`'s; the f32 instance
    takes one block per 32-key tile."""
    global bwd_dkv_launches
    B, Sq, Sk, Hq, Hkv, D = _check("flash_bwd_dkv", q, k, v, (("do", do),))
    _check_rows_f32("flash_bwd_dkv", q, (("lse", lse), ("delta", delta)))
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_bwd_dkv: {name} must start on a 16-byte boundary")
    scale = D ** -0.5 if scale is None else scale
    kl, qo, ks = _rows(B, Sk, q.device, kv_lens, q_offset, kv_starts)
    lib, sms = _bwd_device_lib(q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), kl.data_ptr(), qo.data_ptr(),
            ks.data_ptr(), B, Sq, Sk, Hq, Hkv, D, float(scale), int(bool(causal)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if q.dtype == torch.bfloat16:
        rc = lib.flash_bwd_dkv_bf16(*ptrs, dkv_plan(B, Sk, Hq, Hkv, sms)["splits"], stream)
    else:
        rc = lib.flash_bwd_dkv_f32(*ptrs, stream)
    if rc != 0:
        raise RuntimeError(f"flash_bwd_dkv: kernel launch failed with CUDA error {rc}")
    bwd_dkv_launches += 1
    return dk, dv


def flash_bwd(q, k, v, o, lse, do, *, causal: bool = False, kv_lens=None, q_offset=None,
              kv_starts=None, scale: Optional[float] = None):
    """The flash backward on the card: delta = sum_D dO * O in f32 (a torch
    reduction, as the reference computes it outside Pallas), then kernels #2
    and #3.  Returns dq, dk, dv in the inputs' dtype (bf16, or f32 from the
    f32 instances); does not synchronise."""
    _check("flash_bwd", q, k, v, (("o", o), ("do", do)))
    delta = (do.float() * o.float()).sum(dim=-1)
    kw = dict(causal=causal, kv_lens=kv_lens, q_offset=q_offset, kv_starts=kv_starts,
              scale=scale)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the flash backward (the reference's `jax.custom_vjp`
    around `_flash`).  The forward runs kernel #1 on the card (the twin with
    its LSE for CPU tensors or `impl="plain"`) and saves q, k, v, O and the
    LSE; the backward runs kernels #2 and #3 on the card (the backward twin
    otherwise).  Returns (O, LSE); the LSE's cotangent is ignored, as in the
    reference, and the per-row ints get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, q_offset, kv_starts, causal, scale, impl):
        kw = dict(causal=causal, kv_lens=kv_lens, q_offset=q_offset, kv_starts=kv_starts,
                  scale=scale)
        kernel = impl == "auto" and q.is_cuda
        if kernel:
            o, lse = flash_fwd(q, k, v, **kw)
        else:
            o, lse = attention_plain(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw, ctx.kernel = kw, kernel
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        bwd = flash_bwd if ctx.kernel else attention_bwd_plain
        dq, dk, dv = bwd(q, k, v, o, lse, do.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


# ================================================================ front end
def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    kv_lens=None,
    q_offset=None,
    kv_starts=None,
    scale: Optional[float] = None,
    impl: str = "auto",
    return_lse: bool = False,
):
    """Multi-head attention (the reference's `attention()` front end).

    impl: "auto" launches the CUDA kernels for CUDA tensors and runs the
    plain twins for CPU tensors; "plain" runs the twins on either device.
    When autograd needs a gradient through q, k or v, the call goes through
    `FlashAttention` (flash backward kernels on the card).  There is no
    fallback: a CUDA input the kernels do not take raises."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = FlashAttention.apply(q, k, v, kv_lens, q_offset, kv_starts, causal, scale,
                                      impl)
        return (o, lse) if return_lse else o
    kw = dict(causal=causal, kv_lens=kv_lens, q_offset=q_offset, kv_starts=kv_starts,
              scale=scale)
    if impl == "plain" or q.device.type == "cpu":
        return attention_plain(q, k, v, return_lse=return_lse, **kw)
    o, lse = flash_fwd(q, k, v, **kw)
    return (o, lse) if return_lse else o
