"""Attention: a hand-written CUDA flash forward for Hopper + its plain twin.

Port of vla_rft_tpu/ops/attention.py.  Layout (B, S, H, D) throughout; GQA
maps query head h to kv head h // (Hq // Hkv); per-row `kv_lens` (right
padding), `kv_starts` (left padding) and `q_offset` (absolute position of
q[:, 0], for chunked prefill); optional causal masking.

* `attention_plain` is the reference's `_attention_xla` in PyTorch: f32
  scores, bounded softmax, fully-masked rows give 0.  It runs for CPU
  tensors, and on the card it is the twin the kernel is checked against.
* `flash_fwd` wraps the CUDA kernel in `csrc/flash_fwd.cu` (the port of the
  Pallas `_fwd_kernel`): bf16 q/k/v -> bf16 O and f32 LSE, launched on the
  current stream without synchronising.  It counts its launches in the
  module-level `launches`.
* `attention` is the front end: a CUDA tensor always goes to the kernel (or
  raises), a CPU tensor to the plain twin; `impl="plain"` asks for the twin
  on either device.

The kernel library is compiled by nvcc at first use into `_build/` beside
the package (a plain C interface loaded with ctypes), keyed by a hash of the
source and flags, so an unchanged tree does not rebuild.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

_PKG = Path(__file__).resolve().parent.parent
_FLASH_SRC = _PKG / "csrc" / "flash_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SUPPORTED_HEAD_DIMS = (64, 128)

# kernel launches since the count was last set to 0 (read by chip_smoke.py)
launches = 0

_lib = None


# ================================================================ plain twin
def _as_rows(x, B: int, device) -> Optional[torch.Tensor]:
    if x is None:
        return None
    return torch.as_tensor(x, device=device).to(torch.int64).reshape(B)


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
    dev = q.device
    qh = q.reshape(B, Sq, Hkv, group, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qh, k.float()) * scale
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


# ============================================================ kernel library
def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_flash_fwd() -> dict:
    """Compile csrc/flash_fwd.cu into a shared library unless a build of the
    same source and flags exists; returns {path, seconds, built, log}."""
    src = _FLASH_SRC.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libflash_fwd_{key}.so"
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_FLASH_SRC)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "built": True,
            "log": proc.stdout + proc.stderr}


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_flash_fwd()["path"])
        fn = lib.flash_fwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _row_arg(x, B: int, default: int, device) -> torch.Tensor:
    if x is None:
        return torch.full((B,), default, dtype=torch.int32, device=device)
    t = torch.as_tensor(x, device=device)
    if t.shape != (B,):
        raise ValueError(f"per-row argument must have shape ({B},), got {tuple(t.shape)}")
    return t.to(torch.int32).contiguous()


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
    bf16, contiguous, on one CUDA device, D in {64, 128}.  Returns O
    (B, Sq, Hq, D) bf16 and LSE (B, Sq, Hq) f32; does not synchronise."""
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_fwd: {name} must be a CUDA tensor")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"flash_fwd: {name} must be bfloat16, got {t.dtype}")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be a contiguous 4-D tensor")
        if t.device != q.device:
            raise ValueError("flash_fwd: q, k and v must share a device")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_fwd: k/v shape {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    Sk, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"flash_fwd: Hq={Hq} is not a multiple of Hkv={Hkv}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_fwd: head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if min(B, Sq, Sk) == 0:
        raise ValueError("flash_fwd: empty input")
    if scale is None:
        scale = D ** -0.5
    dev = q.device
    kl = _row_arg(kv_lens, B, Sk, dev)
    qo = _row_arg(q_offset, B, 0, dev)
    ks = _row_arg(kv_starts, B, 0, dev)
    lib = _load()
    o = torch.empty_like(q)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        kl.data_ptr(), qo.data_ptr(), ks.data_ptr(),
        B, Sq, Sk, Hq, Hkv, D, float(scale), int(bool(causal)), stream,
    )
    if rc != 0:
        raise RuntimeError(f"flash_fwd: kernel launch failed with CUDA error {rc}")
    launches += 1
    return o, lse


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

    impl: "auto" launches the CUDA kernel for CUDA tensors and runs the
    plain twin for CPU tensors; "plain" runs the twin on either device.
    There is no fallback: a CUDA input the kernel does not take raises."""
    if impl == "plain" or (impl == "auto" and q.device.type == "cpu"):
        return attention_plain(
            q, k, v, causal=causal, kv_lens=kv_lens, q_offset=q_offset,
            kv_starts=kv_starts, scale=scale, return_lse=return_lse,
        )
    if impl != "auto":
        raise ValueError(f"unknown attention impl {impl!r}")
    o, lse = flash_fwd(
        q, k, v, causal=causal, kv_lens=kv_lens, q_offset=q_offset,
        kv_starts=kv_starts, scale=scale,
    )
    return (o, lse) if return_lse else o
