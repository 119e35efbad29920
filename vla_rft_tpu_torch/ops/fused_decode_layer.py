"""Fused decode-layer products of the int8-weight WM rollout + their plain twins.

Port of vla_rft_tpu/ops/fused_decode_layer.py (kernels #8 `_qkv_kernel` and
#9 `_o_mlp_kernel`).  Per decoder layer of a decode call:

  fused_rmsnorm_qkv:  x -> RMSNorm -> int8-weight q/k/v products -> rope(q, k)
                      -> per-(position, kv head) int8 quantisation of k and v
  fused_o_mlp:        attn -> o_proj -> + residual -> RMSNorm -> gate/up ->
                      silu * up -> down -> + residual

The math is the reference's, in its rounding order, which is bit-compatible
with the unfused int8 path (`QuantLinear`, `RMSNorm`, `rope`, `quantize_kv`
in models/transformer.py): bf16 activations times int8 weights widened to
bf16 with f32 accumulation, rounded to bf16, then times the bf16
per-output-channel scale.  Weights are one layer's (in, out) int8 kernel
and (out,) bf16 scale; a layer's slice `w[li]` of a stacked tensor is a
view, so nothing is copied.

* `rope_tables` stays plain PyTorch: it runs once per decode call, outside
  the layer loop, as in the reference.
* `fused_rmsnorm_qkv_plain` / `fused_o_mlp_plain` are the twins; they run
  for CPU tensors, and on the card the kernels are checked against them.
* `fused_qkv_kernel` / `fused_o_mlp_kernel` launch csrc/fused_decode_layer.cu
  and count every CUDA launch in `qkv_launches` (1 per call) and
  `o_mlp_launches` (`O_MLP_LAUNCHES` = 3 per call: o_proj + residual,
  gate/up + silu, down + residual).  Both are launches of one split-K
  streaming product: `qkv_plan` / `o_mlp_plan` pick the token tile and the
  K splits of each launch (a thread-block cluster per column or head tile,
  reduced in split order), so that a launch runs about one block per SM
  (#9) or two (#8).
* `fused_rmsnorm_qkv` / `fused_o_mlp` are the front ends: a CUDA tensor
  always goes to the kernel (or raises), a CPU tensor to the twin;
  `impl="plain"` asks for the twin on either device.

`fused_rmsnorm_qkv` may write k, v and their scales straight into the KV
cache: `out=(k8, v8, ks, vs)` takes views of the layer's cache at the write
position, (B, Sq, Hkv*D) int8 with unit-stride rows of Hkv*D and (B, Hkv,
Sq) bf16 with unit-stride positions.

Bounds on an H100 (bytes, the data-sheet 3.35 TB/s; both kernels sit below
the card's flop/byte ridge at decode widths): at the WM's H 1024, 16/16
heads of 64, I 4096, #8 moves ~3.3 MB at N = B*Sq = 10 (~1.0 us) and #9
~13.6 MB (~4.1 us); chip_smoke.py computes the exact figure of each call.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from vla_rft_tpu_torch.ops import cuda_build

HEAD_DIM = 64  # the kernels' head tile
TILE = 64  # columns of a product tile and depth of a contraction chunk
O_MLP_LAUNCHES = 3
H100_SMS = 132  # the grid is planned for the device's SM count; this when none is given
TOKEN_TILES = (8, 16, 32)  # tokens per block of #9 (8 * nt8)
QKV_TOKEN_TILES = (8, 16)  # tokens per block of #8
MAX_SPLITS = 8  # K splits per launch: one portable cluster

# kernel launches since the counts were last set to 0 (read by chip_smoke.py)
qkv_launches = 0
o_mlp_launches = 0

_lib = None
_sms: Dict[int, int] = {}  # device index -> SM count, once the shared-memory limits are set


def rope_tables(positions: torch.Tensor, theta: float, num_heads: int,
                head_dim: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-lane (N, num_heads * head_dim) f32 cos and signed sin tables of
    (B, Sq) positions, N = B*Sq: lane l of a head pairs with lane l ^ D/2,
    and sins carries the NeoX sign (-sin on the first half of each head), so
    rope(t) = t * cos + t[l ^ D/2] * sins.  The frequencies are those of
    models.transformer.rope."""
    d = head_dim
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d
    freqs = 1.0 / (theta ** exponent)
    ang = positions.reshape(-1, 1).float() * freqs  # (N, d/2)
    cos_h, sin_h = torch.cos(ang), torch.sin(ang)
    cos = torch.cat([cos_h, cos_h], dim=-1).repeat(1, num_heads)
    sins = torch.cat([-sin_h, sin_h], dim=-1).repeat(1, num_heads)
    return cos.contiguous(), sins.contiguous()


# ================================================================ plain twins
def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """models.transformer.RMSNorm: f32 statistics, output in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def qdot(x: torch.Tensor, w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """QuantDenseGeneral's product: bf16(x @ bf16(w)) accumulated in f32,
    then times the bf16 scale (a bf16 multiply)."""
    y = (x.float() @ w.float()).to(torch.bfloat16)
    return y * s.to(torch.bfloat16)


def _rope_dense(t: torch.Tensor, cos: torch.Tensor, sins: torch.Tensor, d: int) -> torch.Tensor:
    """NeoX rope on head-dense (N, nh*d) bf16 rows, in f32."""
    N, W = t.shape
    partner = t.reshape(N, W // d, 2, d // 2).flip(2).reshape(N, W)
    return t.float() * cos + partner.float() * sins


def _quant(tf: torch.Tensor, nh: int, d: int, B: int, Sq: int):
    """Per-(position, head) symmetric int8 quantisation of (N, nh*d) f32 rows
    -> ((B, Sq, nh*d) int8, (B, nh, Sq) bf16 scales), as Attention.quant."""
    t3 = tf.reshape(-1, nh, d)
    sc = torch.clamp(t3.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(t3 / sc[..., None]), -127, 127).to(torch.int8)
    return q.reshape(B, Sq, nh * d), sc.reshape(B, Sq, nh).transpose(1, 2).to(torch.bfloat16)


def fused_rmsnorm_qkv_plain(x, rope_cos, rope_sins, norm_w, wq, sq, wk, sk, wv, sv, *,
                            num_heads: int, num_kv_heads: int, head_dim: int, eps: float):
    """x (B, Sq, H) bf16 -> q (B, Sq, Hq*D) bf16 (rope'd), k8 / v8 (B, Sq,
    Hkv*D) int8, k / v scales (B, Hkv, Sq) bf16."""
    B, Sq, H = x.shape
    d, KD = head_dim, num_kv_heads * head_dim
    xn = _rmsnorm(x.reshape(B * Sq, H), norm_w, eps)
    q = qdot(xn, wq, sq)
    k = qdot(xn, wk, sk)
    v = qdot(xn, wv, sv)
    q_r = _rope_dense(q, rope_cos, rope_sins, d).to(torch.bfloat16)
    # the k tables are the first KD lanes: cos/sins repeat with period d
    k_r = _rope_dense(k, rope_cos[:, :KD], rope_sins[:, :KD], d)
    k8, ks = _quant(k_r.to(torch.bfloat16).float(), num_kv_heads, d, B, Sq)
    v8, vs = _quant(v.float(), num_kv_heads, d, B, Sq)
    return q_r.reshape(B, Sq, num_heads * d), k8, v8, ks, vs


def fused_o_mlp_plain(attn, x, wo, so, norm_w, wg, sg, wu, su, wd, sd, *, eps: float):
    """attn (B, Sq, Hq*D) and the residual x (B, Sq, H), bf16 -> (B, Sq, H)."""
    B, Sq, H = x.shape
    h = qdot(attn.reshape(B * Sq, -1).to(torch.bfloat16), wo, so)
    x1 = x.reshape(B * Sq, H) + h  # bf16 residual, like DecoderLayer
    xn = _rmsnorm(x1, norm_w, eps)
    g = qdot(xn, wg, sg)
    u = qdot(xn, wu, su)
    m = g * torch.sigmoid(g.float()).to(torch.bfloat16) * u  # two bf16 multiplies
    return (x1 + qdot(m, wd, sd)).reshape(B, Sq, H).to(x.dtype)


# ====================================================== #8's and #9's plans
def _token_tile(N: int, tiles=TOKEN_TILES) -> Tuple[int, int]:
    """(tokens per block, token groups): the smallest of `tiles` that holds
    N, the largest beyond."""
    tile = next((t for t in tiles if N <= t), tiles[-1])
    return tile, -(-N // tile)


def _launch(k: int, tiles: int, groups: int, blocks: int) -> dict:
    """One launch of the streaming product over K = k, `tiles` column (or
    head) tiles and `groups` token groups: the K splits are the largest
    divisor of its k / 64 chunks, at most MAX_SPLITS, that keeps tiles x
    groups x splits within `blocks`."""
    chunks = k // TILE
    want = max(1, blocks // (tiles * groups))
    splits = max(d for d in range(1, min(chunks, MAX_SPLITS) + 1)
                 if chunks % d == 0 and d <= want)
    return {"k": k, "cols": tiles * TILE, "splits": splits, "chunks": chunks // splits,
            "grid": (tiles, splits, groups)}


@functools.lru_cache(maxsize=256)
def qkv_plan(N: int, Hq: int, Hkv: int, H: int, sms: int = H100_SMS) -> dict:
    """The launch plan of kernel #8 at N = B*Sq tokens: the token tile (8
    or 16 tokens, the smallest that holds N, 16 beyond) and the K splits of
    the one launch over Hq + 2 Hkv head tiles of 64 columns (the q heads,
    then the k heads, then the v heads), for up to two blocks per SM; at
    the WM's N = 10, 48 heads x 4 splits.  (On an H100 at N = 10, 4 splits
    ran faster than 2 and 1; at N = 128, 16-token tiles faster than 32:
    PERF.md §6.)  Returns {"token_tile", "token_groups", "head_tiles",
    "k", "cols", "splits", "chunks", "grid"}; the splits of a head tile run
    as one cluster.  Cached: callers must not change the result."""
    tile, groups = _token_tile(N, QKV_TOKEN_TILES)
    tiles = Hq + 2 * Hkv
    return {"token_tile": tile, "token_groups": groups, "head_tiles": tiles,
            **_launch(H, tiles, groups, 2 * sms)}


@functools.lru_cache(maxsize=256)
def o_mlp_plan(N: int, HqD: int, H: int, I: int, sms: int = H100_SMS) -> dict:
    """The launch plan of kernel #9 at N = B*Sq tokens: one token tile for
    the three launches and, per launch, the number of K splits (`_launch`)
    for at most one block per SM (two per SM measured slower: the clusters
    ran in two waves).
    Returns {"token_tile", "token_groups", "launches": {name: {k, cols,
    splits, chunks, grid}}}; the splits of a column tile run as one
    cluster.  Cached (the decode loop asks once per layer): callers must not
    change the result."""
    tile, groups = _token_tile(N)
    launches = {name: _launch(k, cols // TILE, groups, sms)
                for name, k, cols in (("o_proj", HqD, H), ("gate_up", H, I), ("down", I, H))}
    return {"token_tile": tile, "token_groups": groups, "launches": launches}


# ==================================================================== kernels
def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of the library's entry points."""
    lib.fused_qkv_bf16.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 5
                                   + [ctypes.c_int64] * 3 + [ctypes.c_int] * 2
                                   + [ctypes.c_float, ctypes.c_void_p])
    lib.fused_o_mlp_bf16.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
                                     + [ctypes.c_float, ctypes.c_void_p])
    lib.fused_decode_layer_setup.argtypes = []
    for fn in (lib.fused_qkv_bf16, lib.fused_o_mlp_bf16, lib.fused_decode_layer_setup):
        fn.restype = ctypes.c_int
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = _bind(cuda_build.load("fused_decode_layer"))
    return _lib


def _device_lib(dev: torch.device):
    """The library, with the shared-memory limits of #8 and #9 set once on
    `dev`, and the device's SM count."""
    lib = _load()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        with torch.cuda.device(idx):
            rc = lib.fused_decode_layer_setup()
        if rc != 0:
            raise RuntimeError(f"fused decode kernels: setup failed with CUDA error {rc}")
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return lib, _sms[idx]


def _check(name, t, dtype, shape, dev):
    if not t.is_cuda or t.device != dev:
        raise ValueError(f"fused decode kernel: {name} must be on x's CUDA device")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"fused decode kernel: {name} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")


def _check_x(x):
    if not x.is_cuda or x.dtype != torch.bfloat16 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError("fused decode kernel: x must be a contiguous (B, Sq, H) bf16 CUDA tensor")
    if x.shape[2] % TILE:
        raise ValueError(f"fused decode kernel: width {x.shape[2]} is not a multiple of {TILE}")


def _check_aligned(named):
    """#8 and #9 copy 16-byte vectors: every (name, tensor) must start on a
    16-byte boundary (a layer's slice w[li] of a stacked tensor does)."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"fused decode kernel: {name} must start on a 16-byte boundary")


def _check_weight(name, w, s, k_in, dev):
    if w.dim() != 2 or w.shape[0] != k_in or w.shape[1] % TILE:
        raise ValueError(f"fused decode kernel: {name} must be ({k_in}, a multiple of {TILE}), "
                         f"got {tuple(w.shape)}")
    _check(name, w, torch.int8, w.shape, dev)
    _check(f"{name} scale", s, torch.bfloat16, (w.shape[1],), dev)


def _check_out(name, t, dtype, shape, dev, inner):
    """An output view: its shape, and unit strides on its last `inner` axes
    laid out as a contiguous tensor of that shape would be."""
    if not t.is_cuda or t.device != dev or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused decode kernel: {name} must be {dtype} of shape {tuple(shape)} "
                         f"on x's device, got {t.dtype} {tuple(t.shape)}")
    want = torch.empty(shape, device="meta").stride()
    if t.stride()[-inner:] != want[-inner:]:
        raise ValueError(f"fused decode kernel: {name} strides {t.stride()} need unit-stride "
                         f"trailing axes {want[-inner:]}")


def fused_qkv_kernel(x, rope_cos, rope_sins, norm_w, wq, sq, wk, sk, wv, sv, *, num_heads: int,
                     num_kv_heads: int, head_dim: int, eps: float,
                     out: Optional[Tuple[torch.Tensor, ...]] = None):
    """Launch kernel #8; same arguments and results as
    `fused_rmsnorm_qkv_plain`, all on one CUDA device, D = 64, widths
    multiples of 64, x, the weights and the norm weight on 16-byte
    boundaries.  With `out`, k/v and their scales are written into those
    views (see the module docstring) and returned."""
    global qkv_launches
    _check_x(x)
    B, Sq, H = x.shape
    N, dev = B * Sq, x.device
    if head_dim != HEAD_DIM:
        raise ValueError(f"fused decode kernel: head dim {head_dim} != {HEAD_DIM}")
    if num_kv_heads < 1 or num_heads % num_kv_heads:
        raise ValueError(f"fused decode kernel: {num_heads} q heads for {num_kv_heads} kv heads")
    HqD, KD = num_heads * head_dim, num_kv_heads * head_dim
    _check("norm weight", norm_w, torch.bfloat16, (H,), dev)
    _check("rope cos", rope_cos, torch.float32, (N, HqD), dev)
    _check("rope sins", rope_sins, torch.float32, (N, HqD), dev)
    for name, w, s, width in (("wq", wq, sq, HqD), ("wk", wk, sk, KD), ("wv", wv, sv, KD)):
        _check_weight(name, w, s, H, dev)
        if w.shape[1] != width:
            raise ValueError(f"fused decode kernel: {name} has {w.shape[1]} columns, not {width}")
    _check_aligned((("x", x), ("wq", wq), ("wk", wk), ("wv", wv), ("norm weight", norm_w)))
    lib, sms = _device_lib(dev)
    plan = qkv_plan(N, num_heads, num_kv_heads, H, sms)
    q = torch.empty((B, Sq, HqD), dtype=torch.bfloat16, device=dev)
    if out is None:
        k8, v8 = (torch.empty((B, Sq, KD), dtype=torch.int8, device=dev) for _ in range(2))
        ks, vs = (torch.empty((B, num_kv_heads, Sq), dtype=torch.bfloat16, device=dev)
                  for _ in range(2))
    else:
        k8, v8, ks, vs = out
        for name, t in (("k out", k8), ("v out", v8)):
            _check_out(name, t, torch.int8, (B, Sq, KD), dev, 2)
        for name, t in (("k scale out", ks), ("v scale out", vs)):
            _check_out(name, t, torch.bfloat16, (B, num_kv_heads, Sq), dev, 1)
        if v8.stride() != k8.stride() or vs.stride() != ks.stride():
            raise ValueError("fused decode kernel: k and v outputs must share their strides")
    rc = lib.fused_qkv_bf16(
        x.data_ptr(), rope_cos.data_ptr(), rope_sins.data_ptr(), norm_w.data_ptr(),
        wq.data_ptr(), sq.data_ptr(), wk.data_ptr(), sk.data_ptr(), wv.data_ptr(), sv.data_ptr(),
        q.data_ptr(), k8.data_ptr(), v8.data_ptr(), ks.data_ptr(), vs.data_ptr(),
        N, Sq, H, num_heads, num_kv_heads, k8.stride(0), ks.stride(0), ks.stride(1),
        plan["token_tile"] // 8, plan["splits"], float(eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused qkv kernel: launch failed with CUDA error {rc}")
    qkv_launches += 1
    return q, k8, v8, ks, vs


def fused_o_mlp_kernel(attn, x, wo, so, norm_w, wg, sg, wu, su, wd, sd, *, eps: float):
    """Launch kernel #9 (three launches); same arguments and result as
    `fused_o_mlp_plain`, all on one CUDA device, widths multiples of 64,
    tensors on 16-byte boundaries."""
    global o_mlp_launches
    _check_x(x)
    B, Sq, H = x.shape
    N, dev = B * Sq, x.device
    if (attn.dim() != 3 or attn.shape[:2] != x.shape[:2] or attn.shape[2] % TILE
            or attn.dtype != torch.bfloat16 or not attn.is_contiguous() or attn.device != dev):
        raise ValueError("fused decode kernel: attn must be a contiguous (B, Sq, Hq*D) bf16 "
                         "tensor on x's device, Hq*D a multiple of 64")
    HqD, I = attn.shape[2], wg.shape[-1]
    _check_weight("wo", wo, so, HqD, dev)
    _check_weight("wg", wg, sg, H, dev)
    _check_weight("wu", wu, su, H, dev)
    _check_weight("wd", wd, sd, I, dev)
    _check("norm weight", norm_w, torch.bfloat16, (H,), dev)
    if wo.shape[1] != H or wu.shape[1] != I or wd.shape[1] != H:
        raise ValueError("fused decode kernel: o/gate/up/down widths do not chain")
    _check_aligned((("attn", attn), ("x", x), ("wo", wo), ("wg", wg), ("wu", wu), ("wd", wd),
                    ("norm weight", norm_w)))
    lib, sms = _device_lib(dev)
    plan = o_mlp_plan(N, HqD, H, I, sms)
    x1 = torch.empty((N, H), dtype=torch.bfloat16, device=dev)
    m = torch.empty((N, I), dtype=torch.bfloat16, device=dev)
    o = torch.empty_like(x)
    splits = [plan["launches"][k]["splits"] for k in ("o_proj", "gate_up", "down")]
    rc = lib.fused_o_mlp_bf16(
        attn.data_ptr(), x.data_ptr(), wo.data_ptr(), so.data_ptr(), norm_w.data_ptr(),
        wg.data_ptr(), sg.data_ptr(), wu.data_ptr(), su.data_ptr(), wd.data_ptr(), sd.data_ptr(),
        x1.data_ptr(), m.data_ptr(), o.data_ptr(), N, HqD, H, I, plan["token_tile"] // 8,
        *splits, float(eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fused o/mlp kernel: launch failed with CUDA error {rc}")
    o_mlp_launches += O_MLP_LAUNCHES
    return o


# ================================================================= front ends
def _use_plain(x, impl: str) -> bool:
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown fused decode impl {impl!r}")
    return impl == "plain" or x.device.type == "cpu"


def fused_rmsnorm_qkv(x, rope_cos, rope_sins, norm_w, wq, sq, wk, sk, wv, sv, *,
                      num_heads: int, num_kv_heads: int, head_dim: int, eps: float,
                      out: Optional[Tuple[torch.Tensor, ...]] = None, impl: str = "auto"):
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim, eps=eps)
    args = (x, rope_cos, rope_sins, norm_w, wq, sq, wk, sk, wv, sv)
    if not _use_plain(x, impl):
        return fused_qkv_kernel(*args, out=out, **kw)
    q, *kv = fused_rmsnorm_qkv_plain(*args, **kw)
    if out is not None:
        for dst, src in zip(out, kv):
            dst.copy_(src)
        kv = out
    return (q, *kv)


def fused_o_mlp(attn, x, wo, so, norm_w, wg, sg, wu, su, wd, sd, *, eps: float,
                impl: str = "auto"):
    fn = fused_o_mlp_plain if _use_plain(x, impl) else fused_o_mlp_kernel
    return fn(attn, x, wo, so, norm_w, wg, sg, wu, su, wd, sd, eps=eps)
