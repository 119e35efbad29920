"""Where the time of kernels #8 (RMSNorm + q/k/v + rope + quantisation),
#9 (o_proj + MLP), the split-cache decode kernel (#4-#7) and the
cache-writing decode kernel (#10) goes on the card, per block.

    python3 kernel_trace.py [--decode-only | --fda-only | --fda-variants]

Builds a copy of vla_rft_tpu_torch/csrc/fused_decode_layer.cu with a stamp
at each phase boundary of `streaming_product` (thread 0 of every block
writes %globaltimer at its start and end and clock64 in between), runs #8
and #9 on one WM layer of seeded int8 weights (H 1024, 16/16 heads of 64,
I 4096) at N = 10 and N = 128 tokens with the wrappers' launch plans, and
prints one JSON line per N: for #8's launch (qkv) and each of #9's three
the blocks, the spread of their start times and the launch's span (us,
%globaltimer), the median block time (us), and the median SM cycles of
each phase:

  start-chunk0   first chunk of the ring landed (GATE_UP, QKV: and the RMS pre-pass)
  products       the rest of the K slice streamed and multiplied
  warp_sums      accumulators stored fragment-major and summed in warp order
  barrier        waiting at the cluster barrier for the other K splits
  epilogue       the ordered sum over splits, scale, then the residual / SiLU
                 (#9) or rope and quantisation (#8), stores

Then the same for a stamped copy of csrc/decode_attend.cuh (built with
csrc/decode_hd.cu), run as #4 at the WM's mid-rollout call (B 10, 2
prefixes of 1088 + 291 own, int8, 16/16 heads) and at 128 rows (16
prefixes of 8 rows), and as #5 at B 10 x 1379 keys, each with the
wrapper's plan: per call the blocks that hold a chunk, their start spread,
the span and median block time (us, %globaltimer), and the median SM
cycles of each phase:

  chunk      finding the block's chunk from prefix_map
  setup      the rows' windows, the tile list and q into shared memory
  first      the prologue's tiles in flight until the first one landed
  tiles      the rest of the rank's tiles streamed and multiplied
  merge      the warps' states stored and merged in warp order
  cluster    waiting at the cluster barrier for the other key splits
  epilogue   the ordered merge over the ranks, O stored, the last barrier

Then the same for a stamped copy of csrc/fused_decode_attention.cu (#10),
run with the wrapper's split plan at the WM width (B 10, 16/16 heads of 64,
S 1664, row 1379, bf16 cache) and at the configured 128 rows: per call the
blocks, their start spread, the span and median block time (us,
%globaltimer), and the median SM cycles of each phase:

  setup      kv_starts, q and the first tiles' copies issued, q landed, the
             current token's scores (last rank), q's fragments
  first      the first tile in flight until it landed (blocks with a tile)
  tiles      the rest of the rank's tiles streamed and multiplied
  merge      the warps' states stored and merged in warp order, the current
             token folded in (last rank)
  cluster    waiting at the cluster barrier for the other ranks (0 with
             one rank: its merge stores O)
  epilogue   the ordered merge over the ranks, O stored, the row written
             (rank 0), the last barrier

and the block times on SMs that hold one of the launch's blocks against
those on SMs that hold two or more (each block records %smid).
`--fda-variants` instead times #10 from CUDA-graph replay at those two
shapes and at GQA 14/2 (B 10, 14/2 heads), scaled_dot_product_attention
beside it: 1-8 ranks per cluster, then copies of the source edited as
FDA_VARIANTS lists (2- or 4-stage ring, 8 warps, kv_starts not read, no
products or no copies: the last two timing only) in turns with the built
kernel.

then the card's name and power limit.  `--decode-only` / `--fda-only` trace
only those.  The stamped copies are built into vla_rft_tpu_torch/_build/
(ignored by git).  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

MAX_BLOCKS = 4096  # per launch
STAMPS = 8
KINDS = {"o_proj": 0, "gate_up": 1, "down": 2, "qkv": 3}  # the product's KIND
PHASES = {"start-chunk0": (7, 1), "products": (1, 2), "warp_sums": (2, 3), "barrier": (3, 4),
          "epilogue": (4, 5)}

_DEFS = f"""
constexpr int KINDS = {len(KINDS)};
__device__ unsigned long long omlp_stamps[KINDS * {MAX_BLOCKS} * {STAMPS}];
#define STAMP(k) do {{ if (threadIdx.x == 0) {{ \\
  const int lb = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); \\
  unsigned long long tv; \\
  if ((k) == 0 || (k) == 6) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tv)); \\
  else tv = clock64(); \\
  omlp_stamps[((KIND) * {MAX_BLOCKS} + lb) * {STAMPS} + (k)] = tv; }} }} while (0)
"""
# (anchor in the source, what replaces it); each anchor must occur once
_EDITS = [
    ("namespace omlp {\n", "namespace omlp {\n" + _DEFS),
    ("  const int kc0 = split * p.chunks * BK;\n",
     "  const int kc0 = split * p.chunks * BK;\n  STAMP(0); STAMP(7);\n"),
    ("    cp_async_wait<STAGES - 1>();  // chunk c has landed (one commit group per chunk)\n"
     "    __syncthreads();\n",
     "    cp_async_wait<STAGES - 1>();  // chunk c has landed (one commit group per chunk)\n"
     "    __syncthreads();\n    if (c == 0) STAMP(1);\n"),
    ("  // Each warp's accumulators into its own fragment-major slots",
     "  STAMP(2);\n  // Each warp's accumulators into its own fragment-major slots"),
    ("  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();",
     "  STAMP(3);\n  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();"),
    ("    __syncthreads();\n  }\n  if constexpr (KIND == QKV) {",
     "    __syncthreads();\n  }\n  STAMP(4);\n  if constexpr (KIND == QKV) {"),
    ("  if (p.splits > 1) cluster.sync();  // no block leaves while another reads its sums\n}",
     "  STAMP(5);\n  if (p.splits > 1) cluster.sync();  // no block leaves while another reads its sums\n"
     "  STAMP(6);\n}"),
    ('extern "C" int fused_decode_layer_setup() {',
     'extern "C" int omlp_stamps_copy(void* host, size_t bytes) {\n'
     '  return static_cast<int>(cudaMemcpyFromSymbol(host, omlp::omlp_stamps, bytes));\n}\n'
     'extern "C" int fused_decode_layer_setup() {'),
]


def build_stamped(cuda_build, fdl) -> ctypes.CDLL:
    """Build the stamped copy and make the wrappers of `fdl` launch it."""
    src = (cuda_build.CSRC / "fused_decode_layer.cu").read_text()
    for anchor, repl in _EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"kernel_trace: anchor not found once in the source: {anchor!r}")
        src = src.replace(anchor, repl)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / "fused_decode_layer_stamped.cu"
    so = cuda_build.BUILD_DIR / "libfused_decode_layer_stamped.so"
    cu.write_text(src)
    # the source includes nothing beside it, so it builds from the build directory
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"kernel_trace: nvcc failed\n{r.stdout}\n{r.stderr}")
    lib = fdl._bind(ctypes.CDLL(str(so)))
    lib.omlp_stamps_copy.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.omlp_stamps_copy.restype = ctypes.c_int
    fdl._lib, fdl._sms = lib, {}  # the wrappers set it up on first use and launch it
    return lib


def trace(lib, fdl, N: int, gen) -> dict:
    dev = torch.device("cuda")
    H, I, Hq, Hkv, D = 1024, 4096, 16, 16, 64
    HqD = Hq * D

    def w(k_in, k_out):
        return (torch.randint(-127, 128, (k_in, k_out), generator=gen, device=dev,
                              dtype=torch.int8),
                ((torch.rand(k_out, generator=gen, device=dev) + 0.5) * 0.02 / k_in ** 0.5)
                .bfloat16())

    wq, wk, wv = w(H, HqD), w(H, Hkv * D), w(H, Hkv * D)
    wo, wg, wu, wd = w(HqD, H), w(H, I), w(H, I), w(I, H)
    n1, n2 = ((1 + 0.1 * torch.randn(H, generator=gen, device=dev)).bfloat16() for _ in range(2))
    x = torch.randn(N, 1, H, generator=gen, device=dev).bfloat16()
    attn = torch.randn(N, 1, HqD, generator=gen, device=dev).bfloat16()
    cos, sins = fdl.rope_tables(torch.randint(0, 1600, (N, 1), generator=gen, device=dev),
                                10000.0, Hq, D)
    qkv = (x, cos, sins, n1, *wq, *wk, *wv)
    kw = dict(num_heads=Hq, num_kv_heads=Hkv, head_dim=D, eps=1e-6)
    omlp = (attn, x, *wo, n2, *wg, *wu, *wd)
    for _ in range(4):  # warm: the last call's stamps are read
        q = fdl.fused_qkv_kernel(*qkv, **kw)[0]
        out = fdl.fused_o_mlp_kernel(*omlp, eps=1e-6)
    torch.cuda.synchronize()
    rel = lambda a, r: ((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan, qplan = fdl.o_mlp_plan(N, HqD, H, I, sms), fdl.qkv_plan(N, Hq, Hkv, H, sms)
    res = {"N": N, "token_tiles": {"qkv": qplan["token_tile"], "o_mlp": plan["token_tile"]},
           "plan_splits": {"qkv": qplan["splits"],
                           **{k: v["splits"] for k, v in plan["launches"].items()}},
           "max_rel_err_vs_twin": {
               "q": rel(q, fdl.fused_rmsnorm_qkv_plain(*qkv, **kw)[0]),
               "o_mlp": rel(out, fdl.fused_o_mlp_plain(*omlp, eps=1e-6))}}
    buf = np.zeros(len(KINDS) * MAX_BLOCKS * STAMPS, dtype=np.uint64)
    if lib.omlp_stamps_copy(buf.ctypes.data, buf.nbytes) != 0:
        raise RuntimeError("kernel_trace: reading the stamps failed")
    t = buf.reshape(len(KINDS), MAX_BLOCKS, STAMPS).astype(np.int64)
    grids = {"qkv": qplan["grid"], **{k: v["grid"] for k, v in plan["launches"].items()}}
    for name, kind in KINDS.items():
        tiles, sp, groups = grids[name]
        tk = t[kind, :tiles * sp * groups]
        start, end = tk[:, 0], tk[:, 6]
        res[name] = {"blocks": int(tk.shape[0]),
                     "start_spread_us": float(start.max() - start.min()) / 1e3,
                     "span_us": float(end.max() - start.min()) / 1e3,
                     "block_us_median": float(np.median(end - start)) / 1e3,
                     "cycles_median": {ph: float(np.median(tk[:, b] - tk[:, a]))
                                       for ph, (a, b) in PHASES.items()}}
    return res


# ------------------------------------------------------------ the decode kernel
DEC_STAMPS = 10  # 0 and 7 %globaltimer at the start and end, 8 and 9 clock64 there
DEC_PHASES = {"chunk": (8, 1), "setup": (1, 2), "first": (2, 3), "tiles": (3, 4),
              "merge": (4, 5), "cluster": (5, 6), "epilogue": (6, 9)}
_DEC_DEFS = f"""
__device__ unsigned long long dec_stamps[{MAX_BLOCKS} * {DEC_STAMPS}];
#define STAMP(k) do {{ if (threadIdx.x == 0) {{ \\
  const int lb = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); \\
  unsigned long long tv; \\
  if ((k) == 0 || (k) == 7) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tv)); \\
  else tv = clock64(); \\
  if (lb < {MAX_BLOCKS}) dec_stamps[lb * {DEC_STAMPS} + (k)] = tv; }} }} while (0)
"""
_DEC_EDITS = [
    ("namespace decode_attend {\n", "namespace decode_attend {\n" + _DEC_DEFS),
    ("  const int base = SHARED ? a.shared_len : 0;  // absolute position of own slot 0\n",
     "  const int base = SHARED ? a.shared_len : 0;  // absolute position of own slot 0\n"
     "  STAMP(0); STAMP(8);\n"),
    ("  if (n_rows == 0) return;  // the same for every rank of the cluster\n",
     "  if (n_rows == 0) return;  // the same for every rank of the cluster\n  STAMP(1);\n"),
    ("  const float scale_log2 = a.scale * LOG2E;\n",
     "  const float scale_log2 = a.scale * LOG2E;\n  STAMP(2);\n"),
    ("    __syncthreads();              // ... for every thread; every warp is done with tile t"
     " - 1\n",
     "    __syncthreads();              // ... for every thread; every warp is done with tile t"
     " - 1\n    if (it == 0) STAMP(3);\n"),
    ("  cp_async_wait<0>();\n\n  // ---- merge",
     "  cp_async_wait<0>();\n  STAMP(4);\n\n  // ---- merge"),
    ("  cluster.sync();  // every rank's state is complete\n",
     "  STAMP(5);\n  cluster.sync();  // every rank's state is complete\n  STAMP(6);\n"),
    ("  cluster.sync();  // no block leaves while another reads its state\n}",
     "  cluster.sync();  // no block leaves while another reads its state\n"
     "  STAMP(9); STAMP(7);\n}"),
]


def build_decode_stamped(cuda_build, dec) -> ctypes.CDLL:
    """Build the stamped copy of the decode kernel (with decode_hd.cu) and
    make the 'hd' wrappers of `dec` launch it."""
    src = (cuda_build.CSRC / "decode_attend.cuh").read_text()
    for anchor, repl in _DEC_EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"kernel_trace: anchor not found once in the source: {anchor!r}")
        src = src.replace(anchor, repl)
    out = cuda_build.BUILD_DIR / "decode_stamped"
    out.mkdir(parents=True, exist_ok=True)
    (out / "decode_attend.cuh").write_text(src)
    (out / "mma_sm90.cuh").write_text((cuda_build.CSRC / "mma_sm90.cuh").read_text())
    (out / "decode_hd.cu").write_text(
        (cuda_build.CSRC / "decode_hd.cu").read_text()
        + '\nextern "C" int dec_stamps_copy(void* host, size_t bytes) {\n'
          '  return static_cast<int>(\n'
          '      cudaMemcpyFromSymbol(host, decode_attend::dec_stamps, bytes));\n}\n'
          'extern "C" int dec_stamps_clear(size_t bytes) {\n'
          '  void* p;\n  cudaGetSymbolAddress(&p, decode_attend::dec_stamps);\n'
          '  return static_cast<int>(cudaMemset(p, 0, bytes));\n}\n')
    so = out / "libdecode_hd_stamped.so"
    r = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
                        str(out / "decode_hd.cu")], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"kernel_trace: nvcc failed\n{r.stdout}\n{r.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.decode_hd
    fn.argtypes = dec._load("hd").argtypes
    fn.restype = ctypes.c_int
    lib.dec_stamps_copy.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.dec_stamps_copy.restype = ctypes.c_int
    lib.dec_stamps_clear.argtypes = [ctypes.c_size_t]
    lib.dec_stamps_clear.restype = ctypes.c_int
    dec._libs["decode_hd"] = fn  # the 'hd' wrappers launch the stamped copy
    return lib


def trace_decode(lib, dec, gen) -> list:
    """One record per traced call: #4 at B 10 and 128, #5 at B 10."""
    dev = torch.device("cuda")
    Hkv, prefix, own_mid = 16, 1088, 7 + 4 * 71
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def cache(rows, S):
        c = [torch.randint(-127, 128, (rows, S, Hkv * 64), generator=gen, device=dev,
                           dtype=torch.int8) for _ in range(2)]
        s = tuple((torch.rand(rows, Hkv, S, generator=gen, device=dev) * 0.04 + 0.01)
                  .bfloat16() for _ in range(2))
        return c, s

    out = []
    for name, B, n_prefix, Sr, shared in (("decode_shared_hd", 10, 2, 384, True),
                                          ("decode_shared_hd@b128", 128, 16, 384, True),
                                          ("decode_hd", 10, 0, 1408, False)):
        q = torch.randn(B, 1, Hkv, 64, generator=gen, device=dev).bfloat16()
        (ck, cv), sc = cache(B, Sr)
        if shared:
            (sck, scv), ssc = cache(n_prefix, 1152)
            pm = (torch.arange(B, device=dev) // 5 if B == 10
                  else torch.arange(B, device=dev) // 4 % 16).int()
            kv = torch.full((B,), prefix + own_mid, dtype=torch.int32, device=dev)
            call = lambda: dec.decode_shared_kernel(
                q, ck, cv, sck, scv, pm, shared_len=prefix, kv_lens=kv, q_offset=kv - 1,
                scales=sc, shared_scales=ssc)
        else:
            kv = torch.full((B,), 1095 + own_mid - 7, dtype=torch.int32, device=dev)
            call = lambda: dec.decode_kernel(q, ck, cv, kv_lens=kv, q_offset=kv - 1, scales=sc)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        nbytes = MAX_BLOCKS * DEC_STAMPS * 8
        if lib.dec_stamps_clear(nbytes) != 0:
            raise RuntimeError("kernel_trace: clearing the stamps failed")
        call()
        torch.cuda.synchronize()
        buf = np.zeros(MAX_BLOCKS * DEC_STAMPS, dtype=np.uint64)
        if lib.dec_stamps_copy(buf.ctypes.data, buf.nbytes) != 0:
            raise RuntimeError("kernel_trace: reading the stamps failed")
        t = buf.reshape(MAX_BLOCKS, DEC_STAMPS).astype(np.int64)
        t = t[t[:, 7] != 0]  # the blocks that held a chunk
        start, end = t[:, 0], t[:, 7]
        plan = dec.decode_plan(B, 1, 1, Hkv, Sr, shared, n_prefix, prefix if shared else 0, sms)
        out.append({"kernel": name, "B": B, "plan": plan, "blocks": int(t.shape[0]),
                    "start_spread_us": float(start.max() - start.min()) / 1e3,
                    "span_us": float(end.max() - start.min()) / 1e3,
                    "block_us_median": float(np.median(end - start)) / 1e3,
                    "cycles_median": {ph: float(np.median(t[:, b] - t[:, a]))
                                      for ph, (a, b) in DEC_PHASES.items()}})
    return out


# ------------------------------------------------ the cache-writing decode (#10)
FDA_STAMPS = 10  # 0 and 7 %globaltimer at the start and end, 8 clock64 at the start
FDA_PHASES = {"setup": (8, 1), "first": (1, 2), "tiles": (2, 3), "merge": (3, 4),
              "cluster": (4, 5), "epilogue": (5, 6)}
_FDA_DEFS = _DEC_DEFS.replace("dec_stamps", "fda_stamps").replace(
    f"{DEC_STAMPS}]", f"{FDA_STAMPS}]").replace(f"* {DEC_STAMPS} +", f"* {FDA_STAMPS} +")
_FDA_EDITS = [
    ("namespace {\n\nconstexpr int NWARPS", "namespace {\n" + _FDA_DEFS + "\nconstexpr int NWARPS"),
    ("  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n  Q* q_s",
     "  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;\n  STAMP(0); STAMP(8);\n"
     "  Q* q_s"),
    ("  // setup done\n", "  STAMP(1);\n"),
    ("    __syncthreads();              // ... for every thread; every warp is done with tile t"
     " - 1\n",
     "    __syncthreads();              // ... for every thread; every warp is done with tile t"
     " - 1\n    if (it == 0) STAMP(2);\n"),
    ("  // tiles done\n", "  STAMP(3);\n"),
    ("  // warp merge done\n", "  STAMP(4);\n"),
    ("  // cluster wait done\n", "  STAMP(5);\n"),
    ("  if (splits > 1) cluster_wait();  // no block leaves while another reads its state\n}",
     "  if (splits > 1) cluster_wait();  // no block leaves while another reads its state\n"
     "  STAMP(6); STAMP(7);\n}"),
]


# (anchor, text) edits of #10's source for the timed variants (--fda-variants);
# the `timing only` ones give wrong results by design
FDA_VARIANTS = {
    "stages2": [("  static constexpr int STAGES = 3;",
                 "  static constexpr int STAGES = (sizeof(T) == 2 && D == 64) ? 2 : 3;")],
    "stages4": [("  static constexpr int STAGES = 3;",
                 "  static constexpr int STAGES = (sizeof(T) == 2 && D == 64) ? 4 : 3;")],
    "warps8": [("constexpr int NWARPS = 4;", "constexpr int NWARPS = 8;")],
    "kv_starts_not_read": [("  const int lo = min(max(a.kv_starts[b], 0), a.idx);",
                            "  const int lo = 0;  // right only when kv_starts is 0")],
    "no_products (timing only)": [
        ("      w.tile(st, kw0, jw, a.idx, G > 8, scale_log2, lane);\n", "")],
    "no_copies (timing only)": [
        ("      cp_async16(st + dst, ck + off, ok);\n"
         "      cp_async16(st + TL::KV + dst, cv + off, ok);\n", "      (void)dst; (void)off;\n")],
}
# the stamped build also records each block's SM in its last stamp
_FDA_SMID = ("  T* vn_s = kn_s + D;\n",
             "  T* vn_s = kn_s + D;\n  if (threadIdx.x == 0) {\n    unsigned sm;\n"
             "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
             f"    const int lb = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
             f"    if (lb < {MAX_BLOCKS}) fda_stamps[lb * {FDA_STAMPS} + 9] = sm;\n  }}\n")


def build_fda(cuda_build, fda, builds: dict) -> dict:
    """Build copies of #10's source, one nvcc each, all started together:
    builds = {name: (edits, stamped)}, the edits applied first, then with
    `stamped` the phase stamps and the SM record.  Returns {name: CDLL}
    with `fused_decode_attention` bound as the wrapper binds it."""
    src0 = (cuda_build.CSRC / "fused_decode_attention.cu").read_text()
    procs = {}
    for name, (edits, stamped) in builds.items():
        src = src0
        for anchor, repl in [*edits, *(_FDA_EDITS + [_FDA_SMID] if stamped else [])]:
            if src.count(anchor) != 1:
                raise RuntimeError(f"kernel_trace: anchor not found once in the source: {anchor!r}")
            src = src.replace(anchor, repl)
        if stamped:
            src += ('\nextern "C" int fda_stamps_copy(void* host, size_t bytes) {\n'
                    '  return static_cast<int>(cudaMemcpyFromSymbol(host, fda_stamps, bytes));\n}\n'
                    'extern "C" int fda_stamps_clear(size_t bytes) {\n'
                    '  void* p;\n  cudaGetSymbolAddress(&p, fda_stamps);\n'
                    '  return static_cast<int>(cudaMemset(p, 0, bytes));\n}\n')
        out = cuda_build.BUILD_DIR / f"fda_{hashlib.sha256(src.encode()).hexdigest()[:12]}"
        out.mkdir(parents=True, exist_ok=True)
        (out / "mma_sm90.cuh").write_text((cuda_build.CSRC / "mma_sm90.cuh").read_text())
        (out / "fused_decode_attention.cu").write_text(src)
        so = out / "libfused_decode_attention_variant.so"
        procs[name] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so),
             str(out / "fused_decode_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"kernel_trace: nvcc failed for {name}\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.fused_decode_attention.argtypes = fda._load().argtypes
        lib.fused_decode_attention.restype = ctypes.c_int
        if builds[name][1]:
            for fn, args in (("fda_stamps_copy", [ctypes.c_void_p, ctypes.c_size_t]),
                             ("fda_stamps_clear", [ctypes.c_size_t])):
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def build_fda_stamped(cuda_build, fda, edits=()) -> ctypes.CDLL:
    """Build the stamped copy of #10 (with `edits`, more (anchor, text)
    pairs, applied first) and make `fda`'s wrapper launch it."""
    lib = build_fda(cuda_build, fda, {"stamped": (list(edits), True)})["stamped"]
    fda._fn = lib.fused_decode_attention  # the wrapper launches the stamped copy
    return lib


def _fda_inputs(gen, B, Hq, Hkv, S=1664, D=64):
    dev = torch.device("cuda")
    ck, cv = (torch.randn(2, B, Hkv, S, D, generator=gen, device=dev).bfloat16()
              for _ in range(2))
    q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).bfloat16()
    kn, vn = (torch.randn(B, 1, Hkv, D, generator=gen, device=dev).bfloat16() for _ in range(2))
    return q, kn, vn, ck, cv, torch.zeros(B, dtype=torch.int32, device=dev)


def trace_fda(lib, fda, gen, shapes=((10, 16, 16), (128, 16, 16)), splits=None) -> list:
    """One record per (B, Hq, Hkv) in `shapes`: #10 at S 1664, row 1379,
    bf16, D 64, kv_starts 0, with the wrapper's plan (or `splits`): the
    phases, and the block times on SMs that hold one block against those
    on SMs that hold more."""
    S, idx, D, li = 1664, 1379, 64, 1
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for B, Hq, Hkv in shapes:
        q, kn, vn, ck, cv, ks = _fda_inputs(gen, B, Hq, Hkv, S, D)
        R = splits or fda.split_plan(B, Hq, Hkv, D, idx, torch.bfloat16, sms)["splits"]
        call = lambda: fda.fused_decode_attention_kernel(q, kn, vn, ck, cv, li, idx, ks,
                                                         splits=R)
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        nbytes = MAX_BLOCKS * FDA_STAMPS * 8
        if lib.fda_stamps_clear(nbytes) != 0:
            raise RuntimeError("kernel_trace: clearing the stamps failed")
        call()
        torch.cuda.synchronize()
        buf = np.zeros(MAX_BLOCKS * FDA_STAMPS, dtype=np.uint64)
        if lib.fda_stamps_copy(buf.ctypes.data, buf.nbytes) != 0:
            raise RuntimeError("kernel_trace: reading the stamps failed")
        t = buf.reshape(MAX_BLOCKS, FDA_STAMPS).astype(np.int64)
        t = t[t[:, 7] != 0]
        t[:, 5] = np.where(t[:, 5] != 0, t[:, 5], t[:, 4])  # one rank: no cluster barrier
        start, end = t[:, 0], t[:, 7]
        tiled = t[t[:, 2] != 0]  # the blocks that had a tile
        cyc = {}
        for ph, (a, b) in FDA_PHASES.items():
            rows = tiled if ph in ("first", "tiles") else t
            if ph == "merge":  # from the end of the tiles (of the setup without a tile)
                d = rows[:, 4] - np.where(rows[:, 3] != 0, rows[:, 3], rows[:, 1])
            else:
                d = rows[:, b] - rows[:, a]
            cyc[ph] = float(np.median(d)) if len(d) else None
        per_sm = np.bincount(t[:, 9])[t[:, 9]]  # blocks of the launch on each block's SM
        sharing = {}
        for label, sel in (("alone", per_sm == 1), ("shared", per_sm > 1)):
            if sel.any():
                sharing[label] = {"blocks": int(sel.sum()),
                                  "block_us_median": float(np.median(end[sel] - start[sel])) / 1e3,
                                  "last_end_us": float(end[sel].max() - start.min()) / 1e3}
        out.append({"kernel": "fused_decode_attention", "B": B, "Hq": Hq, "Hkv": Hkv,
                    "splits": R, "blocks": int(t.shape[0]),
                    "blocks_with_a_tile": int(tiled.shape[0]),
                    "start_spread_us": float(start.max() - start.min()) / 1e3,
                    "span_us": float(end.max() - start.min()) / 1e3,
                    "block_us_median": float(np.median(end - start)) / 1e3,
                    "cycles_median": cyc, "by_blocks_on_the_sm": sharing})
    return out


def fda_variants(cuda_build, fda, gen) -> list:
    """#10 timed from CUDA-graph replay (chip_smoke.graph_ms) at (a) B 10,
    16/16 heads, (b) B 128, 16/16, (c) B 10, 14/2 (bf16, D 64, S 1664, row
    1379, kv_starts 0), SDPA beside: the ranks per cluster 1-8 on the
    built kernel, then the FDA_VARIANTS copies against it in turns (the
    built kernel, each variant, the variants again in reverse, the built
    kernel), each with the wrapper's plan and its max |dO| against the
    twin."""
    import torch.nn.functional as F

    import chip_smoke as cs

    idx, li = 1379, 1
    data = {k: _fda_inputs(gen, *shape) for k, shape in
            (("a", (10, 16, 16)), ("b", (128, 16, 16)), ("c", (10, 14, 2)))}
    out = []
    for k, (q, kn, vn, ck, cv, ks) in data.items():
        rec = {"experiment": "splits", "shape": k, "B": q.shape[0], "Hq": q.shape[2],
               "Hkv": ck.shape[2]}
        for R in (1, 2, 4, 7, 8):
            rec[f"R{R}"] = cs.graph_ms(lambda: fda.fused_decode_attention_kernel(
                q, kn, vn, ck, cv, li, idx, ks, splits=R))
        qt, kt, vt = q.transpose(1, 2), ck[li, :, :, :idx + 1], cv[li, :, :, :idx + 1]
        rec["sdpa"] = cs.graph_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=qt.shape[1] != kt.shape[1]))
        out.append(rec)
    built = fda._load()
    libs = build_fda(cuda_build, fda, {n: (e, False) for n, e in FDA_VARIANTS.items()})
    fns = {"built": built, **{n: lib.fused_decode_attention for n, lib in libs.items()}}
    names = list(FDA_VARIANTS)
    turns = ["built", *names, *names[::-1], "built"]
    res = {k: {n: [] for n in fns} for k in data}
    err = {k: {} for k in data}
    for n in turns:
        fda._fn = fns[n]
        for k, (q, kn, vn, ck, cv, ks) in data.items():
            call = lambda: fda.fused_decode_attention_kernel(q, kn, vn, ck, cv, li, idx, ks)
            if n not in err[k]:
                ref = fda.fused_decode_attention_plain(q, kn, vn, ck, cv, li, idx, ks)[0]
                err[k][n] = (call()[0].float() - ref.float()).abs().max().item()
            res[k][n].append(cs.graph_ms(call))
    fda._fn = built
    out.append({"experiment": "variants", "turns": turns, "ms": res, "max_abs_err": err})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_trace: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vla_rft_tpu_torch.ops import cuda_build
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    from vla_rft_tpu_torch.ops import decode_attention_hd as dec
    from vla_rft_tpu_torch.ops import fused_decode_attention as fda

    gen = torch.Generator(device="cuda").manual_seed(12)
    if "--fda-variants" in sys.argv:
        for rec in fda_variants(cuda_build, fda, gen):
            print(json.dumps(rec), flush=True)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
        return 0
    only = {"--decode-only", "--fda-only"} & set(sys.argv)
    if not only:
        lib = build_stamped(cuda_build, fdl)
        for N in (10, 128):
            print(json.dumps(trace(lib, fdl, N, gen)), flush=True)
    if not only or "--decode-only" in only:
        dlib = build_decode_stamped(cuda_build, dec)
        for rec in trace_decode(dlib, dec, gen):
            print(json.dumps(rec), flush=True)
    if not only or "--fda-only" in only:
        flib = build_fda_stamped(cuda_build, fda)
        for rec in trace_fda(flib, fda, gen):
            print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
