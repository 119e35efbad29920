"""Where the time of kernels #8 (RMSNorm + q/k/v + rope + quantisation),
#9 (o_proj + MLP) and the split-cache decode kernel (#4-#7) goes on the
card, per block.

    python3 kernel_trace.py [--decode-only]

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

then the card's name and power limit.  The stamped copies are built into
vla_rft_tpu_torch/_build/ (ignored by git).  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import ctypes
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_trace: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vla_rft_tpu_torch.ops import cuda_build
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    from vla_rft_tpu_torch.ops import decode_attention_hd as dec

    gen = torch.Generator(device="cuda").manual_seed(12)
    if "--decode-only" not in sys.argv:
        lib = build_stamped(cuda_build, fdl)
        for N in (10, 128):
            print(json.dumps(trace(lib, fdl, N, gen)), flush=True)
    dlib = build_decode_stamped(cuda_build, dec)
    for rec in trace_decode(dlib, dec, gen):
        print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
