"""Where the time of kernels #8 (RMSNorm + q/k/v + rope + quantisation) and
#9 (o_proj + MLP) goes on the card, per block.

    python3 kernel_trace.py

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

then the card's name and power limit.  The stamped copy is built into
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


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_trace: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from vla_rft_tpu_torch.ops import cuda_build
    from vla_rft_tpu_torch.ops import fused_decode_layer as fdl

    lib = build_stamped(cuda_build, fdl)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for N in (10, 128):
        print(json.dumps(trace(lib, fdl, N, gen)), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
