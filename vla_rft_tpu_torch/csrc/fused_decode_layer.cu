// Fused decode-layer kernels of the int8-weight world-model rollout, for
// Hopper (sm_90a).
//
// Replaces the two TPU kernels of vla_rft_tpu/ops/fused_decode_layer.py:
//   * #8 `_qkv_kernel` (fused_rmsnorm_qkv): input RMSNorm, the int8-weight
//     q/k/v projections, NeoX rope on q and k, and per-(position, kv head)
//     int8 quantisation of k and v;
//   * #9 `_o_mlp_kernel` (fused_o_mlp): o_proj, the attention residual, the
//     post-attention RMSNorm, the SiLU-gated int8-weight MLP and the MLP
//     residual.
// They return what the Pallas kernels return, in the reference's rounding
// order (bit-compatible with the unfused path QuantDenseGeneral + RMSNorm +
// rope + Attention.quant, vla_rft_tpu/models/transformer.py):
//   * RMSNorm: f32 statistics, bf16(((x * r) * w)) with r = 1 / sqrtf(mean +
//     eps).  1/sqrtf (both operations IEEE-rounded) is used, not rsqrtf
//     (2 ulp): the same f32 r as the plain twin's 1/sqrt on the CPU; the
//     sum of squares is taken in another order than the twin's, which can
//     move r by an ulp and, rarely, one bf16 rounding of xn;
//   * qdot: bf16 activations times int8 weights widened to bf16, f32
//     accumulation, rounded to bf16, then times the bf16 per-output-channel
//     scale (a bf16 product: one f32 multiply of two bf16 values, rounded);
//   * rope: out = t*cos + t[l ^ D/2]*sins in f32 from the bf16 t, with the
//     multiplies and the add rounded separately (__fmul_rn/__fadd_rn, no
//     FMA contraction, as the reference computes it); q is stored as bf16,
//     k is rounded to bf16 and taken back to f32 for quantisation;
//   * quantisation: sc = max(amax / 127, 1e-8) in f32, q = clip(rint(t /
//     sc), -127, 127) (rint rounds halves to even, as jnp.round; roundf
//     would round them away from zero), the scale stored as bf16;
//   * MLP: m = (g * bf16(sigmoid_f32(g))) * u with both multiplies in bf16;
//     both residual adds in bf16.
//
// Design.  The Pallas kernels run grid=(1,) and keep a whole layer's
// weights in VMEM.  Here both are launches of one split-K streaming product
// (`streaming_product<KIND, NT8>`): #8 is one launch (QKV), #9 three, since
// the middle RMSNorm needs the whole H-wide row of x1 and the down
// projection all I columns of m: O_PROJ (x1 = x + qdot(attn, Wo)), GATE_UP
// (m = silu-gated g * u) and DOWN (out = x1 + qdot(m, Wd)).  Each computes
// Y^T = W^T X^T with mma.sync m16n8k16 (bf16 in, f32 accumulate): the
// weight's output columns fill the M = 16 side and the N tokens the n = 8
// side, so at N = 10 six of 16 token columns are padding.  A block of 4
// warps owns 64 output columns (for QKV one head: the Hq q heads, then the
// Hkv k heads, then the Hkv v heads, the weight chosen per head tile), a K
// slice and a group of 8, 16 or 32 tokens; the grid is column tile x K
// split x token group, the splits chosen by the wrapper for about two
// blocks per SM for QKV (48 heads x 4 splits at N = 10) and one for #9 (8,
// 2 and 8 splits at N = 10; two per SM ran slower there).  The
// K slice streams through a shared-memory ring (8 stages, 4 for GATE_UP's
// two weights) by 16-byte cp.async.cg: a stage holds a 64-row chunk of int8
// weights, the block's activation rows for those 64 k and, for QKV and
// GATE_UP, the norm weights.  QKV and GATE_UP recompute their tokens' RMS
// factor r from the whole row while the first chunks fly, and form the
// normalised activation bf16((x * r) * w) as a stage is read.  Warp w
// multiplies k16 step w of every chunk; its A fragments are widened int8 ->
// bf16 in registers at fragment load (byte permutes and an exact f32 bias
// trick), never through a bf16 copy of the tile.  Each warp stores its
// accumulators fragment-major (conflict-free) and the four are added in
// warp order.  The K splits of a column tile are one thread-block cluster:
// after a cluster barrier the ranks read the splits' partials from
// distributed shared memory and sum them in rank order, so the result is
// the same bits on every run.  #9's ranks each take a slice of the tile's
// outputs: bf16(acc) times the bf16 scale, then the bf16 residual or g *
// bf16(sigmoid_f32(g)) * u.  #8's ranks take whole tokens, a warp per token
// with lane l owning columns l and l + 32 (rope partners), so rope and the
// head's amax stay in one warp: q is stored rope'd, k/v quantised with
// their scales through strides, so the caller can point them at the KV
// cache.
// Weights are read in place at the pointer the caller gives (a layer's
// slice of a stacked tensor or a per-layer tensor), never copied.
//
// What bounds it on an H100.  At decode widths (N = B*Sq from 1 to 896) the
// products are below the card's 295 flop/byte ridge, so device memory
// bounds them: #8 reads H*(Hq+2Hkv)*D int8 weight bytes (3.1 MB at the WM's
// H 1024, 16/16 x 64, 0.94 us at 3.35 TB/s), #9 (Hq*D + 3I)*H (13.6 MB,
// 4.1 us).  A launch has each block's whole K slice in flight at N = 10
// (16-64 KB); what keeps them above their byte bounds (kernel_trace.py on
// an H100 80GB HBM3 at 700 W, N = 10, PERF.md) is a fixed chain per
// launch, about 1,800-5,200 SM cycles to the first chunk (the RMS pre-pass
// included), 1,000-1,300 at the cluster barrier and 2,100-4,900 in the
// epilogue, and a weight stream of 1.0-1.3 TB/s.  Beyond 16 (#8) or 32
// (#9) tokens each token group re-reads the weights, from L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_decode_layer.so fused_decode_layer.cu
// Interface: plain C (fused_qkv_bf16, fused_o_mlp_bf16, fused_decode_layer_setup),
// loaded with ctypes; each launches on the given stream, never
// synchronises, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// ------------------------------------------------------------ kernels #8, #9
// One split-K streaming product, `streaming_product<KIND, NT8>`: #8 is the
// QKV launch (RMSNorm + q/k/v + rope + k/v quantisation), #9 the O_PROJ (x1
// = x + qdot(attn, Wo)), GATE_UP (m = silu-gated qdot(rmsnorm(x1), Wg / Wu))
// and DOWN (out = x1 + qdot(m, Wd)) launches.  A block owns 64 output
// columns, a K slice of `chunks` 64-row chunks and a group of TN = 8 * NT8
// tokens (grid: column tile x K split x token group).
namespace omlp {

constexpr int BN = 64;          // output columns of a block: 4 m16 tiles
constexpr int BK = 64;          // rows of a chunk: one k16 step per warp
constexpr int NTHREADS = 128;
constexpr int LDW = BN + 16;    // int8 bytes per weight row (conflict-free 8-byte loads)
constexpr int LDX = BK + 8;     // bf16 per activation row (conflict-free 4-byte loads)
constexpr int MAX_SPLITS = 8;   // K splits of a launch: a portable cluster

enum Kind { O_PROJ = 0, GATE_UP = 1, DOWN = 2, QKV = 3 };

template <int KIND, int NT8>
struct Layout {
  static constexpr bool NORM = KIND == GATE_UP || KIND == QKV;  // RMSNorm of the activation
  static constexpr int NW = KIND == GATE_UP ? 2 : 1;  // weight matrices streamed
  static constexpr int STAGES = NW == 2 ? 4 : 8;       // chunks in the shared-memory ring
  static constexpr int TN = 8 * NT8;                   // tokens of a block
  static constexpr int W_BYTES = BK * LDW;
  static constexpr int X_OFF = NW * W_BYTES;
  static constexpr int NORM_OFF = X_OFF + TN * LDX * 2;
  static constexpr int STAGE = NORM_OFF + (NORM ? BK * 2 : 0);
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SLOTS = NW * 4 * NT8 * 4;  // accumulators of a thread
  static constexpr int RED = 4 * SLOTS * 32 * 4;   // every warp's, fragment-major
  static constexpr int BYTES = RING > RED ? RING : RED;
};

struct Params {
  const __nv_bfloat16* act;     // (N, K): attn, x1 or x (normalised on the fly) or m
  const int8_t* w0;             // (K, cols): Wo, Wg, Wd or Wq
  const __nv_bfloat16* s0;      // (cols,)
  const int8_t* w1;             // (K, cols): Wu (GATE_UP) or Wk (QKV)
  const __nv_bfloat16* s1;
  const __nv_bfloat16* norm_w;  // (K,) the norm weight (GATE_UP, QKV)
  const __nv_bfloat16* resid;   // (N, cols): x (O_PROJ) or x1 (DOWN)
  __nv_bfloat16* out;           // (N, cols): x1, m, the layer's output or q (QKV)
  int N, K, cols, splits, chunks;
  float eps;
  // QKV only: Wv, the rope tables, the k/v outputs and their strides (row
  // b of k/v at b * kv_bs, unit-stride (Sq, Hkv * D) inside; scale (b, head,
  // s) at b * sc_bs + head * sc_hs + s)
  const int8_t* w2;             // (K, Hkv * D)
  const __nv_bfloat16* s2;
  const float* cos_t;           // (N, Hq * D) f32 per-lane cos and signed sin
  const float* sins_t;
  int8_t* k_out;
  int8_t* v_out;
  __nv_bfloat16* ks_out;
  __nv_bfloat16* vs_out;
  int Sq, Hq, Hkv;
  int64_t kv_bs, sc_bs, sc_hs;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 bytes {b0, b1, b2, b3} -> bf16 pairs lo = {b0, b1}, hi = {b2,
// b3}, exactly: 2^23 + (b + 128) as f32 bits, less 2^23 + 128, whose upper
// 16 bits are the bf16 of the integer (|b| <= 128 needs 8 significant bits).
__device__ __forceinline__ void i8x4_to_bf16x4(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// The A fragments (A = W^T, m16 x k16, bf16) of the warp's k16 step for the
// block's 64 columns, widened from the int8 chunk in registers.  The rows
// of A are output columns, permuted so that a thread's eight columns are
// one 8-byte load: row g of m-tile t is column 8g + 2t, row g + 8 is
// column 8g + 2t + 1 (g = lane / 4).  Rows k, k+1 (and k+8, k+9) of the
// chunk are interleaved byte by byte, giving each column's (k, k+1) pair.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const unsigned char* w_s, int k16,
                                       int lane) {
  const int g = lane >> 2, q = lane & 3;
  const unsigned char* base = w_s + (k16 * 16 + 2 * q) * LDW + 8 * g;
  const uint2 r0 = *reinterpret_cast<const uint2*>(base);
  const uint2 r1 = *reinterpret_cast<const uint2*>(base + LDW);
  const uint2 r8 = *reinterpret_cast<const uint2*>(base + 8 * LDW);
  const uint2 r9 = *reinterpret_cast<const uint2*>(base + 9 * LDW);
  i8x4_to_bf16x4(__byte_perm(r0.x, r1.x, 0x5140), a[0][0], a[0][1]);
  i8x4_to_bf16x4(__byte_perm(r0.x, r1.x, 0x7362), a[1][0], a[1][1]);
  i8x4_to_bf16x4(__byte_perm(r0.y, r1.y, 0x5140), a[2][0], a[2][1]);
  i8x4_to_bf16x4(__byte_perm(r0.y, r1.y, 0x7362), a[3][0], a[3][1]);
  i8x4_to_bf16x4(__byte_perm(r8.x, r9.x, 0x5140), a[0][2], a[0][3]);
  i8x4_to_bf16x4(__byte_perm(r8.x, r9.x, 0x7362), a[1][2], a[1][3]);
  i8x4_to_bf16x4(__byte_perm(r8.y, r9.y, 0x5140), a[2][2], a[2][3]);
  i8x4_to_bf16x4(__byte_perm(r8.y, r9.y, 0x7362), a[3][2], a[3][3]);
}

// Chunk `kc` (rows kc..kc+63 of K) into a ring stage by 16-byte cp.async:
// the weight tile(s), 64 rows x 64 int8 of `w` (row stride `ldw`) ...
template <int KIND, int NT8>
__device__ __forceinline__ void load_weights(unsigned char* st, const Params& p, const int8_t* w,
                                             int ldw, int kc, int n0) {
  using L = Layout<KIND, NT8>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;  // 0..255
    const int r = idx >> 2, c = (idx & 3) * 16;
    const int64_t gofs = (int64_t)(kc + r) * ldw + n0 + c;
    cp_async16(st + r * LDW + c, w + gofs, true);
    if constexpr (L::NW == 2) cp_async16(st + L::W_BYTES + r * LDW + c, p.w1 + gofs, true);
  }
}

// ... and the block's TN activation rows (zero-filled past N) and, for
// GATE_UP and QKV, the 64 norm weights.
template <int KIND, int NT8>
__device__ __forceinline__ void load_acts(unsigned char* st, const Params& p, int kc, int t0) {
  using L = Layout<KIND, NT8>;
  for (int idx = threadIdx.x; idx < L::TN * 8; idx += NTHREADS) {
    const int r = idx >> 3, c = (idx & 7) * 8;
    const int tok = t0 + r;
    const bool ok = tok < p.N;
    cp_async16(st + L::X_OFF + (r * LDX + c) * 2, p.act + (ok ? (int64_t)tok * p.K + kc + c : 0),
               ok);
  }
  if constexpr (L::NORM) {
    if (threadIdx.x < 8) {
      cp_async16(st + L::NORM_OFF + threadIdx.x * 16, p.norm_w + kc + threadIdx.x * 8, true);
    }
  }
}

// bf16((x * r) * w) on both halves of a bf16 pair (RMSNorm of an x1 element).
__device__ __forceinline__ uint32_t norm_pair(uint32_t x, float r, uint32_t w) {
  const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(&x);
  const __nv_bfloat162 wv = *reinterpret_cast<const __nv_bfloat162*>(&w);
  __nv_bfloat162 o;
  o.x = __float2bfloat16(__fmul_rn(__fmul_rn(__bfloat162float(xv.x), r), __bfloat162float(wv.x)));
  o.y = __float2bfloat16(__fmul_rn(__fmul_rn(__bfloat162float(xv.y), r), __bfloat162float(wv.y)));
  return *reinterpret_cast<const uint32_t*>(&o);
}

template <int KIND, int NT8>
__global__ void __launch_bounds__(NTHREADS) streaming_product(const Params p) {
  using L = Layout<KIND, NT8>;
  constexpr int NW = L::NW, TN = L::TN, STAGES = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float rms_s[TN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int split = blockIdx.y, t0 = blockIdx.z * TN;
  // The block's weight and its first column: column tile blockIdx.x of w0,
  // or for QKV head tile blockIdx.x (the Hq q heads, then the Hkv k heads,
  // then the Hkv v heads), one head of BN columns of Wq, Wk or Wv.
  const int8_t* w = p.w0;
  const __nv_bfloat16* wscale = p.s0;
  int ldw = p.cols, n0 = blockIdx.x * BN, kind = 0, head = 0;
  if constexpr (KIND == QKV) {
    const int t = blockIdx.x;
    kind = t < p.Hq ? 0 : (t < p.Hq + p.Hkv ? 1 : 2);
    head = kind == 0 ? t : (kind == 1 ? t - p.Hq : t - p.Hq - p.Hkv);
    w = kind == 0 ? p.w0 : (kind == 1 ? p.w1 : p.w2);
    wscale = kind == 0 ? p.s0 : (kind == 1 ? p.s1 : p.s2);
    ldw = (kind == 0 ? p.Hq : p.Hkv) * BN;
    n0 = head * BN;
  }
  const int kc0 = split * p.chunks * BK;

  // The first STAGES chunks in flight, one commit group per chunk.
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < p.chunks) load_weights<KIND, NT8>(smem + s * L::STAGE, p, w, ldw, kc0 + s * BK, n0);
  }
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < p.chunks) load_acts<KIND, NT8>(smem + s * L::STAGE, p, kc0 + s * BK, t0);
    cp_async_commit();
  }


  if constexpr (L::NORM) {
    // r = 1 / sqrt(mean(x^2) + eps) over the whole row (K = H) while the
    // first chunks fly; 0 for tokens >= N.  PER threads share a token, each
    // summing every PER-th 8-element vector (8 loads in flight), then a
    // shuffle tree: a fixed order.
    constexpr int PER = NTHREADS / TN;
    const int row = threadIdx.x / PER, part = threadIdx.x % PER, n = t0 + row;
    float acc = 0.0f;
    if (n < p.N) {
      const __nv_bfloat16* xr = p.act + (int64_t)n * p.K;
      for (int k0 = part * 8; k0 < p.K; k0 += 8 * PER * 8) {
        uint4 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + j * PER * 8;
          v[j] = k < p.K ? *reinterpret_cast<const uint4*>(xr + k) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v[j]);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float f = __bfloat162float(e[i]);
            acc = __fadd_rn(acc, __fmul_rn(f, f));
          }
        }
      }
    }
#pragma unroll
    for (int off = PER / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (part == 0) {
      const float var = __fdiv_rn(acc, static_cast<float>(p.K));
      rms_s[row] = n < p.N ? __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, p.eps))) : 0.0f;
    }
  }

  float acc[NW][4][NT8][4];
#pragma unroll
  for (int wi = 0; wi < NW; ++wi)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[wi][t][n][e] = 0.0f;

  for (int c = 0; c < p.chunks; ++c) {
    cp_async_wait<STAGES - 1>();  // chunk c has landed (one commit group per chunk)
    __syncthreads();
    const unsigned char* st = smem + (c % STAGES) * L::STAGE;
    // B fragments (B = X^T, k16 x n8): token 8n + g, k = 16 warp + 2q (+8)
    uint32_t b[NT8][2];
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st + L::X_OFF);
#pragma unroll
    for (int n = 0; n < NT8; ++n) {
      const uint32_t* xr =
          reinterpret_cast<const uint32_t*>(xs + (8 * n + g) * LDX + 16 * warp + 2 * q);
      b[n][0] = xr[0];
      b[n][1] = xr[4];
      if constexpr (L::NORM) {
        const uint32_t* nw =
            reinterpret_cast<const uint32_t*>(st + L::NORM_OFF) + 8 * warp + q;
        const float r = rms_s[8 * n + g];
        b[n][0] = norm_pair(b[n][0], r, nw[0]);
        b[n][1] = norm_pair(b[n][1], r, nw[4]);
      }
    }
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      uint32_t a[4][4];
      load_a(a, st + wi * L::W_BYTES, warp, lane);
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int n = 0; n < NT8; ++n) mma_bf16(acc[wi][t][n], a[t], b[n][0], b[n][1]);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    if (c + STAGES < p.chunks) {
      unsigned char* st_next = smem + (c % STAGES) * L::STAGE;
      load_weights<KIND, NT8>(st_next, p, w, ldw, kc0 + (c + STAGES) * BK, n0);
      load_acts<KIND, NT8>(st_next, p, kc0 + (c + STAGES) * BK, t0);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();

  // Each warp's accumulators into its own fragment-major slots,
  // red[warp][slot][lane] (conflict-free), then the four warps' sums in
  // warp order into warp 0's slots.  Slot (wi, t, n, e) of lane (g, q) is
  // token 8n + 2q + (e & 1), column 8g + 2t + (e >> 1).
  constexpr int SLOTS = L::SLOTS;
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int wi = 0; wi < NW; ++wi)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int n = 0; n < NT8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red[(warp * SLOTS + ((wi * 4 + t) * NT8 + n) * 4 + e) * 32 + lane] = acc[wi][t][n][e];
        }
  __syncthreads();
  for (int idx = threadIdx.x; idx < SLOTS * 32; idx += NTHREADS) {
    red[idx] = ((red[idx] + red[SLOTS * 32 + idx]) + red[2 * SLOTS * 32 + idx]) +
               red[3 * SLOTS * 32 + idx];
  }

  // The K splits of a column tile are one thread-block cluster (rank =
  // split): an accumulator's sum over the ranks, from distributed shared
  // memory, in rank order, so the result does not depend on timing.
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  auto split_sum = [&](float* mine) {
    float v[MAX_SPLITS];
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < p.splits) v[r] = p.splits > 1 ? *cluster.map_shared_rank(mine, r) : *mine;
    }
    float sum = 0.0f;
#pragma unroll
    for (int r = 0; r < MAX_SPLITS; ++r) {
      if (r < p.splits) sum += v[r];
    }
    return sum;
  };
  if (p.splits > 1) {
    cluster.sync();  // every split's sums are complete
  } else {
    __syncthreads();
  }
  if constexpr (KIND == QKV) {
    // #8's epilogue, once per token, spread over the splits: the group's
    // token tok goes to rank (tok / 4) % splits, warp tok % 4.  Lane l owns
    // columns l and l + 32, so the rope partner of column l (l ^ 32) is the
    // lane's other column and the head's amax a warp reduction.  Column c
    // of token tok sits in accumulator slot (t, n, e) = ((c % 8) / 2, tok /
    // 8, tok % 2 + 2 (c % 2)) of lane (g, q) = (c / 8, (tok % 8) / 2).
    const float s_lo = __bfloat162float(wscale[n0 + lane]);
    const float s_hi = __bfloat162float(wscale[n0 + lane + 32]);
    const int HqD = p.Hq * BN, KD = p.Hkv * BN;
    for (int tok = 4 * split + warp; tok < TN; tok += 4 * p.splits) {
      const int n = t0 + tok;
      if (n >= p.N) break;
      auto at = [&](int c) {
        const int sl = (((c & 7) >> 1) * NT8 + (tok >> 3)) * 4 + ((tok & 1) | ((c & 1) << 1));
        return red + sl * 32 + (c >> 3) * 4 + ((tok & 7) >> 1);
      };
      // qdot's rounding, bf16(bf16(acc) * scale)
      float y0 = bf16r(__fmul_rn(bf16r(split_sum(at(lane))), s_lo));
      float y1 = bf16r(__fmul_rn(bf16r(split_sum(at(lane + 32))), s_hi));
      if (kind < 2) {  // rope: out = t * cos + t[l ^ 32] * sins
        const int64_t tb = (int64_t)n * HqD + n0;  // the tables repeat per head (period D)
        const float c0 = p.cos_t[tb + lane], c1 = p.cos_t[tb + lane + 32];
        const float z0 = p.sins_t[tb + lane], z1 = p.sins_t[tb + lane + 32];
        const float r0 = __fadd_rn(__fmul_rn(y0, c0), __fmul_rn(y1, z0));
        const float r1 = __fadd_rn(__fmul_rn(y1, c1), __fmul_rn(y0, z1));
        if (kind == 0) {
          p.out[(int64_t)n * HqD + n0 + lane] = __float2bfloat16(r0);
          p.out[(int64_t)n * HqD + n0 + lane + 32] = __float2bfloat16(r1);
          continue;
        }
        y0 = bf16r(r0);  // rope returns bf16; the quantiser reads it in f32
        y1 = bf16r(r1);
      }
      float amax = fmaxf(fabsf(y0), fabsf(y1));
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      const float sc = fmaxf(__fdiv_rn(amax, 127.0f), 1e-8f);
      const float q0 = fminf(fmaxf(rintf(__fdiv_rn(y0, sc)), -127.0f), 127.0f);
      const float q1 = fminf(fmaxf(rintf(__fdiv_rn(y1, sc)), -127.0f), 127.0f);
      const int b = n / p.Sq, sidx = n % p.Sq;
      int8_t* dst = (kind == 1 ? p.k_out : p.v_out) + b * p.kv_bs + (int64_t)sidx * KD + n0;
      dst[lane] = static_cast<int8_t>(q0);
      dst[lane + 32] = static_cast<int8_t>(q1);
      if (lane == 0) {
        (kind == 1 ? p.ks_out : p.vs_out)[b * p.sc_bs + head * p.sc_hs + sidx] =
            __float2bfloat16(sc);
      }
    }
  } else {
    // #9's epilogue, once per output element, spread over the splits: this
    // block takes items [e0, e1) of the (t, n, e, lane) accumulators of one
    // weight (GATE_UP's g and u together); item `it` is token 8n + 2q + (e &
    // 1) and column 8g + 2t + (e >> 1) of accumulator slot it / 32, lane it %
    // 32.
    constexpr int PER_W = 16 * NT8 * 32;  // items
    constexpr int ITEMS = (PER_W + NTHREADS - 1) / NTHREADS;
    const int e0 = PER_W * split / p.splits, e1 = PER_W * (split + 1) / p.splits;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int it = e0 + threadIdx.x + i * NTHREADS, sl = it / 32, ln = it % 32;
      const int tok = 8 * ((sl / 4) % NT8) + 2 * (ln & 3) + (sl & 1);
      const int col = 8 * (ln >> 2) + 2 * (sl / (4 * NT8)) + ((sl >> 1) & 1);
      if (it >= e1 || t0 + tok >= p.N) continue;
      // s0 and s1 (GATE_UP) or s0 and the residual
      const float s0v = __bfloat162float(p.s0[n0 + col]);
      const float s1v = KIND == GATE_UP
                            ? __bfloat162float(p.s1[n0 + col])
                            : __bfloat162float(p.resid[(int64_t)(t0 + tok) * p.cols + n0 + col]);
      float sum[NW];
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) sum[wi] = split_sum(red + wi * PER_W + it);
      // qdot's rounding, bf16(bf16(acc) * scale), then the residual (O_PROJ,
      // DOWN) or the gated SiLU (GATE_UP), in the reference's order.
      const int64_t o = (int64_t)(t0 + tok) * p.cols + n0 + col;
      const float a0 = bf16r(__fmul_rn(bf16r(sum[0]), s0v));
      if constexpr (KIND == GATE_UP) {
        const float uv = bf16r(__fmul_rn(bf16r(sum[NW - 1]), s1v));
        const float sig = bf16r(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-a0))));
        p.out[o] = __float2bfloat16(__fmul_rn(bf16r(__fmul_rn(a0, sig)), uv));
      } else {
        p.out[o] = __float2bfloat16(__fadd_rn(s1v, a0));
      }
    }
  }
  if (p.splits > 1) cluster.sync();  // no block leaves while another reads its sums
}

template <int KIND, int NT8>
cudaError_t setup_one() {
  return cudaFuncSetAttribute(streaming_product<KIND, NT8>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<KIND, NT8>::BYTES);
}

template <int KIND>
cudaError_t setup_kind() {
  cudaError_t e = setup_one<KIND, 1>();
  if (e == cudaSuccess) e = setup_one<KIND, 2>();
  if (e == cudaSuccess) e = setup_one<KIND, 4>();
  return e;
}

// A launch of one product: grid (column tiles, splits, token groups), the
// splits of a column tile one cluster (1, splits, 1).
template <int KIND, int NT8>
cudaError_t launch_one(const Params& p, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cols / BN, p.splits, (p.N + 8 * NT8 - 1) / (8 * NT8));
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = Layout<KIND, NT8>::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, streaming_product<KIND, NT8>, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int KIND>
cudaError_t launch(Params p, int nt8, cudaStream_t st) {
  if (p.N < 1 || p.splits < 1 || p.splits > MAX_SPLITS || p.K % (BK * p.splits) ||
      p.cols % BN) {
    return cudaErrorInvalidValue;
  }
  p.chunks = p.K / (BK * p.splits);
  switch (nt8) {
    case 1: return launch_one<KIND, 1>(p, st);
    case 2: return launch_one<KIND, 2>(p, st);
    case 4: return launch_one<KIND, 4>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace omlp

}  // namespace

// The launch of #8: grid (Hq + 2 Hkv head tiles, `splits` K slices (a
// cluster each), token groups of 8 * nt8).  k/v and their scales go
// through the strides kv_bs (rows of k/v), sc_bs and sc_hs (rows and heads
// of the scales).
extern "C" int fused_qkv_bf16(const void* x, const void* cos_t, const void* sins_t,
                              const void* norm_w, const void* wq, const void* sq, const void* wk,
                              const void* sk, const void* wv, const void* sv, void* q_out,
                              void* k_out, void* v_out, void* ks_out, void* vs_out, int N, int Sq,
                              int H, int Hq, int Hkv, int64_t kv_bs, int64_t sc_bs,
                              int64_t sc_hs, int nt8, int splits, float eps, void* stream) {
  using namespace omlp;
  using bf = __nv_bfloat16;
  Params p{};
  p.act = static_cast<const bf*>(x);
  p.norm_w = static_cast<const bf*>(norm_w);
  p.w0 = static_cast<const int8_t*>(wq);
  p.s0 = static_cast<const bf*>(sq);
  p.w1 = static_cast<const int8_t*>(wk);
  p.s1 = static_cast<const bf*>(sk);
  p.w2 = static_cast<const int8_t*>(wv);
  p.s2 = static_cast<const bf*>(sv);
  p.cos_t = static_cast<const float*>(cos_t);
  p.sins_t = static_cast<const float*>(sins_t);
  p.out = static_cast<bf*>(q_out);
  p.k_out = static_cast<int8_t*>(k_out);
  p.v_out = static_cast<int8_t*>(v_out);
  p.ks_out = static_cast<bf*>(ks_out);
  p.vs_out = static_cast<bf*>(vs_out);
  p.N = N, p.K = H, p.cols = (Hq + 2 * Hkv) * BN, p.splits = splits, p.eps = eps;
  p.Sq = Sq, p.Hq = Hq, p.Hkv = Hkv, p.kv_bs = kv_bs, p.sc_bs = sc_bs, p.sc_hs = sc_hs;
  return static_cast<int>(launch<QKV>(p, nt8, static_cast<cudaStream_t>(stream)));
}

// The three launches of #9 on one stream: O_PROJ, GATE_UP, DOWN, each over
// `split_*` K slices (a cluster each) and token groups of 8 * nt8.  x1
// (N, H) and m (N, I) are the caller's scratch.  Returns the first launch
// error.
extern "C" int fused_o_mlp_bf16(const void* attn, const void* x, const void* wo, const void* so,
                                const void* norm_w, const void* wg, const void* sg,
                                const void* wu, const void* su, const void* wd, const void* sd,
                                void* x1, void* m, void* out, int N, int HqD, int H, int I,
                                int nt8, int split_o, int split_gu, int split_d, float eps,
                                void* stream) {
  using namespace omlp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  Params p{};
  p.N = N;
  p.eps = eps;

  Params a = p;  // x1 = x + qdot(attn, Wo)
  a.act = static_cast<const bf*>(attn);
  a.w0 = static_cast<const int8_t*>(wo);
  a.s0 = static_cast<const bf*>(so);
  a.resid = static_cast<const bf*>(x);
  a.out = static_cast<bf*>(x1);
  a.K = HqD, a.cols = H, a.splits = split_o;
  cudaError_t err = launch<O_PROJ>(a, nt8, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  Params b = p;  // m = silu(g) * u over rmsnorm(x1)
  b.act = static_cast<const bf*>(x1);
  b.w0 = static_cast<const int8_t*>(wg);
  b.s0 = static_cast<const bf*>(sg);
  b.w1 = static_cast<const int8_t*>(wu);
  b.s1 = static_cast<const bf*>(su);
  b.norm_w = static_cast<const bf*>(norm_w);
  b.out = static_cast<bf*>(m);
  b.K = H, b.cols = I, b.splits = split_gu;
  err = launch<GATE_UP>(b, nt8, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  Params c = p;  // out = x1 + qdot(m, Wd)
  c.act = static_cast<const bf*>(m);
  c.w0 = static_cast<const int8_t*>(wd);
  c.s0 = static_cast<const bf*>(sd);
  c.resid = static_cast<const bf*>(x1);
  c.out = static_cast<bf*>(out);
  c.K = I, c.cols = H, c.splits = split_d;
  return static_cast<int>(launch<DOWN>(c, nt8, st));
}

// Raises the dynamic shared-memory limit of every #8 and #9 instance to
// what it uses; called once per device when the library is loaded.
extern "C" int fused_decode_layer_setup() {
  cudaError_t err = omlp::setup_kind<omlp::O_PROJ>();
  if (err == cudaSuccess) err = omlp::setup_kind<omlp::GATE_UP>();
  if (err == cudaSuccess) err = omlp::setup_kind<omlp::DOWN>();
  if (err == cudaSuccess) err = omlp::setup_kind<omlp::QKV>();
  return static_cast<int>(err);
}
