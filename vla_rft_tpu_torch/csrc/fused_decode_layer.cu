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
// weights in VMEM.  Here every product is tiled over the card.
//   * #8: one launch, a block of 4 warps per (head tile of D = 64 columns:
//     the Hq q heads, then the Hkv k heads, then the Hkv v heads; 64-row
//     tile), looping over the contraction in 64-deep chunks.  Per chunk it
//     converts the int8 weight tile to bf16 in shared memory and builds the
//     bf16 activation tile ((x * r) * w on the fly, each row's r computed
//     at the block's start from the whole row), and each warp multiplies
//     its 16-row strip with WMMA (bf16 in, f32 accumulate); the next
//     chunk's global loads are issued into registers before the current
//     chunk's products.  Rope and quantisation need only the head's own 64
//     lanes, so they run in the block's epilogue: a warp per row, lane l
//     owning columns l and l + 32 (rope partners).  k/v and their scales are
//     written through strides, so the caller can point them at the KV cache.
//   * #9: three launches of one split-K streaming product (o_mlp_product),
//     since the middle RMSNorm needs the whole H-wide row of x1 and the down
//     projection all I columns of m: O_PROJ (x1 = x + qdot(attn, Wo)),
//     GATE_UP (each block recomputes its tokens' r from x1; m = silu-gated
//     g * u) and DOWN (out = x1 + qdot(m, Wd)).  Each computes Y^T = W^T X^T
//     with mma.sync m16n8k16 (bf16 in, f32 accumulate): the weight's output
//     columns fill the M = 16 side and the N tokens the n = 8 side, so at
//     N = 10 six of 16 token columns are padding (#8's WMMA tile pads 64
//     rows).  A block of 4 warps owns 64 output columns, a K slice and a
//     group of 8, 16 or 32 tokens; the grid is column tile x K split x token
//     group, the splits chosen by the wrapper for about one block per SM (at
//     N = 10: 8, 2 and 8 splits, 128 blocks per launch).  The K slice streams
//     through a shared-memory ring (8 stages, 4 for GATE_UP's two weights)
//     by 16-byte cp.async.cg: a stage holds a 64-row chunk of int8 weights,
//     the block's activation rows for those 64 k and, for GATE_UP, the norm
//     weights.  Warp w multiplies k16 step w of every chunk; its A fragments
//     are widened int8 -> bf16 in registers at fragment load (byte permutes
//     and an exact f32 bias trick), never through a bf16 copy of the tile.
//     Each warp stores its accumulators fragment-major (conflict-free) and
//     the four are added in warp order.  The K splits of a column tile are
//     one thread-block cluster: after a cluster barrier every rank takes a
//     slice of the tile's outputs and sums the ranks' partials from
//     distributed shared memory in rank order, so the result is the same
//     bits on every run, and runs the epilogue there, once per output
//     element: bf16(acc) times the bf16 scale, then the bf16 residual or
//     g * bf16(sigmoid_f32(g)) * u.
// Weights are read in place at the pointer the caller gives (a layer's
// slice of a stacked tensor or a per-layer tensor), never copied.
//
// What bounds it on an H100.  At decode widths (N = B*Sq from 1 to 896) the
// products are below the card's 295 flop/byte ridge, so device memory
// bounds them: #8 reads H*(Hq+2Hkv)*D int8 weight bytes (3.1 MB at the WM's
// H 1024, 16/16 x 64), #9 (Hq*D + 3I)*H (13.6 MB, 4.1 us at 3.35 TB/s).
// #8 keeps its first design (48 blocks at small N, one chunk in flight).
// #9 has a launch's whole K slice in flight per block (32-64 KB at N = 10);
// what keeps it above its byte bound (kernel_trace.py on an H100 80GB
// HBM3 at 700 W, N = 10, PERF.md) is a fixed chain per launch, about
// 1,800-4,700 SM cycles to the first chunk, 900-1,600 at the cluster
// barrier and 1,800-4,700 in the epilogue, and a weight stream of 1.0-1.3
// TB/s.  At N > 32 each token group re-reads the weights, from L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_decode_layer.so fused_decode_layer.cu
// Interface: plain C (fused_qkv_bf16, fused_o_mlp_bf16, fused_o_mlp_setup),
// loaded with ctypes; each launches on the given stream, never
// synchronises, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;        // rows of a tile
constexpr int BN = 64;        // columns of a tile (one head of D = 64)
constexpr int BK = 64;        // contraction chunk
constexpr int NTHREADS = 128;  // 4 warps, one 16-row strip each
constexpr int LDA = BK + 8;   // bf16, padded against bank conflicts
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // f32

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One chunk of the activation tile in registers: 64 rows x 64 bf16 =
// 512 16-byte vectors, 4 per thread.
struct ARegs {
  uint4 v[4];
};
// One chunk of the weight tile: 64 rows x 64 int8 = 256 vectors, 2 per thread.
struct BRegs {
  uint4 v[2];
};

__device__ __forceinline__ void load_a(ARegs& r, const __nv_bfloat16* __restrict__ a, int lda,
                                       int m0, int N, int k0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;  // 0..511
    const int row = idx / 8, col = (idx % 8) * 8;
    r.v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + row < N) {
      r.v[i] = *reinterpret_cast<const uint4*>(a + (int64_t)(m0 + row) * lda + k0 + col);
    }
  }
}

__device__ __forceinline__ void load_b(BRegs& r, const int8_t* __restrict__ w, int ldw, int k0,
                                       int n0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;  // 0..255
    const int row = idx / 4, col = (idx % 4) * 16;
    r.v[i] = *reinterpret_cast<const uint4*>(w + (int64_t)(k0 + row) * ldw + n0 + col);
  }
}

// Registers -> the bf16 activation tile.  With `rms`, element (m, k) becomes
// bf16((x * r[m]) * w[k0 + k]) in f32 (RMSNorm of the row, r precomputed).
__device__ __forceinline__ void store_a(__nv_bfloat16* a_s, const ARegs& r,
                                        const float* __restrict__ rms,
                                        const __nv_bfloat16* __restrict__ norm_w, int k0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int row = idx / 8, col = (idx % 8) * 8;
    uint4 v = r.v[i];
    if (rms != nullptr) {
      __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
      const float rr = rms[row];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float w = __bfloat162float(norm_w[k0 + col + j]);
        e[j] = __float2bfloat16(__fmul_rn(__fmul_rn(__bfloat162float(e[j]), rr), w));
      }
    }
    *reinterpret_cast<uint4*>(a_s + row * LDA + col) = v;
  }
}

// Registers -> the weight tile, int8 widened to bf16 (exact for |v| <= 127).
__device__ __forceinline__ void store_b(__nv_bfloat16* b_s, const BRegs& r) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;
    const int row = idx / 4, col = (idx % 4) * 16;
    const int8_t* e = reinterpret_cast<const int8_t*>(&r.v[i]);
    __align__(16) __nv_bfloat16 out[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) out[j] = __float2bfloat16(static_cast<float>(e[j]));
    uint4* dst = reinterpret_cast<uint4*>(b_s + row * LDB + col);
    dst[0] = reinterpret_cast<const uint4*>(out)[0];
    dst[1] = reinterpret_cast<const uint4*>(out)[1];
  }
}

// r[m] = 1 / sqrt(mean(x[m]^2) + eps) for the block's rows (0 for rows >= N).
__device__ void row_rms(float* rms_s, const __nv_bfloat16* __restrict__ x, int ldx, int m0,
                        int N, int H, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int row = warp; row < BM; row += NTHREADS / 32) {
    float acc = 0.0f;
    if (m0 + row < N) {
      const __nv_bfloat16* xr = x + (int64_t)(m0 + row) * ldx;
      for (int k = lane; k < H; k += 32) {
        const float v = __bfloat162float(xr[k]);
        acc = __fadd_rn(acc, __fmul_rn(v, v));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      const float var = __fdiv_rn(acc, static_cast<float>(H));
      rms_s[row] = m0 + row < N ? __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps))) : 0.0f;
    }
  }
}

// Shared memory of one block: the A/B chunk tiles during the loop, the f32
// output tiles after it (aliased), and the rows' RMS factors.
constexpr int A_BYTES = BM * LDA * 2;
constexpr int B_BYTES = BK * LDB * 2;
constexpr int C_BYTES = BM * LDC * 4;
constexpr int LOOP_BYTES = A_BYTES + 2 * B_BYTES;
constexpr int TILE_BYTES = (LOOP_BYTES > 2 * C_BYTES ? LOOP_BYTES : 2 * C_BYTES);

// The block's (BM x BN) tile(s) of A @ W over K, into c_s (f32, row-major,
// LDC).  With `w2`, a second product over the same A into c2_s (gate and
// up share their normalised input).
template <bool TWO>
__device__ void gemm_tile(unsigned char* smem, float* c_s, float* c2_s,
                          const __nv_bfloat16* __restrict__ a, int lda, int m0, int N, int K,
                          const int8_t* __restrict__ w, const int8_t* __restrict__ w2, int ldw,
                          int n0, const float* rms, const __nv_bfloat16* __restrict__ norm_w) {
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* b_s = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  __nv_bfloat16* b2_s = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES + B_BYTES);
  const int warp = threadIdx.x / 32;
  const bool live = m0 + warp * 16 < N;  // a strip of rows >= N only multiplies zeros

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16], acc2[TWO ? BN / 16 : 1];
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int j = 0; j < (TWO ? BN / 16 : 1); ++j) wmma::fill_fragment(acc2[j], 0.0f);

  ARegs ar;
  BRegs br, br2;
  load_a(ar, a, lda, m0, N, 0);
  load_b(br, w, ldw, 0, n0);
  if (TWO) load_b(br2, w2, ldw, 0, n0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_a(a_s, ar, rms, norm_w, k0);
    store_b(b_s, br);
    if (TWO) store_b(b2_s, br2);
    __syncthreads();
    if (k0 + BK < K) {  // the next chunk's loads fly during this chunk's products
      load_a(ar, a, lda, m0, N, k0 + BK);
      load_b(br, w, ldw, k0 + BK, n0);
      if (TWO) load_b(br2, w2, ldw, k0 + BK, n0);
    }
    if (live) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
        wmma::load_matrix_sync(af, a_s + warp * 16 * LDA + kk * 16, LDA);
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(bf, b_s + kk * 16 * LDB + j * 16, LDB);
          wmma::mma_sync(acc[j], af, bf, acc[j]);
          if (TWO) {
            wmma::load_matrix_sync(bf, b2_s + kk * 16 * LDB + j * 16, LDB);
            wmma::mma_sync(acc2[j], af, bf, acc2[j]);
          }
        }
      }
    }
    __syncthreads();
  }
  // c_s / c2_s alias the chunk tiles: every warp is past its last product.
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    wmma::store_matrix_sync(c_s + warp * 16 * LDC + j * 16, acc[j], LDC, wmma::mem_row_major);
    if (TWO) {
      wmma::store_matrix_sync(c2_s + warp * 16 * LDC + j * 16, acc2[j], LDC,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
}

// qdot's epilogue for one accumulator: bf16(bf16(acc) * scale).
__device__ __forceinline__ float qscale(float acc, __nv_bfloat16 s) {
  return bf16r(__fmul_rn(bf16r(acc), __bfloat162float(s)));
}

// ------------------------------------------------------------------ kernel #8
__global__ void __launch_bounds__(NTHREADS)
qkv_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ cos_t,
           const float* __restrict__ sins_t, const __nv_bfloat16* __restrict__ norm_w,
           const int8_t* __restrict__ wq, const __nv_bfloat16* __restrict__ sq,
           const int8_t* __restrict__ wk, const __nv_bfloat16* __restrict__ sk,
           const int8_t* __restrict__ wv, const __nv_bfloat16* __restrict__ sv,
           __nv_bfloat16* __restrict__ q_out, int8_t* __restrict__ k_out,
           int8_t* __restrict__ v_out, __nv_bfloat16* __restrict__ ks_out,
           __nv_bfloat16* __restrict__ vs_out, int N, int Sq, int H, int Hq, int Hkv,
           int64_t kv_bs, int64_t sc_bs, int64_t sc_hs, float eps) {
  __shared__ __align__(128) unsigned char smem[TILE_BYTES];
  __shared__ float rms_s[BM];
  constexpr int D = BN;
  const int t = blockIdx.x;  // head tile: q heads, then k heads, then v heads
  const int m0 = blockIdx.y * BM;
  const int HqD = Hq * D, KD = Hkv * D;
  int kind, head;  // 0 q, 1 k, 2 v
  const int8_t* w;
  const __nv_bfloat16* s;
  int ldw;
  if (t < Hq) {
    kind = 0, head = t, w = wq, s = sq, ldw = HqD;
  } else if (t < Hq + Hkv) {
    kind = 1, head = t - Hq, w = wk, s = sk, ldw = KD;
  } else {
    kind = 2, head = t - Hq - Hkv, w = wv, s = sv, ldw = KD;
  }
  const int n0 = head * D;

  row_rms(rms_s, x, H, m0, N, H, eps);
  __syncthreads();
  float* c_s = reinterpret_cast<float*>(smem);
  gemm_tile<false>(smem, c_s, nullptr, x, H, m0, N, H, w, nullptr, ldw, n0, rms_s, norm_w);

  // Epilogue: a warp per row; lane owns columns lane and lane + 32.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16 s0 = s[n0 + lane], s1 = s[n0 + lane + 32];
  for (int row = warp; row < BM; row += NTHREADS / 32) {
    const int n = m0 + row;
    if (n >= N) break;
    float y0 = qscale(c_s[row * LDC + lane], s0);
    float y1 = qscale(c_s[row * LDC + lane + 32], s1);
    if (kind < 2) {  // rope: partner of lane l is lane l ^ 32, here the other column
      const int64_t tb = (int64_t)n * HqD + n0;  // tables repeat per head (period D)
      const float c0 = cos_t[tb + lane], c1 = cos_t[tb + lane + 32];
      const float z0 = sins_t[tb + lane], z1 = sins_t[tb + lane + 32];
      const float r0 = __fadd_rn(__fmul_rn(y0, c0), __fmul_rn(y1, z0));
      const float r1 = __fadd_rn(__fmul_rn(y1, c1), __fmul_rn(y0, z1));
      if (kind == 0) {
        q_out[(int64_t)n * HqD + n0 + lane] = __float2bfloat16(r0);
        q_out[(int64_t)n * HqD + n0 + lane + 32] = __float2bfloat16(r1);
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
    const int b = n / Sq, sidx = n % Sq;
    int8_t* dst = (kind == 1 ? k_out : v_out) + b * kv_bs + (int64_t)sidx * KD + n0;
    dst[lane] = static_cast<int8_t>(q0);
    dst[lane + 32] = static_cast<int8_t>(q1);
    if (lane == 0) {
      (kind == 1 ? ks_out : vs_out)[b * sc_bs + head * sc_hs + sidx] = __float2bfloat16(sc);
    }
  }
}

// ------------------------------------------------------------------ kernel #9
// Three launches of one split-K streaming product, `o_mlp_product<KIND,
// NT8>`: O_PROJ (x1 = x + qdot(attn, Wo)), GATE_UP (m = silu-gated
// qdot(rmsnorm(x1), Wg / Wu)) and DOWN (out = x1 + qdot(m, Wd)).  A block
// owns 64 output columns, a K slice of `chunks` 64-row chunks and a group of
// TN = 8 * NT8 tokens (grid: column tile x K split x token group).
namespace omlp {

constexpr int BN = 64;          // output columns of a block: 4 m16 tiles
constexpr int BK = 64;          // rows of a chunk: one k16 step per warp
constexpr int NTHREADS = 128;
constexpr int LDW = BN + 16;    // int8 bytes per weight row (conflict-free 8-byte loads)
constexpr int LDX = BK + 8;     // bf16 per activation row (conflict-free 4-byte loads)
constexpr int MAX_SPLITS = 8;   // K splits of a launch: a portable cluster

enum Kind { O_PROJ = 0, GATE_UP = 1, DOWN = 2 };

template <int KIND, int NT8>
struct Layout {
  static constexpr int NW = KIND == GATE_UP ? 2 : 1;  // weight matrices streamed
  static constexpr int STAGES = NW == 2 ? 4 : 8;       // chunks in the shared-memory ring
  static constexpr int TN = 8 * NT8;                   // tokens of a block
  static constexpr int W_BYTES = BK * LDW;
  static constexpr int X_OFF = NW * W_BYTES;
  static constexpr int NORM_OFF = X_OFF + TN * LDX * 2;
  static constexpr int STAGE = NORM_OFF + (KIND == GATE_UP ? BK * 2 : 0);
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SLOTS = NW * 4 * NT8 * 4;  // accumulators of a thread
  static constexpr int RED = 4 * SLOTS * 32 * 4;   // every warp's, fragment-major
  static constexpr int BYTES = RING > RED ? RING : RED;
};

struct Params {
  const __nv_bfloat16* act;     // (N, K): attn, x1 (normalised on the fly) or m
  const int8_t* w0;             // (K, cols): Wo, Wg or Wd
  const __nv_bfloat16* s0;      // (cols,)
  const int8_t* w1;             // (K, cols): Wu (GATE_UP only)
  const __nv_bfloat16* s1;
  const __nv_bfloat16* norm_w;  // (K,) post-attention norm weight (GATE_UP only)
  const __nv_bfloat16* resid;   // (N, cols): x (O_PROJ) or x1 (DOWN)
  __nv_bfloat16* out;           // (N, cols): x1, m or the layer's output
  int N, K, cols, splits, chunks;
  float eps;
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
// the weight tile(s), 64 rows x 64 int8 ...
template <int KIND, int NT8>
__device__ __forceinline__ void load_weights(unsigned char* st, const Params& p, int kc, int n0) {
  using L = Layout<KIND, NT8>;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = threadIdx.x + i * NTHREADS;  // 0..255
    const int r = idx >> 2, c = (idx & 3) * 16;
    const int64_t gofs = (int64_t)(kc + r) * p.cols + n0 + c;
    cp_async16(st + r * LDW + c, p.w0 + gofs, true);
    if constexpr (L::NW == 2) cp_async16(st + L::W_BYTES + r * LDW + c, p.w1 + gofs, true);
  }
}

// ... and the block's TN activation rows (zero-filled past N) and, for
// GATE_UP, the 64 norm weights.
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
  if constexpr (KIND == GATE_UP) {
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
__global__ void __launch_bounds__(NTHREADS) o_mlp_product(const Params p) {
  using L = Layout<KIND, NT8>;
  constexpr int NW = L::NW, TN = L::TN, STAGES = L::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float rms_s[TN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * BN, split = blockIdx.y, t0 = blockIdx.z * TN;
  const int kc0 = split * p.chunks * BK;

  // The first STAGES chunks in flight, one commit group per chunk.
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < p.chunks) load_weights<KIND, NT8>(smem + s * L::STAGE, p, kc0 + s * BK, n0);
  }
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < p.chunks) load_acts<KIND, NT8>(smem + s * L::STAGE, p, kc0 + s * BK, t0);
    cp_async_commit();
  }


  if constexpr (KIND == GATE_UP) {
    // r = 1 / sqrt(mean(x1^2) + eps) over the whole row (K = H) while the
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
      if constexpr (KIND == GATE_UP) {
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
      load_weights<KIND, NT8>(st_next, p, kc0 + (c + STAGES) * BK, n0);
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

  // Epilogue, once per output element, spread over the splits: this block
  // takes items [e0, e1) of the (t, n, e, lane) accumulators of one weight
  // (GATE_UP's g and u together); item `it` is token 8n + 2q + (e & 1) and
  // column 8g + 2t + (e >> 1) of accumulator slot it / 32, lane it % 32.
  constexpr int PER_W = 16 * NT8 * 32;  // items
  constexpr int ITEMS = (PER_W + NTHREADS - 1) / NTHREADS;
  const int e0 = PER_W * split / p.splits, e1 = PER_W * (split + 1) / p.splits;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (p.splits > 1) {
    cluster.sync();  // every split's sums are complete
  } else {
    __syncthreads();
  }
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
    for (int wi = 0; wi < NW; ++wi) {
      // The K splits of a column tile are one thread-block cluster (rank =
      // split): the sum over ranks, from distributed shared memory, in rank
      // order, so the result does not depend on timing.
      float* mine = red + wi * PER_W + it;
      float v[MAX_SPLITS];
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r < p.splits) v[r] = p.splits > 1 ? *cluster.map_shared_rank(mine, r) : *mine;
      }
      sum[wi] = 0.0f;
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r) {
        if (r < p.splits) sum[wi] += v[r];
      }
    }
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
  if (p.splits > 1) cluster.sync();  // no block leaves while another reads its sums
}

template <int KIND, int NT8>
cudaError_t setup_one() {
  return cudaFuncSetAttribute(o_mlp_product<KIND, NT8>,
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
  const cudaError_t err = cudaLaunchKernelEx(&cfg, o_mlp_product<KIND, NT8>, p);
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

extern "C" int fused_qkv_bf16(const void* x, const void* cos_t, const void* sins_t,
                              const void* norm_w, const void* wq, const void* sq, const void* wk,
                              const void* sk, const void* wv, const void* sv, void* q_out,
                              void* k_out, void* v_out, void* ks_out, void* vs_out, int N, int Sq,
                              int H, int Hq, int Hkv, int64_t kv_bs, int64_t sc_bs,
                              int64_t sc_hs, float eps, void* stream) {
  dim3 grid(Hq + 2 * Hkv, (N + BM - 1) / BM);
  qkv_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(cos_t),
      static_cast<const float*>(sins_t), static_cast<const __nv_bfloat16*>(norm_w),
      static_cast<const int8_t*>(wq), static_cast<const __nv_bfloat16*>(sq),
      static_cast<const int8_t*>(wk), static_cast<const __nv_bfloat16*>(sk),
      static_cast<const int8_t*>(wv), static_cast<const __nv_bfloat16*>(sv),
      static_cast<__nv_bfloat16*>(q_out), static_cast<int8_t*>(k_out),
      static_cast<int8_t*>(v_out), static_cast<__nv_bfloat16*>(ks_out),
      static_cast<__nv_bfloat16*>(vs_out), N, Sq, H, Hq, Hkv, kv_bs, sc_bs, sc_hs, eps);
  return static_cast<int>(cudaGetLastError());
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

// Raises the dynamic shared-memory limit of every #9 instance to what it
// uses; called once per device when the library is loaded.
extern "C" int fused_o_mlp_setup() {
  cudaError_t err = omlp::setup_kind<omlp::O_PROJ>();
  if (err == cudaSuccess) err = omlp::setup_kind<omlp::GATE_UP>();
  if (err == cudaSuccess) err = omlp::setup_kind<omlp::DOWN>();
  return static_cast<int>(err);
}
