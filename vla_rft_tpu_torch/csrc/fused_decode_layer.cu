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
// weights in VMEM.  Here every product is tiled over the card: one block of
// 4 warps computes a 64-row x 64-column output tile, looping over the
// contraction in 64-deep chunks.  Per chunk it converts the int8 weight
// tile to bf16 in shared memory and builds the bf16 activation tile (for a
// normalised input, (x * r) * w on the fly, with each row's r computed at
// the block's start from the whole row), and each warp multiplies its
// 16-row strip with WMMA (bf16 in, f32 accumulate).  The next chunk's
// global loads are issued into registers before the current chunk's
// products (a two-stage register pipeline).  Rows at or beyond N are zero
// and never stored.
//   * #8: one launch, a block per (head tile of D = 64 columns: the Hq q
//     heads, then the Hkv k heads, then the Hkv v heads; row tile).  Rope and
//     quantisation need only the head's own 64 lanes, so they run in the
//     block's epilogue: a warp per row, lane l owning columns l and l + 32
//     (rope partners).  k/v and their scales are written through strides,
//     so the caller can point them straight at the KV cache.
//   * #9: three launches, since the middle RMSNorm needs the whole H-wide
//     row of x1 and the down projection all I columns of m, and blocks
//     cannot pass sums to each other: A (o_proj + residual -> x1, a block
//     per 64 columns of H), B (each block recomputes its rows' r from x1,
//     gate and up for 64 columns of I -> m) and C (down + residual).
// Weights are read in place at the pointer the caller gives (a layer's
// slice of a stacked tensor or a per-layer tensor), never copied.
//
// What bounds it on an H100.  At decode widths (N = B*Sq from 1 to 896) the
// products are below the card's 295 flop/byte ridge, so device memory
// bounds them: #8 reads H*(Hq+2Hkv)*D int8 weight bytes (3.1 MB at the WM's
// H 1024, 16/16 x 64), #9 (Hq*D + 3I)*H (13.6 MB).  This simple version
// streams each block's weight columns once through shared memory with one
// chunk in flight, runs few blocks at small N (#8: 48, #9 A/C: 16) and
// re-reads weights from L2 once per 64-row tile; split-K, cp.async/TMA
// pipelines and wgmma are for a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_decode_layer.so fused_decode_layer.cu
// Interface: plain C (fused_qkv_bf16, fused_o_mlp_bf16), loaded with
// ctypes; each launches on the given stream, never synchronises, and
// returns cudaGetLastError().

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
// A: x1 = x + qdot(attn, Wo), a block per (64 columns of H, row tile).
__global__ void __launch_bounds__(NTHREADS)
o_proj_kernel(const __nv_bfloat16* __restrict__ attn, const __nv_bfloat16* __restrict__ x,
              const int8_t* __restrict__ wo, const __nv_bfloat16* __restrict__ so,
              __nv_bfloat16* __restrict__ x1, int N, int HqD, int H) {
  __shared__ __align__(128) unsigned char smem[TILE_BYTES];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float* c_s = reinterpret_cast<float*>(smem);
  gemm_tile<false>(smem, c_s, nullptr, attn, HqD, m0, N, HqD, wo, nullptr, H, n0, nullptr,
                   nullptr);
  for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
    const int row = idx / BN, col = idx % BN, n = m0 + row;
    if (n >= N) break;
    const int64_t o = (int64_t)n * H + n0 + col;
    const float h = qscale(c_s[row * LDC + col], so[n0 + col]);
    x1[o] = __float2bfloat16(__fadd_rn(__bfloat162float(x[o]), h));
  }
}

// B: m = (g * bf16(sigmoid(g))) * u with g, u = qdot(rmsnorm(x1), Wg / Wu),
// a block per (64 columns of I, row tile).
__global__ void __launch_bounds__(NTHREADS)
gate_up_kernel(const __nv_bfloat16* __restrict__ x1, const __nv_bfloat16* __restrict__ norm_w,
               const int8_t* __restrict__ wg, const __nv_bfloat16* __restrict__ sg,
               const int8_t* __restrict__ wu, const __nv_bfloat16* __restrict__ su,
               __nv_bfloat16* __restrict__ m_out, int N, int H, int I, float eps) {
  __shared__ __align__(128) unsigned char smem[TILE_BYTES];
  __shared__ float rms_s[BM];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  row_rms(rms_s, x1, H, m0, N, H, eps);
  __syncthreads();
  float* cg = reinterpret_cast<float*>(smem);
  float* cu = reinterpret_cast<float*>(smem + C_BYTES);
  gemm_tile<true>(smem, cg, cu, x1, H, m0, N, H, wg, wu, I, n0, rms_s, norm_w);
  for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
    const int row = idx / BN, col = idx % BN, n = m0 + row;
    if (n >= N) break;
    const float g = qscale(cg[row * LDC + col], sg[n0 + col]);
    const float u = qscale(cu[row * LDC + col], su[n0 + col]);
    const float sig = bf16r(__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-g))));
    m_out[(int64_t)n * I + n0 + col] = __float2bfloat16(__fmul_rn(bf16r(__fmul_rn(g, sig)), u));
  }
}

// C: out = x1 + qdot(m, Wd), a block per (64 columns of H, row tile).
__global__ void __launch_bounds__(NTHREADS)
down_kernel(const __nv_bfloat16* __restrict__ m, const __nv_bfloat16* __restrict__ x1,
            const int8_t* __restrict__ wd, const __nv_bfloat16* __restrict__ sd,
            __nv_bfloat16* __restrict__ out, int N, int I, int H) {
  __shared__ __align__(128) unsigned char smem[TILE_BYTES];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float* c_s = reinterpret_cast<float*>(smem);
  gemm_tile<false>(smem, c_s, nullptr, m, I, m0, N, I, wd, nullptr, H, n0, nullptr, nullptr);
  for (int idx = threadIdx.x; idx < BM * BN; idx += NTHREADS) {
    const int row = idx / BN, col = idx % BN, n = m0 + row;
    if (n >= N) break;
    const int64_t o = (int64_t)n * H + n0 + col;
    const float d = qscale(c_s[row * LDC + col], sd[n0 + col]);
    out[o] = __float2bfloat16(__fadd_rn(__bfloat162float(x1[o]), d));
  }
}

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

// The three launches of #9 on one stream; x1 (N, H) and m (N, I) are the
// caller's scratch.  Returns the first launch error.
extern "C" int fused_o_mlp_bf16(const void* attn, const void* x, const void* wo, const void* so,
                                const void* norm_w, const void* wg, const void* sg,
                                const void* wu, const void* su, const void* wd, const void* sd,
                                void* x1, void* m, void* out, int N, int HqD, int H, int I,
                                float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = (N + BM - 1) / BM;
  o_proj_kernel<<<dim3(H / BN, rows), NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(attn), static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(wo), static_cast<const __nv_bfloat16*>(so),
      static_cast<__nv_bfloat16*>(x1), N, HqD, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gate_up_kernel<<<dim3(I / BN, rows), NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x1), static_cast<const __nv_bfloat16*>(norm_w),
      static_cast<const int8_t*>(wg), static_cast<const __nv_bfloat16*>(sg),
      static_cast<const int8_t*>(wu), static_cast<const __nv_bfloat16*>(su),
      static_cast<__nv_bfloat16*>(m), N, H, I, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  down_kernel<<<dim3(H / BN, rows), NTHREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(m), static_cast<const __nv_bfloat16*>(x1),
      static_cast<const int8_t*>(wd), static_cast<const __nv_bfloat16*>(sd),
      static_cast<__nv_bfloat16*>(out), N, I, H);
  return static_cast<int>(cudaGetLastError());
}
