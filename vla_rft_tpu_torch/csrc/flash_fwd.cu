// Flash-attention forward for Hopper (sm_90a), bf16 in / bf16 O + f32 LSE out.
//
// Replaces the TPU kernel vla_rft_tpu/ops/attention.py::_fwd_kernel (the
// Pallas flash forward behind `attention(impl="pallas")`).  Same function:
//   * q (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), all contiguous; GQA maps query
//     head h to kv head h / (Hq / Hkv);
//   * key j of row b is valid when kv_starts[b] <= j < kv_lens[b] (left and
//     right padding) and, when causal, j <= q_offset[b] + i for query i;
//   * f32 online softmax with bounded exp (exp(max(x, -80))), masked lanes
//     contribute exactly 0, and a fully-masked row gives O = 0 and
//     LSE = -1e30.
//
// Design (FlashAttention-2 on mma.sync).  One block of 4 warps per (query
// head, batch row, tile of 64 queries): at the WM prefill 544 blocks, three
// resident per SM.  The TPU kernel walks key blocks on its sequential grid
// axis with K/V resident in VMEM; here a loop inside the block walks 64-key
// tiles, double-buffered in shared memory by 16-byte cp.async.cg (tile t + 1
// is in flight during tile t's products), with Q staged once.  Shared memory
// rows are XOR-swizzled in 16-byte chunks (chunk ^ row % 8), so ldmatrix
// reads and cp.async writes are free of bank conflicts.  Each warp owns 16
// query rows end to end, in registers:
//   S = Q K^T   mma.sync m16n8k16 (bf16 in, f32 accumulate), A from
//               ldmatrix on Q, B from ldmatrix on K;
//   softmax     on the S accumulators: a thread holds two rows, the row max
//               takes two quad shuffles, the running sum l stays a
//               per-thread partial until the end (one quad sum then); the
//               max is kept in log2 units, so each score costs one FFMA
//               and one EX2 (exp(max(x, -80)) as 2^max(x log2 e, -80
//               log2 e), 2 ulp);
//   O += P V    P rounded to bf16 in registers and reused directly as the A
//               operand (the S accumulator layout is the A fragment
//               layout), V through ldmatrix.trans; O (16 x D per warp)
//               never leaves registers until the epilogue.
// Only tiles that cut a kv_starts / kv_lens edge or the causal diagonal of
// the warp's rows apply a per-element mask; interior tiles run unmasked,
// and tiles wholly above a warp's diagonal are skipped by that warp (their
// contribution is exactly zero).  Under causal masking the query tiles run
// heavy first (the tile index is the slowest grid axis, reversed).  The
// dynamic shared-memory limit of every instance is raised once per device
// (flash_fwd_setup), not on each launch.
//
// What bounds it on an H100.  At the serving shape (B = 1, S = 352, Hq = 14,
// Hkv = 2, D = 64, causal) the work is about 4 * B * Hq * Sq * Sk * D / 2
// FLOPs against (B * S * (Hq + 2 * Hkv) * D + B * Sq * Hq * (D + 2)) * 2
// bytes: device memory sets the bound (under a microsecond), and what sets
// the time is latency, 84 blocks each walking up to 6 key tiles in order.
// At the WM prefill (B = 2, 1088 queries and keys, 16/16 heads) it is 4.85
// GFLOP for 8.9 MB, about 550 FLOPs per byte, so the tensor cores bound it
// (4.9 us at 989 TFLOP/s); mma.sync reaches a fraction of the wgmma rate.
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W (PERF.md): 0.010
// ms at serving, 0.041 ms at the WM prefill (118 TFLOP/s).  Variants that measured no
// faster there: 128-query tiles (8 warps, or 4 warps of two m16 tiles
// sharing each K/V fragment) and 3- and 4-deep K/V rings; a second group of
// 4 warps taking every other key tile gained 2-3 % at the serving shape,
// too little for its merge.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu
// Interface: plain C (flash_fwd_setup, flash_fwd_bf16, flash_fwd_f32),
// loaded with ctypes; the launches run on the given stream, never
// synchronise, and return cudaGetLastError().  flash_fwd_f32 is the f32
// instance at D 32 / 64 (csrc/flash_f32.cuh, for the push preset's f32
// models).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_f32.cuh"
#include "mma_sm90.cuh"

namespace {

constexpr int BK = 64;  // keys per tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float EXP2_FLOOR = -80.0f * LOG2E;  // exp(max(x, -80)) = 2^max(x log2 e, -80 log2 e)

constexpr int NWARPS = 4;
constexpr int NTHREADS = 32 * NWARPS;

constexpr int BQ = 16 * NWARPS;  // query rows of a block, 16 per warp

template <int D>
struct Cfg {
  static constexpr int ROW = D * 2;          // bytes of a row of Q, K or V
  static constexpr int Q_BYTES = BQ * ROW;
  static constexpr int KV_BYTES = BK * ROW;  // one K or V tile
  static constexpr int BYTES = Q_BYTES + 2 * 2 * KV_BYTES;  // Q, 2 stages of (K, V)
};

// `rows` rows of D bf16 (global row stride `gstride` elements) into a
// swizzled shared tile by cp.async; rows at or beyond `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src, int64_t gstride,
                                          int rows, int valid) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < rows * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < valid;
    cp_async16(dst + swz(r, c, D * 2), ok ? src + r * gstride + c * 8 : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_lens,
                 const int* __restrict__ q_offset, const int* __restrict__ kv_starts,
                 int Sq, int Sk, int Hq, int Hkv, float scale, int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t kv_s = q_s + C::Q_BYTES;  // stage s: K at + 2s * KV_BYTES, V after it

  const int bh = blockIdx.x;
  const int h = bh % Hq, b = bh / Hq;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heavy (late) query tiles first
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;

  const int kv_len = min(kv_lens[b], Sk);
  const int kv_start = max(kv_starts[b], 0);
  const int q_off = q_offset[b];
  const int q_rows = min(BQ, Sq - q0);

  // Key tiles that can hold a valid key for some row of this block.
  const int t_begin = kv_start / BK;
  int t_end = (kv_len + BK - 1) / BK;
  if (causal) {
    const int last_q = q_off + q0 + q_rows - 1;  // largest query position
    t_end = min(t_end, last_q < 0 ? 0 : last_q / BK + 1);
  }

  const int64_t kv_stride = (int64_t)Hkv * D;
  const __nv_bfloat16* k_base = k + ((int64_t)b * Sk * Hkv + hk) * D;
  const __nv_bfloat16* v_base = v + ((int64_t)b * Sk * Hkv + hk) * D;
  auto load_kv = [&](int t, int stage) {
    const int k0 = t * BK;
    const uint32_t st = kv_s + stage * 2 * C::KV_BYTES;
    load_rows<D>(st, k_base + k0 * kv_stride, kv_stride, BK, Sk - k0);
    load_rows<D>(st + C::KV_BYTES, v_base + k0 * kv_stride, kv_stride, BK, Sk - k0);
  };
  load_rows<D>(q_s, q + (((int64_t)b * Sq + q0) * Hq + h) * D, (int64_t)Hq * D, BQ, q_rows);
  if (t_begin < t_end) load_kv(t_begin, 0);
  cp_async_commit();

  // This warp's rows: r0 .. r0 + 15 of the tile; a thread holds rows g, g + 8.
  const int r0 = warp * 16;
  const int qpos0 = q_off + q0 + r0;  // position of the warp's first row
  const bool warp_live = r0 < q_rows;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m_run[2] = {NEG_INF, NEG_INF};  // row max, times scale * log2(e)
  float l_run[2] = {0.0f, 0.0f};       // this thread's partial row sums
  const float scale_log2 = scale * LOG2E;

  // ldmatrix addressing (lane's row and chunk within a 16 x 16 block).
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // A: Q rows; V^T: keys
  const int lchunk = lane >> 4;
  const int krow = (lane & 7) + (lane >> 4) * 8;        // K: keys of two n8 tiles
  const int kchunk = (lane >> 3) & 1;

  for (int t = t_begin; t < t_end; ++t) {
    const int stage = (t - t_begin) & 1;
    cp_async_wait<0>();  // tile t has landed
    __syncthreads();     // ... for every thread, and every warp is done with tile t - 1
    // tile t + 1 flies during this tile's products, into tile t - 1's stage
    if (t + 1 < t_end) load_kv(t + 1, stage ^ 1);
    cp_async_commit();

    const int k0 = t * BK;
    // a warp whose rows all precede the tile's first key (causal) or that
    // holds no query row gets exactly nothing from it
    if (warp_live && !(causal && k0 > qpos0 + 15)) {
      const uint32_t k_s = kv_s + stage * 2 * C::KV_BYTES;
      const uint32_t v_s = k_s + C::KV_BYTES;

      float s[BK / 8][4];  // S = Q K^T
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, q_s + swz(r0 + lrow, 2 * kk + lchunk, C::ROW));
#pragma unroll
        for (int jp = 0; jp < BK / 16; ++jp) {
          uint32_t kb[4];
          ldsm_x4(kb, k_s + swz(16 * jp + krow, 2 * kk + kchunk, C::ROW));
          mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
          mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
        }
      }

      // Mask (edge tiles only) and the tile's row max, on the raw scores.
      const bool edge = k0 < kv_start || k0 + BK > kv_len || (causal && k0 + BK - 1 > qpos0);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (edge) {
            const int kp = k0 + 8 * j + 2 * qd + (e & 1);
            const int qp = qpos0 + g + 8 * (e >> 1);
            const bool ok = kp >= kv_start && kp < kv_len && (!causal || qp >= kp);
            s[j][e] = ok ? s[j][e] : NEG_INF;
          }
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      // The running max m2 is kept as scale * log2(e) * max(s), so that
      // exp(max(scale s - m, -80)) is one FFMA and one EX2 per score.
      float alpha[2], neg_m2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r] == NEG_INF ? NEG_INF : mx[r] * scale_log2);
        alpha[r] = exp2_approx(fmaxf(m_run[r] - m_new, EXP2_FLOOR));
        m_run[r] = m_new;
        neg_m2[r] = -m_new;
        l_run[r] *= alpha[r];
      }
      // p = exp(max(s scale - m, -80)) on valid lanes, exactly 0 on masked
      // ones (a masked lane holds -1e30, which only a masked lane can).
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float x = s[j][e];
          const float p = (edge && x == NEG_INF)
                              ? 0.0f
                              : exp2_approx(fmaxf(fmaf(x, scale_log2, neg_m2[r]), EXP2_FLOOR));
          s[j][e] = p;
          l_run[r] += p;
        }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];

      // O += P V: the S accumulators of key tiles 2u, 2u + 1 are the A
      // fragment of the k16 step u.
#pragma unroll
      for (int u = 0; u < BK / 16; ++u) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * u][0], s[2 * u][1]);
        pa[1] = pack_bf16(s[2 * u][2], s[2 * u][3]);
        pa[2] = pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]);
        pa[3] = pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3]);
#pragma unroll
        for (int jd = 0; jd < D / 16; ++jd) {
          uint32_t vb[4];
          ldsm_x4_t(vb, v_s + swz(16 * u + lrow, 2 * jd + lchunk, C::ROW));
          mma_bf16(acc[2 * jd], pa, vb[0], vb[1]);
          mma_bf16(acc[2 * jd + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: O = acc / l (0 for a fully-masked row), LSE = m + log l.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qi = q0 + r0 + g + 8 * r;
    if (qi >= Sq) continue;
    const float inv = l == 0.0f ? 0.0f : 1.0f / l;
    __nv_bfloat16* orow = o + (((int64_t)b * Sq + qi) * Hq + h) * D + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
    if (qd == 0) {
      lse[((int64_t)b * Sq + qi) * Hq + h] = l == 0.0f ? NEG_INF : m_run[r] * LN2 + logf(l);
    }
  }
}

template <int D>
cudaError_t setup_one() {
  return cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Cfg<D>::BYTES);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   const void* kv_lens, const void* q_offset, const void* kv_starts, int B,
                   int Sq, int Sk, int Hq, int Hkv, float scale, int causal, cudaStream_t stream) {
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NTHREADS, Cfg<D>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_starts), Sq, Sk, Hq, Hkv,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

// Raises the dynamic shared-memory limit of both instances to what they
// use; called once per device when the library is loaded.
extern "C" int flash_fwd_setup() {
  cudaError_t err = setup_one<64>();
  if (err == cudaSuccess) err = setup_one<128>();
  return static_cast<int>(err);
}

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* kv_lens, const void* q_offset, const void* kv_starts,
                              int B, int Sq, int Sk, int Hq, int Hkv, int D, float scale,
                              int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64) {
    err = launch<64>(q, k, v, o, lse, kv_lens, q_offset, kv_starts, B, Sq, Sk, Hq, Hkv, scale,
                     causal, s);
  } else if (D == 128) {
    err = launch<128>(q, k, v, o, lse, kv_lens, q_offset, kv_starts, B, Sq, Sk, Hq, Hkv, scale,
                      causal, s);
  }
  return static_cast<int>(err);
}

// The f32 instance (csrc/flash_f32.cuh): f32 q/k/v -> f32 O and LSE, D 32 or 64.
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* o, void* lse,
                             const void* kv_lens, const void* q_offset, const void* kv_starts,
                             int B, int Sq, int Sk, int Hq, int Hkv, int D, float scale,
                             int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 32) {
    err = flash_f32::fwd_d<32>(q, k, v, o, lse, kv_lens, q_offset, kv_starts, B, Sq, Sk, Hq,
                               Hkv, scale, causal, s);
  } else if (D == 64) {
    err = flash_f32::fwd_d<64>(q, k, v, o, lse, kv_lens, q_offset, kv_starts, B, Sq, Sk, Hq,
                               Hkv, scale, causal, s);
  }
  return static_cast<int>(err);
}
