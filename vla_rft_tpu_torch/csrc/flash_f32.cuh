// Flash attention in f32 for Hopper (sm_90a): the forward (#1) and the
// backward's dQ (#2) and dK/dV (#3) for f32 q/k/v/O/dO at head dims 32 and
// 64.  Included by flash_fwd.cu (the forward's entry point flash_fwd_f32)
// and flash_bwd.cu (flash_bwd_dq_f32, flash_bwd_dkv_f32).
//
// Replaces, for f32 inputs, the same TPU kernels as the bf16 instances in
// those files: vla_rft_tpu/ops/attention.py::_fwd_kernel, ::_dq_kernel and
// ::_dkv_kernel.  The Pallas bodies are dtype-generic: they compute in f32
// and write o_ref.dtype, so an f32 instance computes what the TPU kernel
// computes for the push preset's f32 models (a 4 / 2-head policy LLM of
// head dim 32, a 2-head world model of head dim 64).  Same function as the
// bf16 kernels:
//   * q/o/dO (B, Sq, Hq, D), k/v (B, Sk, Hkv, D), lse/delta (B, Sq, Hq), all
//     f32 and contiguous; GQA maps query head h to kv head h / (Hq / Hkv);
//   * key j of row b is valid for query i when kv_starts[b] <= j < kv_lens[b]
//     and, when causal, j <= q_offset[b] + i;
//   * forward: f32 online softmax with bounded exp (exp(max(x, -80))),
//     masked lanes exactly 0, a fully-masked row gives O = 0 and
//     LSE = -1e30;
//   * backward: p = exp(max(s - lse, -80)) on valid lanes and 0 elsewhere,
//     dS = p (dP - delta) scale, dQ = dS K, dV = p^T dO and dK = dS^T Q
//     summed over the G query heads of the kv group, delta = sum_D dO * O
//     from the f32 O (the wrapper's torch reduction).
//
// Design: simple and exact before fast.  Every product is an f32 FFMA on
// the CUDA cores (no TF32, no tensor cores), every sum is kept in f32, and
// P stays f32, so the kernels meet their f32 plain twins to rounding (the
// sums run in another order).  A block of 128 threads owns 32 query rows
// (#1, #2) or 32 keys (#3); four neighbouring threads share a row, each
// taking every fourth key (or query) of a 32-wide tile for the scores and
// every fourth column of the row's D outputs.  Tiles of 32 keys (or
// queries) are staged in static shared memory with rows padded to D + 1
// floats, so the strided reads of a warp fall in distinct banks; the
// quad's row statistics meet by two shuffles.  A loop inside the block
// walks the tiles that can hold a valid key (the causal diagonal and the
// kv_starts / kv_lens window bound it); no atomics, so every run gives the
// same bits.
//
// What bounds it on an H100: the FFMA rate.  4 D f32 operations per (query,
// key) pair forward and 10 D backward, against 67 TFLOP/s of f32 outside
// the tensor cores, and each score needs two shared-memory loads per FFMA
// here, so these kernels sit far below even that; the push shapes are small
// (the WM's 16 x 271 tokens at 2 heads of 64, the policy's 8 x 96 at 4 of
// 32), and their time is in PERF.md section 6, beside the bound
// chip_smoke.py computes.
//
// Interface: the entry points launch on the given stream, never
// synchronise, and return cudaGetLastError().

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_f32 {

constexpr int NT = 128;  // threads of a block: 32 rows x 4
constexpr int BQ = 32;   // query rows of a tile
constexpr int BK = 32;   // keys of a tile
constexpr float NEG_INF = -1e30f;
constexpr float FLOOR = -80.0f;

struct Rows {
  int kv_start, kv_len, q_off;
};

__device__ __forceinline__ Rows rows_of(const int* kv_lens, const int* q_offset,
                                        const int* kv_starts, int b, int Sk) {
  return {max(kv_starts[b], 0), min(kv_lens[b], Sk), q_offset[b]};
}

__device__ __forceinline__ bool valid(const Rows& r, int qpos, int kp, int causal) {
  return kp >= r.kv_start && kp < r.kv_len && (!causal || qpos >= kp);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// n rows of D floats (global row stride `gstride`) into a padded tile;
// rows at or beyond `avail` read as 0.
template <int D>
__device__ __forceinline__ void stage(float (*dst)[D + 1], const float* src, int64_t gstride,
                                      int n, int avail) {
  for (int idx = threadIdx.x; idx < n * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    dst[r][d] = r < avail ? src[r * gstride + d] : 0.0f;
  }
}

template <int D>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// Key tiles [t_begin, t_end) that can hold a valid key for queries
// q0 .. q0 + nq - 1 of a row.
__device__ __forceinline__ void key_tiles(const Rows& r, int q0, int nq, int causal,
                                          int* t_begin, int* t_end) {
  *t_begin = r.kv_start / BK;
  int end = (r.kv_len + BK - 1) / BK;
  if (causal) {
    const int last_q = r.q_off + q0 + nq - 1;
    end = min(end, last_q < 0 ? 0 : last_q / BK + 1);
  }
  *t_end = end;
}

// grid (B * Hq, ceil(Sq / BQ)).
template <int D>
__global__ void __launch_bounds__(NT)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, float* __restrict__ lse, const int* __restrict__ kv_lens,
           const int* __restrict__ q_offset, const int* __restrict__ kv_starts, int Sq, int Sk,
           int Hq, int Hkv, float scale, int causal) {
  constexpr int CW = D / 4;  // output columns of a thread
  __shared__ float qs[BQ][D + 1], ks[BK][D + 1], vs[BK][D + 1];
  __shared__ float ps[BQ][BK + 1];
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * BQ, nq = min(BQ, Sq - q0);
  const int row = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const Rows rw = rows_of(kv_lens, q_offset, kv_starts, b, Sk);
  const int qi = q0 + row, qpos = rw.q_off + qi;
  const bool live = qi < Sq;

  stage<D>(qs, q + (((int64_t)b * Sq + q0) * Hq + h) * D, (int64_t)Hq * D, BQ, nq);
  const int64_t kv_stride = (int64_t)Hkv * D;
  const float* k_base = k + ((int64_t)b * Sk * Hkv + hk) * D;
  const float* v_base = v + ((int64_t)b * Sk * Hkv + hk) * D;

  float acc[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) acc[c] = 0.0f;
  float m = NEG_INF, l = 0.0f;
  int t_begin, t_end;
  key_tiles(rw, q0, nq, causal, &t_begin, &t_end);
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile is done with
    stage<D>(ks, k_base + k0 * kv_stride, kv_stride, BK, Sk - k0);
    stage<D>(vs, v_base + k0 * kv_stride, kv_stride, BK, Sk - k0);
    __syncthreads();
    float s[BK / 4];
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int j = sub + 4 * i;
      const bool ok = live && valid(rw, qpos, k0 + j, causal);
      s[i] = ok ? dot<D>(qs[row], ks[j]) * scale : NEG_INF;
      mx = fmaxf(mx, s[i]);
    }
    const float m_new = fmaxf(m, quad_max(mx));
    const float alpha = expf(fmaxf(m - m_new, FLOOR));
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const float p = s[i] == NEG_INF ? 0.0f : expf(fmaxf(s[i] - m_new, FLOOR));
      ps[row][sub + 4 * i] = p;
      l += p;
    }
    __syncwarp();  // the quad's p of this row (one warp holds 8 whole rows)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[c] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = ps[row][j];
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[c] = fmaf(p, vs[j][sub + 4 * c], acc[c]);
    }
  }
  l = quad_sum(l);
  if (!live) return;
  float* orow = o + (((int64_t)b * Sq + qi) * Hq + h) * D;
#pragma unroll
  for (int c = 0; c < CW; ++c) orow[sub + 4 * c] = l == 0.0f ? 0.0f : acc[c] / l;
  if (sub == 0) lse[((int64_t)b * Sq + qi) * Hq + h] = l == 0.0f ? NEG_INF : m + logf(l);
}

// grid (B * Hq, ceil(Sq / BQ)).
template <int D>
__global__ void __launch_bounds__(NT)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq,
          const int* __restrict__ kv_lens, const int* __restrict__ q_offset,
          const int* __restrict__ kv_starts, int Sq, int Sk, int Hq, int Hkv, float scale,
          int causal) {
  constexpr int CW = D / 4;
  __shared__ float qs[BQ][D + 1], dos[BQ][D + 1], ks[BK][D + 1], vs[BK][D + 1];
  __shared__ float dss[BQ][BK + 1];
  const int h = blockIdx.x % Hq, b = blockIdx.x / Hq, hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * BQ, nq = min(BQ, Sq - q0);
  const int row = threadIdx.x >> 2, sub = threadIdx.x & 3;
  const Rows rw = rows_of(kv_lens, q_offset, kv_starts, b, Sk);
  const int qi = q0 + row, qpos = rw.q_off + qi;
  const bool live = qi < Sq;
  const int64_t q_row = ((int64_t)b * Sq + q0) * Hq + h;
  stage<D>(qs, q + q_row * D, (int64_t)Hq * D, BQ, nq);
  stage<D>(dos, dout + q_row * D, (int64_t)Hq * D, BQ, nq);
  const float lse_r = live ? lse[q_row + (int64_t)row * Hq] : 0.0f;
  const float delta_r = live ? delta[q_row + (int64_t)row * Hq] : 0.0f;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const float* k_base = k + ((int64_t)b * Sk * Hkv + hk) * D;
  const float* v_base = v + ((int64_t)b * Sk * Hkv + hk) * D;

  float acc[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) acc[c] = 0.0f;
  int t_begin, t_end;
  key_tiles(rw, q0, nq, causal, &t_begin, &t_end);
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    stage<D>(ks, k_base + k0 * kv_stride, kv_stride, BK, Sk - k0);
    stage<D>(vs, v_base + k0 * kv_stride, kv_stride, BK, Sk - k0);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      const int j = sub + 4 * i;
      float ds = 0.0f;
      if (live && valid(rw, qpos, k0 + j, causal)) {
        const float p = expf(fmaxf(dot<D>(qs[row], ks[j]) * scale - lse_r, FLOOR));
        ds = p * (dot<D>(dos[row], vs[j]) - delta_r) * scale;
      }
      dss[row][j] = ds;
    }
    __syncwarp();
    for (int j = 0; j < BK; ++j) {
      const float ds = dss[row][j];
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[c] = fmaf(ds, ks[j][sub + 4 * c], acc[c]);
    }
  }
  if (!live) return;
  float* out = dq + (q_row + (int64_t)row * Hq) * D;
#pragma unroll
  for (int c = 0; c < CW; ++c) out[sub + 4 * c] = acc[c];
}

// grid (B * Hkv, ceil(Sk / BK)): one block per tile of 32 keys, walking the
// G query heads of its kv group and their query tiles in order.
template <int D>
__global__ void __launch_bounds__(NT)
dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
           const int* __restrict__ kv_lens, const int* __restrict__ q_offset,
           const int* __restrict__ kv_starts, int Sq, int Sk, int Hq, int Hkv, float scale,
           int causal) {
  constexpr int CW = D / 4;
  __shared__ float qs[BQ][D + 1], dos[BQ][D + 1], ks[BK][D + 1], vs[BK][D + 1];
  __shared__ float pt[BK][BQ + 1], dst[BK][BQ + 1];
  __shared__ float lse_s[BQ], delta_s[BQ];
  const int hk = blockIdx.x % Hkv, b = blockIdx.x / Hkv, G = Hq / Hkv;
  const int k0 = blockIdx.y * BK;
  const int jr = threadIdx.x >> 2, sub = threadIdx.x & 3;  // this thread's key and quarter
  const Rows rw = rows_of(kv_lens, q_offset, kv_starts, b, Sk);
  const int kp = k0 + jr;
  const int64_t kv_stride = (int64_t)Hkv * D;
  stage<D>(ks, k + ((int64_t)b * Sk * Hkv + hk) * D + k0 * kv_stride, kv_stride, BK, Sk - k0);
  stage<D>(vs, v + ((int64_t)b * Sk * Hkv + hk) * D + k0 * kv_stride, kv_stride, BK, Sk - k0);

  float adk[CW], adv[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c) adk[c] = adv[c] = 0.0f;
  // the tile holds a valid key at all (else dK = dV = 0)
  const bool any = k0 < rw.kv_len && k0 + BK > rw.kv_start;
  for (int g = 0; any && g < G; ++g) {
    const int h = hk * G + g;
    for (int q0 = 0; q0 < Sq; q0 += BQ) {
      const int nq = min(BQ, Sq - q0);
      // no query of the tile reaches the tile's first key (causal)
      if (causal && rw.q_off + q0 + nq - 1 < k0) continue;
      const int64_t q_row = ((int64_t)b * Sq + q0) * Hq + h;
      __syncthreads();
      stage<D>(qs, q + q_row * D, (int64_t)Hq * D, BQ, nq);
      stage<D>(dos, dout + q_row * D, (int64_t)Hq * D, BQ, nq);
      if (threadIdx.x < BQ) {
        const bool ok = threadIdx.x < nq;
        lse_s[threadIdx.x] = ok ? lse[q_row + (int64_t)threadIdx.x * Hq] : 0.0f;
        delta_s[threadIdx.x] = ok ? delta[q_row + (int64_t)threadIdx.x * Hq] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < BQ / 4; ++i) {
        const int ii = sub + 4 * i;
        float p = 0.0f, ds = 0.0f;
        if (ii < nq && valid(rw, rw.q_off + q0 + ii, kp, causal)) {
          p = expf(fmaxf(dot<D>(qs[ii], ks[jr]) * scale - lse_s[ii], FLOOR));
          ds = p * (dot<D>(dos[ii], vs[jr]) - delta_s[ii]) * scale;
        }
        pt[jr][ii] = p;
        dst[jr][ii] = ds;
      }
      __syncwarp();
      for (int ii = 0; ii < BQ; ++ii) {
        const float p = pt[jr][ii], ds = dst[jr][ii];
#pragma unroll
        for (int c = 0; c < CW; ++c) {
          adv[c] = fmaf(p, dos[ii][sub + 4 * c], adv[c]);
          adk[c] = fmaf(ds, qs[ii][sub + 4 * c], adk[c]);
        }
      }
    }
  }
  if (kp >= Sk) return;
  const int64_t off = (((int64_t)b * Sk + kp) * Hkv + hk) * D;
#pragma unroll
  for (int c = 0; c < CW; ++c) {
    dk[off + sub + 4 * c] = adk[c];
    dv[off + sub + 4 * c] = adv[c];
  }
}

// The launches behind the C entry points: D 32 or 64, else
// cudaErrorInvalidValue.
template <int D>
cudaError_t fwd_d(const void* q, const void* k, const void* v, void* o, void* lse,
                  const void* kv_lens, const void* q_offset, const void* kv_starts, int B,
                  int Sq, int Sk, int Hq, int Hkv, float scale, int causal, cudaStream_t s) {
  fwd_kernel<D><<<dim3(B * Hq, (Sq + BQ - 1) / BQ), NT, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), static_cast<float*>(lse), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_starts), Sq, Sk, Hq, Hkv,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dq_d(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, void* dq, const void* kv_lens, const void* q_offset,
                 const void* kv_starts, int B, int Sq, int Sk, int Hq, int Hkv, float scale,
                 int causal, cudaStream_t s) {
  dq_kernel<D><<<dim3(B * Hq, (Sq + BQ - 1) / BQ), NT, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_starts), Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t dkv_d(const void* q, const void* k, const void* v, const void* dout,
                  const void* lse, const void* delta, void* dk, void* dv, const void* kv_lens,
                  const void* q_offset, const void* kv_starts, int B, int Sq, int Sk, int Hq,
                  int Hkv, float scale, int causal, cudaStream_t s) {
  dkv_kernel<D><<<dim3(B * Hkv, (Sk + BK - 1) / BK), NT, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_starts), Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

}  // namespace flash_f32
