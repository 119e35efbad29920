// Split-cache decode attention for Hopper (sm_90a): small query blocks
// (Sq <= 8) against int8 or bf16 K/V, in either KV-cache layout.  Included
// by decode_hd.cu (the head-dense layout, kernels #4 / #5) and
// decode_heads.cu (the head-blocked layout, kernels #6 / #7); each of those
// files is one library with its own C entry point.
//
// The function computed is the reference's XLA fallback
// (vla_rft_tpu/models/transformer.py:503-545 and :569-596), not the Pallas
// kernels' int8 requantisation of q and p (a TPU trick):
//   * K/V come from one layer's slice of the cache, int8 or bf16; an int8
//     value is dequantised with its bf16 per-(position, head) scale (scales
//     laid out (rows, Hkv, S) in both layouts) and rounded to bf16, as the
//     fallback does before attending;
//   * the keys of row b are the shared positions [0, shared_len) of prefix
//     row prefix_map[b] followed by the row's own positions, own position j
//     at absolute position shared_len + j (shared_len = 0 without SHARED);
//   * key p is valid for query i when kv_starts[b] <= p < kv_lens[b] and
//     p <= q_offset[b] + i (causal, q_offset = the cache index);
//   * f32 scores and online softmax with bounded exp (exp(max(x, -80))),
//     masked keys contribute exactly 0, a row with no valid key gives 0.
// q is (B, Sq, Hq, D) bf16 with GQA group G = Hq / Hkv; O is written in the
// same layout, bf16.  D = 64.
//
// Layouts (HEADS template flag), one layer's slice:
//   * HEADS = false, "hd":    (rows, S, Hkv*D): position stride Hkv*D, head
//     stride D;
//   * HEADS = true,  "heads": (rows, Hkv, S, D): position stride D, head
//     stride S*D.  The 64 values of one (position, head) are contiguous in
//     both, so the loads below are the same; only the offsets differ.
//
// Design.  One block of 4 warps per (row b, kv head h).  The block stages
// the G*Sq query rows of that head in shared memory (f32, pre-scaled).  The
// valid key range is computed per row from the window and the causal limit,
// so masked tiles are never read.  Warps take 32-key tiles in turn; in a
// tile each lane owns one key: it loads the key's 64 K values into
// registers (4 x 16-byte loads for int8) and its V values into the warp's
// shared V tile, dequantising both.  Each query row's scores are one
// 64-long dot per lane, the running max and sum are warp shuffles, and
// P.V accumulates in the warp's shared (m, l, acc) state, each lane owning
// two output columns.  At the end the block merges its four warps' states.
//
// What bounds it on an H100.  Decode reads every valid K/V byte once and
// does 4*D flops per (query, key): at the WM shape (G*Sq <= 7 query rows per
// head) that is under 1 flop per byte, so device-memory traffic sets the
// bound: 2*1024*(B_u*Sp + sum own_len) int8 bytes plus their scales per
// layer, about 2.8 us at mid-rollout (B = 10, B_u = 2).  This simple version
// issues one dependent load chain per lane with no prefetch and runs 16*B
// blocks; split-K over key ranges, cp.async/TMA pipelining and tensor-core
// products are for a later change.  In the heads layout a warp's 32 keys
// are one contiguous run of 32 * 64 values, in the hd layout 32 runs of 64.
//
// Interface: decode_attend::run<HEADS> launches on the given stream, never
// synchronises, and returns cudaGetLastError().

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_attend {

constexpr int D = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TK = 32;          // keys per warp tile, one per lane
constexpr int LDV = D + 1;      // padded row stride of the V tile (floats)
constexpr int MAX_NQ = 64;      // G * Sq query rows per block
constexpr float NEG_INF = -1e30f;
constexpr float EXP_FLOOR = -80.0f;

struct Args {
  const __nv_bfloat16* q;       // (B, Sq, Hq, D)
  __nv_bfloat16* o;             // (B, Sq, Hq, D)
  const void* k_own;            // (B, Sr, Hkv*D) or (B, Hkv, Sr, D), int8 or bf16
  const void* v_own;
  const __nv_bfloat16* ks_own;  // (B, Hkv, Sr) scales, int8 cache only
  const __nv_bfloat16* vs_own;
  const void* k_sh;             // (B_u, Sp, Hkv*D) or (B_u, Hkv, Sp, D), SHARED only
  const void* v_sh;
  const __nv_bfloat16* ks_sh;   // (B_u, Hkv, Sp)
  const __nv_bfloat16* vs_sh;
  const int* prefix_map;        // (B,) row -> shared row
  const int* kv_lens;           // (B,) absolute end of the valid keys
  const int* q_offset;          // (B,) absolute position of query 0
  const int* kv_starts;         // (B,) absolute start of the valid keys
  int Sq, Hq, Hkv, Sr, Sp, shared_len;
  float scale;
};

// floats of dynamic shared memory: q, then per warp V tile, P, acc, m, l, alpha
__host__ __device__ constexpr int warp_floats(int nq) { return TK * LDV + nq * TK + nq * D + 3 * nq; }
__host__ __device__ constexpr int smem_floats(int nq) { return nq * D + NWARPS * warp_floats(nq); }

// element offset of (row, head h, position j) in a layer slice of S positions
template <bool HEADS>
__device__ __forceinline__ int64_t kv_offset(int row, int h, int j, int S, int Hkv) {
  return HEADS ? ((static_cast<int64_t>(row) * Hkv + h) * S + j) * D
               : (static_cast<int64_t>(row) * S + j) * (Hkv * D) + h * D;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One 64-value K or V row of one head -> f32 (dequantised and rounded to
// bf16 for int8, exact for bf16).
__device__ __forceinline__ void load_row(float* out, const int8_t* p, float s) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const uint4 w = p4[c];
    const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = static_cast<int>(static_cast<signed char>((words[j] >> (8 * e)) & 0xffu));
        out[c * 16 + j * 4 + e] = round_bf16(static_cast<float>(v) * s);
      }
    }
  }
}

__device__ __forceinline__ void load_row(float* out, const __nv_bfloat16* p, float) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint4 w = p4[c];
    const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out[c * 8 + j * 2] = __uint_as_float(words[j] << 16);
      out[c * 8 + j * 2 + 1] = __uint_as_float(words[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, bool SHARED, bool HEADS>
__global__ void __launch_bounds__(NTHREADS) decode_attend_kernel(Args a) {
  constexpr bool INT8 = sizeof(T) == 1;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = a.Hq / a.Hkv;
  const int NQ = G * a.Sq;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float* q_s = smem;                                  // (NQ, D)
  float* v_s = smem + NQ * D + warp * warp_floats(NQ);  // (TK, LDV)
  float* p_s = v_s + TK * LDV;                        // (NQ, TK)
  float* acc_s = p_s + NQ * TK;                       // (NQ, D)
  float* m_s = acc_s + NQ * D;                        // (NQ)
  float* l_s = m_s + NQ;
  float* alpha_s = l_s + NQ;

  // query row r = g * Sq + i is query head h * G + g at position i
  for (int idx = threadIdx.x; idx < NQ * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    const int g = r / a.Sq, i = r % a.Sq;
    q_s[idx] = __bfloat162float(a.q[(((int64_t)b * a.Sq + i) * a.Hq + h * G + g) * D + d]) * a.scale;
  }
  for (int idx = lane; idx < NQ * D; idx += 32) acc_s[idx] = 0.0f;
  for (int idx = lane; idx < NQ; idx += 32) {
    m_s[idx] = NEG_INF;
    l_s[idx] = 0.0f;
  }

  // Valid keys lie in [kv_start, hi): no query sees a key at or past
  // q_offset + Sq.  Split that window over the shared and own segments.
  const int kv_start = max(a.kv_starts[b], 0);
  const int q_off = a.q_offset[b];
  const int hi = min(a.kv_lens[b], q_off + a.Sq);
  int sh_lo = 0, sh_hi = 0;
  if (SHARED) {
    sh_lo = min(kv_start, a.shared_len);
    sh_hi = max(sh_lo, min(a.shared_len, hi));
  }
  const int base = SHARED ? a.shared_len : 0;  // absolute position of own slot 0
  const int own_lo = min(max(kv_start - base, 0), a.Sr);
  const int own_hi = max(own_lo, min(a.Sr, hi - base));
  const int n_sh = sh_hi - sh_lo;
  const int n_keys = n_sh + own_hi - own_lo;
  const int pm = SHARED ? a.prefix_map[b] : 0;
  __syncthreads();

  for (int t0 = warp * TK; t0 < n_keys; t0 += NWARPS * TK) {
    const int t = t0 + lane;
    const bool in = t < n_keys;
    int pos = 0;
    float kf[D];
    if (in) {
      const T* kp;
      const T* vp;
      float sk = 1.0f, sv = 1.0f;
      if (SHARED && t < n_sh) {
        const int j = sh_lo + t;
        pos = j;
        const int64_t off = kv_offset<HEADS>(pm, h, j, a.Sp, a.Hkv);
        kp = static_cast<const T*>(a.k_sh) + off;
        vp = static_cast<const T*>(a.v_sh) + off;
        if (INT8) {
          const int64_t so = ((int64_t)pm * a.Hkv + h) * a.Sp + j;
          sk = __bfloat162float(a.ks_sh[so]);
          sv = __bfloat162float(a.vs_sh[so]);
        }
      } else {
        const int j = own_lo + (t - n_sh);
        pos = base + j;
        const int64_t off = kv_offset<HEADS>(b, h, j, a.Sr, a.Hkv);
        kp = static_cast<const T*>(a.k_own) + off;
        vp = static_cast<const T*>(a.v_own) + off;
        if (INT8) {
          const int64_t so = ((int64_t)b * a.Hkv + h) * a.Sr + j;
          sk = __bfloat162float(a.ks_own[so]);
          sv = __bfloat162float(a.vs_own[so]);
        }
      }
      load_row(kf, kp, sk);
      float vf[D];
      load_row(vf, vp, sv);
#pragma unroll
      for (int d = 0; d < D; ++d) v_s[lane * LDV + d] = vf[d];
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        kf[d] = 0.0f;
        v_s[lane * LDV + d] = 0.0f;  // masked keys must not feed 0 * garbage
      }
    }

    // scores and the online-softmax update, one query row at a time
    for (int r = 0; r < NQ; ++r) {
      const int i = r % a.Sq;
      const bool ok = in && pos <= q_off + i;
      const float4* qr = reinterpret_cast<const float4*>(q_s + r * D);
      float s = 0.0f;
#pragma unroll
      for (int d4 = 0; d4 < D / 4; ++d4) {
        const float4 qq = qr[d4];
        s += qq.x * kf[4 * d4] + qq.y * kf[4 * d4 + 1] + qq.z * kf[4 * d4 + 2] +
             qq.w * kf[4 * d4 + 3];
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(ok ? s : NEG_INF));
      const float p = ok ? expf(fmaxf(s - m_new, EXP_FLOOR)) : 0.0f;
      const float psum = warp_sum(p);
      p_s[r * TK + lane] = p;
      __syncwarp();  // every lane has read m_s[r] before lane 0 moves it
      if (lane == 0) {
        const float alpha = expf(fmaxf(m_old - m_new, EXP_FLOOR));
        alpha_s[r] = alpha;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + psum;
      }
    }
    __syncwarp();

    // acc = acc * alpha + P V; lane owns columns lane and lane + 32
    for (int r = 0; r < NQ; ++r) {
      const float alpha = alpha_s[r];
      float a0 = acc_s[r * D + lane] * alpha;
      float a1 = acc_s[r * D + lane + 32] * alpha;
#pragma unroll 8
      for (int k = 0; k < TK; ++k) {
        const float pk = p_s[r * TK + k];
        a0 += pk * v_s[k * LDV + lane];
        a1 += pk * v_s[k * LDV + lane + 32];
      }
      acc_s[r * D + lane] = a0;
      acc_s[r * D + lane + 32] = a1;
    }
    __syncwarp();
  }
  __syncthreads();

  // merge the warps' (m, l, acc) and write O = acc / l (0 without valid keys)
  const int wf = warp_floats(NQ);
  float* w0 = smem + NQ * D;
  for (int idx = threadIdx.x; idx < NQ * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float* ws = w0 + w * wf + TK * LDV + NQ * TK;
      m = fmaxf(m, ws[NQ * D + r]);
    }
    float l = 0.0f, acc = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float* ws = w0 + w * wf + TK * LDV + NQ * TK;
      const float c = expf(fmaxf(ws[NQ * D + r] - m, EXP_FLOOR));
      l += ws[NQ * D + NQ + r] * c;
      acc += ws[r * D + d] * c;
    }
    const int g = r / a.Sq, i = r % a.Sq;
    a.o[(((int64_t)b * a.Sq + i) * a.Hq + h * G + g) * D + d] =
        __float2bfloat16(acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, bool SHARED, bool HEADS>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const int nq = (a.Hq / a.Hkv) * a.Sq;
  const int bytes = smem_floats(nq) * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attend_kernel<T, SHARED, HEADS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
  }
  decode_attend_kernel<T, SHARED, HEADS><<<dim3(B, a.Hkv), NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// The body of both C entry points; HEADS picks the layout.
template <bool HEADS>
int run(const void* q, void* o, const void* k_own, const void* v_own, const void* ks_own,
        const void* vs_own, const void* k_sh, const void* v_sh, const void* ks_sh,
        const void* vs_sh, const void* prefix_map, const void* kv_lens, const void* q_offset,
        const void* kv_starts, int B, int Sq, int Hq, int Hkv, int head_dim, int Sr, int Sp,
        int shared_len, int int8_cache, int shared, float scale, void* stream) {
  if (head_dim != D || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || B <= 0 ||
      (Hq / Hkv) * Sq > MAX_NQ) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.o = static_cast<__nv_bfloat16*>(o);
  a.k_own = k_own;
  a.v_own = v_own;
  a.ks_own = static_cast<const __nv_bfloat16*>(ks_own);
  a.vs_own = static_cast<const __nv_bfloat16*>(vs_own);
  a.k_sh = k_sh;
  a.v_sh = v_sh;
  a.ks_sh = static_cast<const __nv_bfloat16*>(ks_sh);
  a.vs_sh = static_cast<const __nv_bfloat16*>(vs_sh);
  a.prefix_map = static_cast<const int*>(prefix_map);
  a.kv_lens = static_cast<const int*>(kv_lens);
  a.q_offset = static_cast<const int*>(q_offset);
  a.kv_starts = static_cast<const int*>(kv_starts);
  a.Sq = Sq;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sr = Sr;
  a.Sp = Sp;
  a.shared_len = shared ? shared_len : 0;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (int8_cache) {
    err = shared ? launch<int8_t, true, HEADS>(a, B, s) : launch<int8_t, false, HEADS>(a, B, s);
  } else {
    err = shared ? launch<__nv_bfloat16, true, HEADS>(a, B, s)
                 : launch<__nv_bfloat16, false, HEADS>(a, B, s);
  }
  return static_cast<int>(err);
}

}  // namespace decode_attend
