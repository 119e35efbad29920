// One-token decode attention that writes its own K/V row into the cache,
// for Hopper (sm_90a).
//
// Replaces vla_rft_tpu/ops/fused_decode_attention.py::_kernel (kernel #10,
// `fused_decode_attention`): q (B, 1, Hq, D), the current token's k_new /
// v_new (B, 1, Hkv, D) already cast to the cache dtype, and a stacked
// 'heads' cache (L, B, Hkv, S, D), bf16 or f32, updated in place.  Per
// (row b, kv head h):
//   * row `idx` (the history length) of layer li is overwritten with the
//     new K/V;
//   * attention covers the history rows [kv_starts[b], idx) plus the
//     current token, which is always attended: f32 scores of q * D^-0.5,
//     online softmax with exp(max(x, -80)), o = acc / max(l, 1e-30), in q's
//     dtype.
// The TPU kernel's aligned read-modify-write window (`win`, a Mosaic rule
// for sub-tile stores) and its double-buffered DMA of `block_k` rows are
// not ported: a block writes its one row directly.
//
// Design.  One block of 4 warps per (row b, kv head h).  The block writes
// only its own row `idx` and reads only rows < idx of the same (b, h), so
// no block reads what another writes: there is no hazard, and the current
// token is folded in from the inputs, as the TPU kernel does.  The G query
// heads of the kv head are staged in shared memory (f32, pre-scaled).
// Warps take 32-row tiles of the history in turn: the warp copies its tile,
// 32 contiguous rows of D values, with coalesced 16-byte loads into shared
// K and V tiles (f32, padded rows); each lane then owns one key for the
// scores (a D-long dot per query head), the running max and sum are warp
// shuffles, and P.V accumulates in the warp's shared (m, l, acc) with each
// lane owning D/32 output columns.  The block merges its warps' states and
// folds in the current token last.  D is a template parameter (32, 64 or
// 128), the cache and q types are bf16 or f32 each.
//
// What bounds it on an H100.  It reads the valid history once (2 * D *
// elem bytes per key and head) and does 4*D flops per (query head, key): at
// the WM shape (G = 1) a quarter of a flop per byte, so device-memory
// traffic sets the bound, about 2 * 10 * 16 * 1379 * 64 * 2 bytes = 56 MB
// per call at mid-rollout, 17 us at 3.35 TB/s.  This simple version runs
// B*Hkv blocks with one tile in flight per warp; split-K over the history
// and cp.async/TMA pipelining are for a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_decode_attention.so fused_decode_attention.cu
// Interface: plain C (fused_decode_attention), loaded with ctypes; it
// launches on the given stream, never synchronises, and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TK = 32;      // history rows per warp tile
constexpr int MAX_G = 16;   // query heads per kv head
constexpr float NEG_INF = -1e30f;
constexpr float EXP_FLOOR = -80.0f;

struct Args {
  const void* q;         // (B, 1, Hq, D), Q
  const void* k_new;     // (B, 1, Hkv, D), T
  const void* v_new;
  void* ck;              // (L, B, Hkv, S, D), T, written at row idx of layer li
  void* cv;
  void* o;               // (B, 1, Hq, D), Q
  const int* kv_starts;  // (B,) first valid history row
  int li, idx, B, Hq, Hkv, S;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// 16 bytes of T -> f32 values
__device__ __forceinline__ void unpack(const uint4& w, float* out, float) {
  out[0] = __uint_as_float(w.x);
  out[1] = __uint_as_float(w.y);
  out[2] = __uint_as_float(w.z);
  out[3] = __uint_as_float(w.w);
}

__device__ __forceinline__ void unpack(const uint4& w, float* out, __nv_bfloat16) {
  const unsigned int words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    out[2 * j] = __uint_as_float(words[j] << 16);
    out[2 * j + 1] = __uint_as_float(words[j] & 0xffff0000u);
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

// floats of dynamic shared memory: q (G, D), then per warp the K and V
// tiles (TK, D + 1), P (G, TK), acc (G, D), m, l, alpha (G); then the
// merged per-head m, alpha, p_cur and l (G each)
__host__ __device__ constexpr int warp_floats(int G, int D) {
  return 2 * TK * (D + 1) + G * TK + G * D + 3 * G;
}
__host__ __device__ constexpr int smem_floats(int G, int D) {
  return G * D + NWARPS * warp_floats(G, D) + 4 * G;
}

template <typename T, typename Q, int D>
__global__ void __launch_bounds__(NTHREADS) fused_decode_attention_kernel(Args a) {
  constexpr int LD = D + 1;
  constexpr int VEC = 16 / sizeof(T);  // values per 16-byte load
  constexpr int CPR = D / VEC;         // 16-byte chunks per row
  constexpr int COLS = D / 32;         // output columns per lane
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int G = a.Hq / a.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  float* q_s = smem;                                       // (G, D)
  float* k_s = smem + G * D + warp * warp_floats(G, D);    // (TK, LD)
  float* v_s = k_s + TK * LD;                              // (TK, LD)
  float* p_s = v_s + TK * LD;                              // (G, TK)
  float* acc_s = p_s + G * TK;                             // (G, D)
  float* m_s = acc_s + G * D;                              // (G)
  float* l_s = m_s + G;
  float* alpha_s = l_s + G;
  float* fin = smem + G * D + NWARPS * warp_floats(G, D);  // (4, G)

  const int64_t head = (static_cast<int64_t>(a.li) * a.B + b) * a.Hkv + h;
  T* ck = static_cast<T*>(a.ck) + head * a.S * D;
  T* cv = static_cast<T*>(a.cv) + head * a.S * D;
  const T* kn = static_cast<const T*>(a.k_new) + (static_cast<int64_t>(b) * a.Hkv + h) * D;
  const T* vn = static_cast<const T*>(a.v_new) + (static_cast<int64_t>(b) * a.Hkv + h) * D;
  const Q* q = static_cast<const Q*>(a.q) + (static_cast<int64_t>(b) * a.Hq + h * G) * D;

  // the new row: the only row of this (b, h) that the block writes
  for (int d = threadIdx.x; d < D; d += NTHREADS) {
    ck[static_cast<int64_t>(a.idx) * D + d] = kn[d];
    cv[static_cast<int64_t>(a.idx) * D + d] = vn[d];
  }
  for (int i = threadIdx.x; i < G * D; i += NTHREADS) q_s[i] = to_f32(q[i]) * a.scale;
  for (int i = lane; i < G * D; i += 32) acc_s[i] = 0.0f;
  for (int i = lane; i < G; i += 32) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.0f;
  }
  const int lo = min(max(a.kv_starts[b], 0), a.idx);
  const int n_keys = a.idx - lo;
  __syncthreads();

  for (int t0 = warp * TK; t0 < n_keys; t0 += NWARPS * TK) {
    const int n = min(TK, n_keys - t0);  // valid rows of this tile
    // coalesced copy of the tile's rows [lo + t0, lo + t0 + n) into K and V
    const uint4* kp = reinterpret_cast<const uint4*>(ck + static_cast<int64_t>(lo + t0) * D);
    const uint4* vp = reinterpret_cast<const uint4*>(cv + static_cast<int64_t>(lo + t0) * D);
    for (int e = lane; e < TK * CPR; e += 32) {
      const int row = e / CPR, c = e % CPR;
      float kf[VEC], vf[VEC];
      if (row < n) {
        unpack(kp[e], kf, T());
        unpack(vp[e], vf, T());
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) kf[j] = vf[j] = 0.0f;  // no 0 * garbage in P.V
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        k_s[row * LD + c * VEC + j] = kf[j];
        v_s[row * LD + c * VEC + j] = vf[j];
      }
    }
    __syncwarp();

    const bool ok = lane < n;
    for (int r = 0; r < G; ++r) {
      float s = 0.0f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += q_s[r * D + d] * k_s[lane * LD + d];
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

    // acc = acc * alpha + P V; lane owns columns lane + 32 * c
    for (int r = 0; r < G; ++r) {
      const float alpha = alpha_s[r];
      float acc[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] = acc_s[r * D + lane + 32 * c] * alpha;
#pragma unroll 8
      for (int k = 0; k < TK; ++k) {
        const float pk = p_s[r * TK + k];
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[c] += pk * v_s[k * LD + lane + 32 * c];
      }
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc_s[r * D + lane + 32 * c] = acc[c];
    }
    __syncwarp();
  }
  __syncthreads();

  // merge the warps' (m, l) per query head and fold in the current token
  const int wf = warp_floats(G, D);
  const float* w0 = smem + G * D + 2 * TK * LD + G * TK;  // warp 0's acc
  for (int r = threadIdx.x; r < G; r += NTHREADS) {
    float m = NEG_INF;
    for (int w = 0; w < NWARPS; ++w) m = fmaxf(m, w0[w * wf + G * D + r]);
    float l = 0.0f;
    for (int w = 0; w < NWARPS; ++w) {
      const float* ws = w0 + w * wf;
      l += ws[G * D + G + r] * expf(fmaxf(ws[G * D + r] - m, EXP_FLOOR));
    }
    float s_cur = 0.0f;
    for (int d = 0; d < D; ++d) s_cur += q_s[r * D + d] * to_f32(kn[d]);
    const float m_new = fmaxf(m, s_cur);
    const float p_cur = expf(fmaxf(s_cur - m_new, EXP_FLOOR));
    const float alpha = expf(fmaxf(m - m_new, EXP_FLOOR));
    fin[r] = m;
    fin[G + r] = alpha;
    fin[2 * G + r] = p_cur;
    fin[3 * G + r] = l * alpha + p_cur;
  }
  __syncthreads();

  Q* o = static_cast<Q*>(a.o) + (static_cast<int64_t>(b) * a.Hq + h * G) * D;
  for (int i = threadIdx.x; i < G * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    float acc = 0.0f;
    for (int w = 0; w < NWARPS; ++w) {
      const float* ws = w0 + w * wf;
      acc += ws[r * D + d] * expf(fmaxf(ws[G * D + r] - fin[r], EXP_FLOOR));
    }
    acc = acc * fin[G + r] + fin[2 * G + r] * to_f32(vn[d]);
    store(o + i, acc / fmaxf(fin[3 * G + r], 1e-30f));
  }
}

template <typename T, typename Q, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const int bytes = smem_floats(G, D) * static_cast<int>(sizeof(float));
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_decode_attention_kernel<T, Q, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
  }
  fused_decode_attention_kernel<T, Q, D><<<dim3(a.B, a.Hkv), NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename Q>
cudaError_t launch_d(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, Q, 32>(a, stream);
    case 64: return launch<T, Q, 64>(a, stream);
    case 128: return launch<T, Q, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// cache_f32 / q_f32: 1 for float32, 0 for bfloat16
extern "C" int fused_decode_attention(const void* q, const void* k_new, const void* v_new,
                                      void* ck, void* cv, void* o, const void* kv_starts,
                                      int L, int B, int Hq, int Hkv, int S, int D, int li,
                                      int idx, int cache_f32, int q_f32, float scale,
                                      void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > MAX_G || li < 0 || li >= L ||
      idx < 0 || idx >= S) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.ck = ck;
  a.cv = cv;
  a.o = o;
  a.kv_starts = static_cast<const int*>(kv_starts);
  a.li = li;
  a.idx = idx;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.S = S;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (cache_f32) {
    err = q_f32 ? launch_d<float, float>(a, D, s) : launch_d<float, __nv_bfloat16>(a, D, s);
  } else {
    err = q_f32 ? launch_d<__nv_bfloat16, float>(a, D, s)
                : launch_d<__nv_bfloat16, __nv_bfloat16>(a, D, s);
  }
  return static_cast<int>(err);
}
