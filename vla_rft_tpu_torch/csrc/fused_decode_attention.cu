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
//   * attention covers the history rows [clamp(kv_starts[b], 0, idx), idx)
//     plus the current token, which is always attended: f32 scores of
//     q.k * D^-0.5, online softmax with exp(max(x, -80)), o = acc /
//     max(l, 1e-30), in q's dtype.
// The TPU kernel's aligned read-modify-write window (`win`, a Mosaic rule
// for sub-tile stores) and its double-buffered DMA of `block_k` rows are
// not ported: one block writes the one row directly.
//
// Design (the pieces of csrc/decode_attend.cuh, the decode kernel behind
// #4-#7, over one (b, h) history):
//   * Split-K over a cluster.  Grid (R, Hkv, B), cluster (R, 1, 1), R <= 8
//     from the wrapper's split_plan (host-known sizes only: one block per
//     SM, so R = 1 at the WM's 160 and 2,048 (row, head) pairs, 7 at GQA
//     14/2's 20).  Rank r takes the key tiles [r T / R, (r + 1) T / R) of
//     its row's window, T tiles of TK keys from the window's first row;
//     each block reads its own kv_starts[b], so nothing is read back to the
//     host and a CUDA graph may replay the call.  A rank with no tile
//     contributes (m = -inf, l = 0, O = 0).
//   * Loads in flight.  A 3-stage cp.async ring streams the K and V tiles
//     in the cache's own dtype (16 bytes a copy, 16-byte chunks of a row
//     XOR-swizzled by the row so the fragment loads hit distinct banks); a
//     false predicate zero-fills rows at or past idx.  q, k_new and v_new
//     are the first copy group, so their reads do not queue behind the
//     tiles' and q's fragments are read while the tiles fly.
//   * Products.  Warp w takes keys TK/4 w .. TK/4 (w + 1) - 1 of a tile.
//     A bf16 cache runs mma.sync m16n8k16 (f32 accumulate): the G <= 16
//     query heads of a kv head fill one m16 tile (rows past G are zero and
//     never stored; for G <= 8 the upper 8 rows' softmax is skipped), the
//     products' k index permuted so one lane's 16-byte loads of a key hold
//     all its k16 steps; the scale multiplies the f32 scores after the
//     product (D^-0.5 is not a power of two at D = 32 or 128, so folding
//     it into a bf16 q would round); an f32 q is split into two bf16 terms
//     (hi + lo) and P likewise, so scores and P keep 16 bits.  An f32
//     cache runs the same split, ring and merge with its products on FFMA
//     (a lane per key for the scores, a lane per output column for P.V),
//     so it holds f32 precision; its tile is 64 keys at D = 128 to fit the
//     ring in shared memory.
//   * A deterministic merge.  Each warp's (m, l, O) goes to shared memory,
//     the block merges them in warp order; the last rank folds in the
//     current token (its score from q and k_new in f32) last; then the
//     ranks merge in rank order over distributed shared memory, rank r
//     writing every R-th output element (with one rank the block's merge
//     stores O, and no cluster barrier runs).  One launch, no scratch, no
//     atomics: the same bits on every run.
//   * The write.  Rank 0 writes row idx of K and V, last.  Every block
//     reads only rows below idx of its own (b, h), so no block reads what
//     another writes, the property the TPU kernel relies on too.
//
// What bounds it on an H100.  It reads the valid history once (2 * D *
// elem bytes per key and kv head) and does 4*D flops per (query head,
// key): at the WM shape (G = 1) a quarter of a flop per byte, so
// device-memory traffic sets the bound, about 2 * 10 * 16 * 1379 * 64 * 2
// bytes = 56 MB per call at mid-rollout, 17 us at 3.35 TB/s.  Measured on
// an H100 80GB HBM3 at 700 W (chip_smoke.py and kernel_trace.py, CUDA-graph
// replay; PERF.md section 6): 0.0247-0.0280 ms there (the first
// version, one block of 4 warps per (b, h) with f32 tiles staged through
// registers and CUDA-core products, took 0.0622 ms), 0.239-0.240 ms at 128
// rows (bound 0.216) and 0.0068-0.0069 ms at GQA 14/2 (SDPA: 0.0228-0.0231,
// 0.233, 0.0078-0.0079).  While
// their tiles flow the blocks read about 2.9 TB/s together
// (kernel_trace.py); what is left is the ramp (the first tiles, ~3.5 us)
// and the tail of the blocks that share an SM (at B = 10, 28 of the 132
// SMs hold two of the 160 blocks), where the products are no longer
// hidden.  More ranks add their fixed chain (set-up, first tile,
// cluster barrier and rank merge) and no rate: 8 ranks took 0.037 ms at
// B = 10 (kernel_trace.py --fda-variants).
//
// The comments "// setup done", "// tiles done", "// warp merge done" and
// "// cluster wait done" mark the phase boundaries kernel_trace.py stamps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libfused_decode_attention.so fused_decode_attention.cu
// Interface: plain C (fused_decode_attention), loaded with ctypes; it
// launches on the given stream, never synchronises, and returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_G = 16;      // query heads per kv head: one m16 tile
constexpr int MAX_SPLITS = 8;  // ranks of a cluster (the portable limit)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float EXP2_FLOOR = -80.0f * LOG2E;  // exp(max(x, -80)) = 2^max(x log2 e, -80 log2 e)

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

// One ring stage of a (T, D) cache: K rows then V rows, TK keys each, 16-byte
// chunks of a row swizzled by the row's low bits.
template <typename T, int D_>
struct Tile {
  static constexpr int D = D_;
  static constexpr int TK = (sizeof(T) == 4 && D == 128) ? 64 : 128;  // keys of a tile
  static constexpr int KPW = TK / NWARPS;                            // keys of a warp
  static constexpr int ROW = D * static_cast<int>(sizeof(T));       // bytes of a key row
  static constexpr int CH = ROW / 16;                                // 16-byte chunks of a row
  static constexpr int MASK = (CH < 8 ? CH : 8) - 1;
  static constexpr int KV = TK * ROW;                                // bytes of K (or V)
  static constexpr int BYTES = 2 * KV;
  static constexpr int STAGES = 3;  // ring stages: two tiles in flight while one is multiplied
};

// byte offset of byte `byte` of row r in a swizzled tile
template <typename TL>
__device__ __forceinline__ int at(int r, int byte) {
  return r * TL::ROW + ((((byte >> 4) ^ (r & TL::MASK)) << 4) | (byte & 15));
}

// The merge area (floats): per warp, then for the block, (O, m, l) of the
// MAX_G query heads; O rows LD apart.
template <int D>
struct Merge {
  static constexpr int LD = D + 4;
  static constexpr int M = MAX_G * LD, L = MAX_G * LD + MAX_G;
  static constexpr int FLOATS = MAX_G * LD + 2 * MAX_G;
  static constexpr int BYTES = (NWARPS + 1) * FLOATS * 4;
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory: q (MAX_G rows of D, in q's dtype), k_new and v_new
// (D each, in the cache's), then one area used by the ring and then by the
// merge.
template <typename T, typename Q, int D>
__host__ __device__ constexpr int q_bytes() {
  return MAX_G * D * static_cast<int>(sizeof(Q)) + 2 * D * static_cast<int>(sizeof(T));
}
template <typename T, typename Q, int D>
__host__ __device__ constexpr int smem_bytes() {
  return q_bytes<T, Q, D>() + cmax(Tile<T, D>::STAGES * Tile<T, D>::BYTES, Merge<D>::BYTES);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// four consecutive values as floats
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
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
// Cluster barriers in halves: arrive.release publishes this block's shared
// state to the cluster; arrive.relaxed orders nothing (used once every read
// of another block's state has been consumed); wait.acquire waits for every
// block's arrival.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// A warp's share of a bf16 cache on mma.sync m16n8k16: query heads as the
// rows of one m16 tile, its KPW keys of a tile as KPW / 8 n8 tiles.
template <typename Q, typename TL>
struct MmaWarp {
  static constexpr int D = TL::D;
  static constexpr int KS = D / 16;                         // k16 steps of Q K^T
  static constexpr int NT = D / 8;                          // n8 tiles of O
  static constexpr int QT = sizeof(Q) == 4 ? 2 : 1;         // bf16 terms of q
  static constexpr int KT = TL::KPW / 8;                    // n8 tiles of the warp's keys
  static_assert(TL::KPW % 16 == 0, "a warp multiplies whole k16 steps of keys");
  uint32_t qa[QT][KS][4];  // Q as A fragments
  float acc[NT][4];        // O: element e of n8 tile j is row g + 8 (e >> 1), value (D/8)(2 qd + (e & 1)) + j
  float m[2], l[2];        // rows g and g + 8, log2 units

  // q's A fragments: the lane's values qd D/4 .. qd D/4 + D/4 - 1 of rows
  // g and g + 8 (k16 step kk: values 4 kk .. 4 kk + 3 of them), the
  // products' k index permuted the same way for K
  __device__ __forceinline__ void init(const Q* q_s, int lane) {
    const int g = lane >> 2, qd = lane & 3;
    uint32_t w[QT][2][D / 8];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const Q* row = q_s + (g + 8 * hf) * D + qd * (D / 4);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        if constexpr (QT == 1) {
          w[0][hf][i] = reinterpret_cast<const uint32_t*>(row)[i];
        } else {
          const float x0 = to_f32(row[2 * i]), x1 = to_f32(row[2 * i + 1]);
          const uint32_t hi = pack_bf16(x0, x1);
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&hi);
          w[0][hf][i] = hi;
          w[QT - 1][hf][i] = pack_bf16(x0 - __low2float(hv), x1 - __high2float(hv));
        }
      }
    }
#pragma unroll
    for (int t = 0; t < QT; ++t)
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        qa[t][kk][0] = w[t][0][2 * kk];
        qa[t][kk][1] = w[t][1][2 * kk];
        qa[t][kk][2] = w[t][0][2 * kk + 1];
        qa[t][kk][3] = w[t][1][2 * kk + 1];
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.0f;
  }

  // keys kw0 .. kw0 + KPW - 1 of the stage at `st` (absolute positions
  // jw ..); keys at or past hi are masked
  __device__ __forceinline__ void tile(const unsigned char* st, int kw0, int jw, int hi,
                                       bool upper, float scale_log2, int lane) {
    const int g = lane >> 2, qd = lane & 3;
    float s[KT][4];
#pragma unroll
    for (int tt = 0; tt < KT; ++tt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[tt][e] = 0.0f;
      // K as B fragments: key kw0 + 8 tt + g, the lane's values qd D/4 ..
      const int kr = kw0 + 8 * tt + g;
      uint32_t kw[D / 8];
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        const uint4 v = *reinterpret_cast<const uint4*>(st + at<TL>(kr, (qd * (D / 32) + c) * 16));
        kw[4 * c] = v.x, kw[4 * c + 1] = v.y, kw[4 * c + 2] = v.z, kw[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
#pragma unroll
        for (int t = 0; t < QT; ++t) mma_bf16(s[tt], qa[t][kk], kw[2 * kk], kw[2 * kk + 1]);
    }
    // masks, the online max and sum: element e of n8 tile tt is row
    // g + 8 (e >> 1), key jw + 8 tt + 2 qd + (e & 1)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (hf == 1 && !upper) {  // rows g + 8 are padding (G <= 8): P = 0
#pragma unroll
        for (int tt = 0; tt < KT; ++tt) s[tt][2] = s[tt][3] = 0.0f;
        break;
      }
      bool ok[KT][2];
      float mx = NEG_INF;
#pragma unroll
      for (int tt = 0; tt < KT; ++tt)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          ok[tt][e1] = jw + 8 * tt + 2 * qd + e1 < hi;
          if (ok[tt][e1]) mx = fmaxf(mx, s[tt][2 * hf + e1] * scale_log2);
        }
      mx = quad_max(mx);
      const float m_new = fmaxf(m[hf], mx);
      const float alpha = exp2_approx(fmaxf(m[hf] - m_new, EXP2_FLOOR));
      m[hf] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int tt = 0; tt < KT; ++tt)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          const float x = s[tt][2 * hf + e1];
          const float p =
              ok[tt][e1] ? exp2_approx(fmaxf(fmaf(x, scale_log2, -m_new), EXP2_FLOOR)) : 0.0f;
          s[tt][2 * hf + e1] = p;
          sum += p;
        }
      l[hf] = l[hf] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][2 * hf] *= alpha;
        acc[j][2 * hf + 1] *= alpha;
      }
    }
    // O += P V, k16 step ks over keys kw0 + 16 ks ..: P's A fragment is the
    // accumulators of n8 tiles 2 ks and 2 ks + 1, in two bf16 terms; V's B
    // fragment holds keys 2 qd, 2 qd + 1, 2 qd + 8, 2 qd + 9 of the step and
    // values (D/8) g .. (D/8) g + D/8 - 1 (n8 tile j: value (D/8) n + j in
    // its column n)
    const unsigned char* vt = st + TL::KV;
#pragma unroll
    for (int ks = 0; ks < KT / 2; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int tt = 2 * ks + (x >> 1), e = (x & 1) * 2;
        const float p0 = s[tt][e], p1 = s[tt][e + 1];
        ah[x] = pack_bf16(p0, p1);
        const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&ah[x]);
        al[x] = pack_bf16(p0 - __low2float(hv), p1 - __high2float(hv));
      }
      const int k0 = kw0 + 16 * ks;
      const int kv[4] = {k0 + 2 * qd, k0 + 2 * qd + 1, k0 + 2 * qd + 8, k0 + 2 * qd + 9};
      uint32_t w[4][D / 16];  // the lane's D/8 values of each key, two a word
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        if constexpr (D == 32) {
          const uint2 v = *reinterpret_cast<const uint2*>(vt + at<TL>(kv[x], 8 * g));
          w[x][0] = v.x, w[x][1] = v.y;
        } else {
#pragma unroll
          for (int c = 0; c < D / 64; ++c) {
            const uint4 v =
                *reinterpret_cast<const uint4*>(vt + at<TL>(kv[x], (D / 4) * g + 16 * c));
            w[x][4 * c] = v.x, w[x][4 * c + 1] = v.y, w[x][4 * c + 2] = v.z, w[x][4 * c + 3] = v.w;
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int wi = j >> 1;
        const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
        const uint32_t b0 = __byte_perm(w[0][wi], w[1][wi], sel);
        const uint32_t b1 = __byte_perm(w[2][wi], w[3][wi], sel);
        mma_bf16(acc[j], ah, b0, b1);
        mma_bf16(acc[j], al, b0, b1);
      }
    }
  }

  // the warp's state for query heads r < G into its merge area
  __device__ __forceinline__ void store(float* ws, int G, int lane) {
    using MG = Merge<D>;
    const int g = lane >> 2, qd = lane & 3;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lq = l[hf];
      lq += __shfl_xor_sync(0xffffffffu, lq, 1);
      lq += __shfl_xor_sync(0xffffffffu, lq, 2);
      const int r = g + 8 * hf;
      if (r >= G) continue;
      if (qd == 0) ws[MG::M + r] = m[hf], ws[MG::L + r] = lq;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) ws[r * MG::LD + (D / 8) * (2 * qd + e1) + j] = acc[j][2 * hf + e1];
    }
  }
};

// A warp's share of an f32 cache on FFMA: lane k holds key kw0 + k for the
// scores, lane c output values c, c + 32, ... for P.V.
template <typename Q, typename TL>
struct FmaWarp {
  static constexpr int D = TL::D;
  static constexpr int KPW = TL::KPW;
  static constexpr int COLS = D / 32;
  float acc[MAX_G][COLS];
  float m[MAX_G], l[MAX_G];
  const Q* q_s;

  __device__ __forceinline__ void init(const Q* q, int) {
    q_s = q;
#pragma unroll
    for (int r = 0; r < MAX_G; ++r) {
      m[r] = NEG_INF, l[r] = 0.0f;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[r][c] = 0.0f;
    }
  }

  __device__ __forceinline__ void tile(const unsigned char* st, int kw0, int jw, int hi,
                                       int G, float scale_log2, int lane) {
    const bool ok = lane < KPW && jw + lane < hi;
    float s[MAX_G];
#pragma unroll
    for (int r = 0; r < MAX_G; ++r) s[r] = 0.0f;
    if (ok) {
#pragma unroll 4
      for (int c = 0; c < D / 4; ++c) {
        const float4 k4 = *reinterpret_cast<const float4*>(st + at<TL>(kw0 + lane, 16 * c));
#pragma unroll
        for (int r = 0; r < MAX_G; ++r) {
          if (r < G) {
            const float4 q4 = load4(q_s + r * D + 4 * c);
            s[r] = fmaf(q4.x, k4.x, s[r]);
            s[r] = fmaf(q4.y, k4.y, s[r]);
            s[r] = fmaf(q4.z, k4.z, s[r]);
            s[r] = fmaf(q4.w, k4.w, s[r]);
          }
        }
      }
    }
    float p[MAX_G];
#pragma unroll
    for (int r = 0; r < MAX_G; ++r) {
      p[r] = 0.0f;
      if (r < G) {
        const float x = s[r] * scale_log2;
        const float m_new = fmaxf(m[r], warp_max(ok ? x : NEG_INF));
        const float alpha = exp2_approx(fmaxf(m[r] - m_new, EXP2_FLOOR));
        p[r] = ok ? exp2_approx(fmaxf(x - m_new, EXP2_FLOOR)) : 0.0f;
        l[r] = l[r] * alpha + warp_sum(p[r]);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[r][c] *= alpha;
      }
    }
    const int n = min(KPW, hi - jw);  // the warp's keys before hi
    const unsigned char* vt = st + TL::KV;
    for (int k = 0; k < n; ++k) {
      float v[COLS];
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        v[c] = *reinterpret_cast<const float*>(vt + at<TL>(kw0 + k, 4 * (lane + 32 * c)));
#pragma unroll
      for (int r = 0; r < MAX_G; ++r) {
        if (r < G) {
          const float pk = __shfl_sync(0xffffffffu, p[r], k);
#pragma unroll
          for (int c = 0; c < COLS; ++c) acc[r][c] = fmaf(pk, v[c], acc[r][c]);
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* ws, int G, int lane) {
    using MG = Merge<D>;
#pragma unroll
    for (int r = 0; r < MAX_G; ++r) {
      if (r < G) {
        if (lane == 0) ws[MG::M + r] = m[r], ws[MG::L + r] = l[r];
#pragma unroll
        for (int c = 0; c < COLS; ++c) ws[r * MG::LD + lane + 32 * c] = acc[r][c];
      }
    }
  }
};

// grid (splits, Hkv, B), cluster (splits, 1, 1).
template <typename T, typename Q, int D>
__global__ void __launch_bounds__(NTHREADS) fused_decode_attention_kernel(Args a) {
  using TL = Tile<T, D>;
  using MG = Merge<D>;
  constexpr bool MMA = sizeof(T) == 2;
  constexpr int TK = TL::TK, STAGES = TL::STAGES;
  using Warp = std::conditional_t<MMA, MmaWarp<Q, TL>, FmaWarp<Q, TL>>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float s_cur[MAX_G];  // the current token's score per query head, log2 units

  const int rank = blockIdx.x, splits = gridDim.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  Q* q_s = reinterpret_cast<Q*>(smem);  // (MAX_G, D), rows past G zero
  T* kn_s = reinterpret_cast<T*>(q_s + MAX_G * D);  // k_new, then v_new
  T* vn_s = kn_s + D;
  unsigned char* work = smem + q_bytes<T, Q, D>();
  const uint32_t work_u = smem_u32(work);

  const int64_t head = (static_cast<int64_t>(a.li) * a.B + b) * a.Hkv + h;
  T* ck = static_cast<T*>(a.ck) + head * a.S * D;
  T* cv = static_cast<T*>(a.cv) + head * a.S * D;
  const T* kn = static_cast<const T*>(a.k_new) + (static_cast<int64_t>(b) * a.Hkv + h) * D;
  const T* vn = static_cast<const T*>(a.v_new) + (static_cast<int64_t>(b) * a.Hkv + h) * D;
  const Q* q = static_cast<const Q*>(a.q) + (static_cast<int64_t>(b) * a.Hq + h * G) * D;

  // q, k_new and v_new: the first copy group, ahead of the tiles (a read
  // of them from device memory would queue behind the tiles' copies)
  constexpr int QCH = D * static_cast<int>(sizeof(Q)) / 16;
  constexpr int KCH = D * static_cast<int>(sizeof(T)) / 16;
  for (int i = tid; i < MAX_G * QCH + 2 * KCH; i += NTHREADS) {
    if (i < MAX_G * QCH) {
      const int r = i / QCH, c = i % QCH;
      const bool ok = r < G;
      cp_async16(smem_u32(q_s) + i * 16, ok ? q + r * D + c * (16 / sizeof(Q)) : q, ok);
    } else {
      const int c = i - MAX_G * QCH;  // k_new's chunks, then v_new's
      const T* src = c < KCH ? kn + c * (16 / sizeof(T)) : vn + (c - KCH) * (16 / sizeof(T));
      cp_async16(smem_u32(kn_s) + c * 16, src, true);
    }
  }
  cp_async_commit();

  // the window [lo, idx) and this rank's tiles of it
  const int lo = min(max(a.kv_starts[b], 0), a.idx);
  const int n_tiles = (a.idx - lo + TK - 1) / TK;
  const int t_begin = n_tiles * rank / splits;
  const int t_end = n_tiles * (rank + 1) / splits;

  auto load = [&](int t, int stage) {
    const int j0 = lo + t * TK;
    const uint32_t st = work_u + stage * TL::BYTES;
#pragma unroll 4
    for (int i = tid; i < TK * TL::CH; i += NTHREADS) {
      const int kk = i / TL::CH, c = i % TL::CH, j = j0 + kk;
      const bool ok = j < a.idx;  // rows at or past idx read as 0
      const int64_t off = ok ? static_cast<int64_t>(j) * D + c * (16 / sizeof(T)) : 0;
      const int dst = at<TL>(kk, 16 * c);
      cp_async16(st + dst, ck + off, ok);
      cp_async16(st + TL::KV + dst, cv + off, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (t_begin + s < t_end) load(t_begin + s, s);
    cp_async_commit();
  }

  cp_async_wait<STAGES - 1>();  // q, k_new and v_new have landed
  __syncthreads();
  const float scale_log2 = a.scale * LOG2E;
  if (rank == splits - 1) {  // the current token's scores, in f32
    for (int r = warp; r < G; r += NWARPS) {
      float x = 0.0f;
      for (int d = lane; d < D; d += 32) x = fmaf(to_f32(q_s[r * D + d]), to_f32(kn_s[d]), x);
      x = warp_sum(x);
      if (lane == 0) s_cur[r] = x * scale_log2;
    }
  }
  Warp w;
  w.init(q_s, lane);
  const int kw0 = TL::KPW * warp;  // the warp's first key in a tile
  // setup done

  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    cp_async_wait<STAGES - 2>();  // tile t has landed
    __syncthreads();              // ... for every thread; every warp is done with tile t - 1
    if (t + STAGES - 1 < t_end) load(t + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    const int jw = lo + t * TK + kw0;  // absolute position of the warp's first key
    if (jw >= a.idx) continue;         // none of its keys is in the window
    const unsigned char* st = work + (it % STAGES) * TL::BYTES;
    if constexpr (MMA) {
      w.tile(st, kw0, jw, a.idx, G > 8, scale_log2, lane);
    } else {
      w.tile(st, kw0, jw, a.idx, G, scale_log2, lane);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  // tiles done

  // ---- merge: the warps in warp order, the current token last (last
  // rank), then the ranks in rank order
  float* mg = reinterpret_cast<float*>(work);
  w.store(mg + warp * MG::FLOATS, G, lane);
  __syncthreads();
  float* bs = mg + NWARPS * MG::FLOATS;  // the block's merged state
  Q* o = static_cast<Q*>(a.o) + (static_cast<int64_t>(b) * a.Hq + h * G) * D;
  const bool last = rank == splits - 1;
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    float m = NEG_INF;
#pragma unroll
    for (int k = 0; k < NWARPS; ++k) m = fmaxf(m, mg[k * MG::FLOATS + MG::M + r]);
    float l = 0.0f, acc = 0.0f;
#pragma unroll
    for (int k = 0; k < NWARPS; ++k) {
      const float* ws = mg + k * MG::FLOATS;
      const float f = exp2_approx(fmaxf(ws[MG::M + r] - m, EXP2_FLOOR));
      l += ws[MG::L + r] * f;
      acc += ws[r * MG::LD + d] * f;
    }
    if (last) {
      const float x = s_cur[r];
      const float m_new = fmaxf(m, x);
      const float alpha = exp2_approx(fmaxf(m - m_new, EXP2_FLOOR));
      const float p = exp2_approx(fmaxf(x - m_new, EXP2_FLOOR));
      l = l * alpha + p;
      acc = acc * alpha + p * to_f32(vn_s[d]);
      m = m_new;
    }
    if (splits == 1) {  // no other rank: the output
      store(o + i, acc / fmaxf(l, 1e-30f));
    } else {
      bs[r * MG::LD + d] = acc;
      if (d == 0) bs[MG::M + r] = m, bs[MG::L + r] = l;
    }
  }
  // warp merge done
  if (splits > 1) {
    cluster_arrive_release();
    cluster_wait();  // every rank's state is complete
    // cluster wait done
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    for (int i = rank * NTHREADS + tid; i < G * D; i += splits * NTHREADS) {
      const int r = i / D, d = i % D;
      float mk[MAX_SPLITS];
      float m = NEG_INF;
#pragma unroll
      for (int k = 0; k < MAX_SPLITS; ++k) {
        if (k < splits) {
          mk[k] = *cluster.map_shared_rank(bs + MG::M + r, k);
          m = fmaxf(m, mk[k]);
        }
      }
      float l = 0.0f, acc = 0.0f;
#pragma unroll
      for (int k = 0; k < MAX_SPLITS; ++k) {
        if (k < splits) {
          const float f = exp2_approx(fmaxf(mk[k] - m, EXP2_FLOOR));
          l += *cluster.map_shared_rank(bs + MG::L + r, k) * f;
          acc += *cluster.map_shared_rank(bs + r * MG::LD + d, k) * f;
        }
      }
      store(o + i, acc / fmaxf(l, 1e-30f));
    }
    // every read of another rank's state is consumed: the stores above and
    // the row below need not complete before the arrival
    cluster_arrive_relaxed();
  }
  // the new row: the only row of this (b, h) that is written, by rank 0
  // (every block reads only rows below idx)
  if (rank == 0) {
    for (int d = tid; d < D; d += NTHREADS) {
      ck[static_cast<int64_t>(a.idx) * D + d] = kn_s[d];
      cv[static_cast<int64_t>(a.idx) * D + d] = vn_s[d];
    }
  }
  if (splits > 1) cluster_wait();  // no block leaves while another reads its state
}

template <typename T, typename Q, int D>
cudaError_t launch(const Args& a, int splits, cudaStream_t stream) {
  auto kernel = fused_decode_attention_kernel<T, Q, D>;
  constexpr int bytes = smem_bytes<T, Q, D>();
  static_assert(bytes <= 227 * 1024, "the ring does not fit in shared memory");
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.Hkv, a.B);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, typename Q>
cudaError_t launch_d(const Args& a, int D, int splits, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, Q, 32>(a, splits, stream);
    case 64: return launch<T, Q, 64>(a, splits, stream);
    case 128: return launch<T, Q, 128>(a, splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// cache_f32 / q_f32: 1 for float32, 0 for bfloat16; splits: ranks of a
// (b, h) cluster, 1..8 (the wrapper's split_plan)
extern "C" int fused_decode_attention(const void* q, const void* k_new, const void* v_new,
                                      void* ck, void* cv, void* o, const void* kv_starts,
                                      int L, int B, int Hq, int Hkv, int S, int D, int li,
                                      int idx, int cache_f32, int q_f32, int splits,
                                      float scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 || Hq / Hkv > MAX_G ||
      li < 0 || li >= L || idx < 0 || idx >= S || splits < 1 || splits > MAX_SPLITS) {
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
    err = q_f32 ? launch_d<float, float>(a, D, splits, s)
                : launch_d<float, __nv_bfloat16>(a, D, splits, s);
  } else {
    err = q_f32 ? launch_d<__nv_bfloat16, float>(a, D, splits, s)
                : launch_d<__nv_bfloat16, __nv_bfloat16>(a, D, splits, s);
  }
  return static_cast<int>(err);
}
