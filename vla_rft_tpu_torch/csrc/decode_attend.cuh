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
//   * f32 scores and softmax with bounded exp (exp(max(x, -80))), masked
//     keys contribute exactly 0, a row with no valid key gives 0.
// q is (B, Sq, Hq, D) bf16 with GQA group G = Hq / Hkv; O is written in the
// same layout, bf16.  D = 64.
//
// Layouts (HEADS template flag), one layer's slice:
//   * HEADS = false, "hd":    (rows, S, Hkv*D): position stride Hkv*D, head
//     stride D;
//   * HEADS = true,  "heads": (rows, Hkv, S, D): position stride D, head
//     stride S*D.  The 64 values of one (position, head) are contiguous in
//     both, so the loads below are the same; only the offsets differ, and
//     the two layouts give the same bits.
//
// Design.  A block of 4 warps owns (chunk, kv head h, key split rank).
//   * Chunks.  With SHARED, the rows that share prefix_map[b] form a prefix
//     group, cut in row order into chunks of at most `chunk_rows` rows
//     (chunk_rows * G * Sq query rows in MT = 1 or 4 m16 tiles); without it a
//     chunk is one row.  The block reads prefix_map and every row's
//     kv_lens / q_offset / kv_starts at once, then finds its chunk itself
//     (warp 0 ranks each row inside its group with __match_any_sync and
//     counts the groups' chunks), so nothing is read back to the host and
//     a CUDA graph may replay the call.
//   * Tiles.  The chunk's work is a list of 128-key tiles: first the prefix
//     tiles covering the union of its rows' shared windows, which serve
//     every query row of the chunk (each masked by its own window), so a
//     prefix tile is read once per chunk and not once per row; then each
//     row's own tiles, which serve that row's G * Sq query rows.  Rank r of
//     the cluster takes tiles [r T / R, (r + 1) T / R).
//   * Loads in flight.  Each tile's int8 (or bf16) K and V rows and their
//     bf16 scales go through a 3-stage cp.async ring in shared memory (two
//     tiles in flight while one is multiplied; 16 bytes a copy, a false
//     predicate zero-fills, so positions outside the tile's window read as
//     0 and their scales count as 0); q lands with the first tile.
//   * Products.  Warp w multiplies keys 32w .. 32w + 31 of each tile (and
//     skips a slice the window leaves empty) on mma.sync m16n8k16 (bf16, f32
//     accumulate), the chunk's query rows as MT m16 tiles (padded rows are
//     masked): S = Q K^T with q bf16 from shared memory, K dequantised at
//     fragment load (int8 to f32 by a PRMT and an FADD, packed to bf16
//     exactly, times the scale by a bf16x2 multiply that rounds the exact
//     product, as the fallback does; a lane's 16 bytes of a key hold all
//     four k16 steps: the products' k index is permuted, the sum is over all
//     64 values either way); p in the log2 form (one FFMA, one EX2), the online max
//     and sum per row in the accumulator layout; O += P V with P split
//     into two bf16 terms (p = hi + lo, so P keeps 16 bits: the twins keep
//     P in f32) and V dequantised at fragment load.
//   * Merge.  Each warp's (m, l, O) goes to shared memory; the block merges
//     its four warps in warp order, then the cluster's R ranks merge in rank
//     order over distributed shared memory, rank r writing every R-th
//     output element.  One launch, no scratch, no atomics: the same bits on
//     every run.
//
// What bounds it on an H100.  Decode reads every valid K/V byte once and
// does 4*D flops per (query, key): at the WM shape (G*Sq = 1) far under 1
// flop per byte, so device-memory traffic sets the bound: at mid-rollout
// (B = 10, 2 prefixes of 1088, own 291) 10.7 MB, 3.2 us at 3.35 TB/s.  The
// kernel does not reach it: a block's path is a fixed chain (its rows'
// arguments, the chunk search, the windows, the first tile's latency, the
// warp and cluster merges: about 8 us at B = 10, kernel_trace.py) plus
// about 2 us of dequantisation, products and softmax per 128-key tile,
// which 4 warps a block cannot hide; at 128 rows, with 4 blocks an SM, the
// instructions per K/V value (about 3 to dequantise it) bound it.  Measured on
// an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md section 6, PR 11):
// 0.0178 ms at B = 10 and 0.0799 ms at 128 rows with the f32 scale multiply,
// 3-4 % less with the bf16x2 one (the first design, one block per (row,
// head) with one dependent load chain per lane, took 0.0377 ms at B = 10).
//
// Interface: decode_attend::run<HEADS> launches on the given stream, never
// synchronises, and returns cudaGetLastError().

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace decode_attend {

constexpr int D = 64;
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int TK = 128;         // keys of a tile: warp w multiplies keys 32w .. 32w + 31
constexpr int STAGES = 3;       // ring stages: two tiles in flight while one is multiplied
constexpr int MAX_NQ = 64;      // query rows of a chunk (4 m16 tiles)
constexpr int MAX_SPLITS = 8;   // ranks of a cluster (the portable limit)
constexpr int MAX_ROWS = 1024;  // batch rows and prefix rows the chunk search takes
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float EXP2_FLOOR = -80.0f * LOG2E;  // exp(max(x, -80)) = 2^max(x log2 e, -80 log2 e)

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
  int B, Sq, Hq, Hkv, Sr, Sp, shared_len;
  int n_prefix;                 // B_u, rows of the shared cache
  int chunk_rows;               // rows of a chunk
  float scale;
};

// One ring stage (bytes): K rows, V rows, then their TK bf16 scales each;
// the ring holds 50 KB of int8 tiles, 98 KB of bf16.
template <typename T>
struct Stage {
  static constexpr int KV = TK * D * static_cast<int>(sizeof(T));
  static constexpr int K = 0, V = KV, KS = 2 * KV, VS = 2 * KV + TK * 2;
  static constexpr int BYTES = 2 * KV + 2 * TK * 2;
};

// The merge area (floats): per warp, then for the block, (O, m, l) of the
// NR = 16 MT padded query rows; O rows LD apart (padded: the fragment-order
// stores hit distinct banks).
template <int MT>
struct Merge {
  static constexpr int NR = 16 * MT;
  static constexpr int LD = D + 4;
  static constexpr int M = NR * LD, L = NR * LD + NR;
  static constexpr int FLOATS = NR * LD + 2 * NR;
  static constexpr int BYTES = (NWARPS + 1) * FLOATS * 4;
};

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// Dynamic shared memory: the chunk's q (NR rows of D bf16), then one area
// used in turn by the rows' arguments and the chunk search (6 x MAX_ROWS
// ints), the ring and the merge.
template <typename T, int MT>
__host__ __device__ constexpr int work_bytes() {
  return cmax(cmax(STAGES * Stage<T>::BYTES, Merge<MT>::BYTES), 6 * MAX_ROWS * 4);
}
template <typename T, int MT>
__host__ __device__ constexpr int smem_bytes() {
  return 16 * MT * D * 2 + work_bytes<T, MT>();
}

// element offset of (row, head h, position j) in a layer slice of S positions
template <bool HEADS>
__device__ __forceinline__ int64_t kv_offset(int row, int h, int j, int S, int Hkv) {
  return HEADS ? ((static_cast<int64_t>(row) * Hkv + h) * S + j) * D
               : (static_cast<int64_t>(row) * S + j) * (Hkv * D) + h * D;
}

// Byte `byte` of an int8 word as a float, exactly, from the word with 128
// added to each byte (w ^ 0x80808080): that byte as the low mantissa bits of
// 2^23 less 2^23 + 128 (a PRMT and an FADD, where I2F runs at a quarter of
// the FP32 rate).
__device__ __forceinline__ float int8_at(uint32_t biased, int byte) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | byte)) - 8388736.0f;
}
__device__ __forceinline__ uint32_t bias8(uint32_t w) { return w ^ 0x80808080u; }

// a * b on bf16 pairs, each product exact and then rounded to the nearest
// bf16: for an int8 value (exact in bf16) times its bf16 scale, the f32
// product rounded to bf16 that the fallback computes.
__device__ __forceinline__ uint32_t hmul2_bf16(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// bf16 pairs (lo, hi) of int8 bytes (the word biased by bias8) times the
// scales s2 (a bf16 pair).
__device__ __forceinline__ uint32_t deq2(uint32_t w, int byte, uint32_t s2) {
  return hmul2_bf16(pack_bf16(int8_at(w, byte), int8_at(w, byte + 1)), s2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// The first index i of tiles[0 .. n] with tiles[i + 1] > t (tiles ascending).
__device__ __forceinline__ int owner_of(const int* tiles, int n, int t) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (tiles[mid] <= t) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// grid (splits, Hkv, slots), cluster (splits, 1, 1).
template <typename T, bool SHARED, bool HEADS, int MT>
__global__ void __launch_bounds__(NTHREADS, MT == 1 ? 4 : 1) decode_attend_kernel(Args a) {
  constexpr bool INT8 = sizeof(T) == 1;
  constexpr int NR = 16 * MT;
  using ST = Stage<T>;
  using MG = Merge<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int rows_s[MAX_NQ];                      // the chunk's batch rows
  __shared__ int own_lo_s[MAX_NQ], own_hi_s[MAX_NQ];  // each row's own window (own index)
  __shared__ int own_t0_s[MAX_NQ];                    // its first own tile (in TK positions)
  __shared__ int tiles_s[MAX_NQ + 1];                 // own tiles of rows before it
  __shared__ int win_s[5][NR];  // per query row: prefix window, own window, chunk row
  __shared__ int meta_s[6];     // n_rows, prefix row, prefix window lo / hi, first tile, tiles

  const int rank = blockIdx.x, splits = gridDim.x;
  const int h = blockIdx.y, slot = blockIdx.z;
  const int G = a.Hq / a.Hkv, GSq = G * a.Sq;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, qd = lane & 3;
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* work = smem + NR * D * 2;
  const uint32_t work_u = smem_u32(work);
  const int base = SHARED ? a.shared_len : 0;  // absolute position of own slot 0

  // ---- the rows' arguments, all read at once (with SHARED every row's,
  // indexed by row; without, the block's row at index 0)
  int* pm_s = reinterpret_cast<int*>(work);  // prefix row of each row, -1 if out of range
  int* rank_s = pm_s + MAX_ROWS;             // index of each row inside its group
  int* cnt_s = rank_s + MAX_ROWS;            // rows of each group
  int* kl_s = cnt_s + MAX_ROWS;              // kv_lens, q_offset, kv_starts
  int* qo_s = kl_s + MAX_ROWS;
  int* ks_s = qo_s + MAX_ROWS;
  if (SHARED) {
    for (int u = tid; u < a.n_prefix; u += NTHREADS) cnt_s[u] = 0;
    for (int b = tid; b < a.B; b += NTHREADS) {
      const int u = a.prefix_map[b];
      pm_s[b] = u >= 0 && u < a.n_prefix ? u : -1;
      kl_s[b] = a.kv_lens[b], qo_s[b] = a.q_offset[b], ks_s[b] = a.kv_starts[b];
    }
  } else if (tid == 0 && slot < a.B) {
    kl_s[0] = a.kv_lens[slot], qo_s[0] = a.q_offset[slot], ks_s[0] = a.kv_starts[slot];
  }
  __syncthreads();

  // ---- the chunk: its rows
  if (SHARED) {
    if (warp == 0) {
      for (int b0 = 0; b0 < a.B; b0 += 32) {  // rows in order, 32 at a time
        const int b = b0 + lane;
        const int u = b < a.B ? pm_s[b] : -1;
        const unsigned same = __match_any_sync(0xffffffffu, u);
        const int before = __popc(same & ((1u << lane) - 1u));
        const int run = u >= 0 ? cnt_s[u] : 0;
        __syncwarp();
        if (u >= 0) {
          rank_s[b] = run + before;
          if ((same >> lane) == 1u) cnt_s[u] = run + before + 1;  // the group's last lane
        }
        __syncwarp();
      }
      // slot -> (group u, chunk j): the groups' chunks in group order
      int found_u = -1, found_j = 0, total = 0;
      for (int u0 = 0; u0 < a.n_prefix; u0 += 32) {
        const int u = u0 + lane;
        const int n = u < a.n_prefix ? (cnt_s[u] + a.chunk_rows - 1) / a.chunk_rows : 0;
        int x = n;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, off);
          if (lane >= off) x += y;
        }
        const int first = total + x - n;
        const unsigned hit = __ballot_sync(0xffffffffu, slot >= first && slot < first + n);
        if (hit) {
          const int src = __ffs(hit) - 1;
          found_u = __shfl_sync(0xffffffffu, u, src);
          found_j = slot - __shfl_sync(0xffffffffu, first, src);
          break;
        }
        total += __shfl_sync(0xffffffffu, x, 31);
      }
      if (lane == 0) {
        meta_s[0] = found_u < 0 ? 0 : min(a.chunk_rows, cnt_s[found_u] - found_j * a.chunk_rows);
        meta_s[1] = found_u;
        meta_s[2] = found_j;
      }
    }
    __syncthreads();
    const int u = meta_s[1], j = meta_s[2];
    for (int b = tid; b < a.B; b += NTHREADS) {
      if (u >= 0 && pm_s[b] == u && rank_s[b] / a.chunk_rows == j)
        rows_s[rank_s[b] - j * a.chunk_rows] = b;
    }
  } else if (tid == 0) {
    rows_s[0] = slot;
    meta_s[0] = slot < a.B ? 1 : 0;
    meta_s[1] = 0;
  }
  __syncthreads();
  const int n_rows = meta_s[0], pu = meta_s[1];
  if (n_rows == 0) return;  // the same for every rank of the cluster
  auto arg_row = [&](int c) { return SHARED ? rows_s[c] : 0; };  // chunk row c in the args

  // ---- q (by cp.async, landing with the first tile), windows and tiles
  for (int idx = tid; idx < NR * (D / 8); idx += NTHREADS) {
    const int r = idx / (D / 8), ch = idx % (D / 8), c = r / GSq;
    const bool ok = c < n_rows;
    const __nv_bfloat16* src = a.q;
    if (ok) {
      const int rr = r % GSq, gq = rr / a.Sq, i = rr % a.Sq;
      src = a.q + ((static_cast<int64_t>(rows_s[c]) * a.Sq + i) * a.Hq + h * G + gq) * D + ch * 8;
    }
    cp_async16(smem_u32(q_s + r * D + ch * 8), src, ok);
  }
  if (warp == 0) {
    int run = 0, p_lo = 0x7fffffff, p_hi = 0;
    for (int c0 = 0; c0 < n_rows; c0 += 32) {
      const int c = c0 + lane;
      int n_t = 0;
      if (c < n_rows) {
        const int ar = arg_row(c);
        const int kv_start = max(ks_s[ar], 0);
        const int hi = min(kl_s[ar], qo_s[ar] + a.Sq);  // no query sees a key past it
        if (SHARED) {
          const int lo = min(kv_start, a.shared_len), sh_hi = max(lo, min(a.shared_len, hi));
          if (sh_hi > lo) p_lo = min(p_lo, lo), p_hi = max(p_hi, sh_hi);
        }
        const int o_lo = min(max(kv_start - base, 0), a.Sr);
        const int o_hi = max(o_lo, min(a.Sr, hi - base));
        own_lo_s[c] = o_lo;
        own_hi_s[c] = o_hi;
        own_t0_s[c] = o_lo / TK;
        n_t = o_hi > o_lo ? (o_hi + TK - 1) / TK - o_lo / TK : 0;
      }
      int x = n_t;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      if (c < n_rows) tiles_s[c] = run + x - n_t;
      run += __shfl_sync(0xffffffffu, x, 31);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      p_lo = min(p_lo, __shfl_xor_sync(0xffffffffu, p_lo, off));
      p_hi = max(p_hi, __shfl_xor_sync(0xffffffffu, p_hi, off));
    }
    if (lane == 0) {
      tiles_s[n_rows] = run;
      const bool any = p_hi > p_lo;
      meta_s[2] = any ? p_lo : 0;
      meta_s[3] = any ? p_hi : 0;
      meta_s[4] = any ? p_lo / TK : 0;
      meta_s[5] = any ? (p_hi + TK - 1) / TK - p_lo / TK : 0;
    }
  }
  // per query row r = c * G * Sq + gq * Sq + i (row c of the chunk, query
  // head h G + gq, position i): its windows in prefix and own positions
  for (int r = tid; r < NR; r += NTHREADS) {
    const int c = r / GSq;
    int plo = 0, phi = 0, olo = 0, ohi = 0, own = -1;
    if (c < n_rows) {
      const int ar = arg_row(c), i = (r % GSq) % a.Sq;
      const int lo = max(ks_s[ar], 0);
      const int hi = min(kl_s[ar], qo_s[ar] + i + 1);
      if (SHARED) plo = lo, phi = min(hi, a.shared_len);
      olo = lo - base, ohi = min(hi - base, a.Sr), own = c;
    }
    win_s[0][r] = plo, win_s[1][r] = phi, win_s[2][r] = olo, win_s[3][r] = ohi, win_s[4][r] = own;
  }
  __syncthreads();  // the arguments' area is free; the windows and tiles are in place
  const int p_lo = meta_s[2], p_hi = meta_s[3], p_t0 = meta_s[4], n_pt = meta_s[5];
  const int n_tiles = n_pt + tiles_s[n_rows];
  const int t_begin = static_cast<int>(static_cast<int64_t>(n_tiles) * rank / splits);
  const int t_end = static_cast<int>(static_cast<int64_t>(n_tiles) * (rank + 1) / splits);

  // tile t: chunk row c (-1: a prefix tile), its first position j0 and the
  // window [lo, hi) its loads keep (the chunk's prefix union or the row's own)
  auto tile_of = [&](int t, int& c, int& j0, int& lo, int& hi) {
    if (t < n_pt) {
      c = -1, j0 = (p_t0 + t) * TK, lo = p_lo, hi = p_hi;
    } else {
      c = owner_of(tiles_s, n_rows, t - n_pt);
      j0 = (own_t0_s[c] + t - n_pt - tiles_s[c]) * TK, lo = own_lo_s[c], hi = own_hi_s[c];
    }
  };
  auto load = [&](int t, int stage) {
    int c, j0, lo, hi;
    tile_of(t, c, j0, lo, hi);
    const bool pre = c < 0;
    const int row = pre ? pu : rows_s[c], S = pre ? a.Sp : a.Sr;
    const T* kb = static_cast<const T*>(pre ? a.k_sh : a.k_own);
    const T* vb = static_cast<const T*>(pre ? a.v_sh : a.v_own);
    const uint32_t st = work_u + stage * ST::BYTES;
    constexpr int CH = D * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks of a key row
#pragma unroll
    for (int idx = tid; idx < TK * CH; idx += NTHREADS) {
      const int kk = idx / CH, ch = idx % CH, j = j0 + kk;
      const bool ok = j >= lo && j < hi;  // outside, K and V read as 0
      const int64_t off = ok ? kv_offset<HEADS>(row, h, j, S, a.Hkv) + ch * (16 / sizeof(T)) : 0;
      cp_async16(st + ST::K + idx * 16, kb + off, ok);
      cp_async16(st + ST::V + idx * 16, vb + off, ok);
    }
    if (INT8 && tid < 2 * TK / 8) {  // 8 scales a thread: K (threads 0-15), V (16-31)
      const bool is_v = tid >= TK / 8;
      const int k8 = (tid % (TK / 8)) * 8, j = j0 + k8;
      const __nv_bfloat16* sp = (is_v ? (pre ? a.vs_sh : a.vs_own) : (pre ? a.ks_sh : a.ks_own)) +
                                (static_cast<int64_t>(row) * a.Hkv + h) * S;
      const uint32_t dst = st + (is_v ? ST::VS : ST::KS) + k8 * 2;
      // scales outside the window may be anything: the products zero them
      if (j + 8 <= S && (reinterpret_cast<uintptr_t>(sp + j) & 15u) == 0) {
        cp_async16(dst, sp + j, true);
      } else {  // the cache's end, or scales off 16-byte boundaries
        __nv_bfloat16* d = reinterpret_cast<__nv_bfloat16*>(work + (dst - work_u));
#pragma unroll
        for (int e = 0; e < 8; ++e) d[e] = j + e < S ? sp[j + e] : __float2bfloat16(0.0f);
      }
    }
  };

  float acc[MT][D / 8][4], m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) m_run[mt][hf] = NEG_INF, l_run[mt][hf] = 0.0f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.0f;
  }
  const float scale_log2 = a.scale * LOG2E;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (t_begin + s < t_end) load(t_begin + s, s);
    cp_async_commit();  // q rides with the first group
  }
  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    cp_async_wait<STAGES - 2>();  // tile t has landed
    __syncthreads();              // ... for every thread; every warp is done with tile t - 1
    if (t + STAGES - 1 < t_end) load(t + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    const unsigned char* st = work + (it % STAGES) * ST::BYTES;
    int c, j0, lo, hi;
    tile_of(t, c, j0, lo, hi);
    const int kw0 = 32 * warp;  // the warp's first key in the tile
    if (j0 + kw0 >= hi || j0 + kw0 + 32 <= lo) continue;  // none of its keys was loaded
    // a key's scale counts only inside the window (its K/V bytes are 0 outside)
    auto scale_at = [&](int off, int key) {
      const float s = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(st + off)[key]);
      return j0 + key >= lo && j0 + key < hi ? s : 0.0f;
    };

    // K as B fragments: key 8 tt + g of the warp's 32, the lane's 16 values
    // 16 qd .. 16 qd + 15 (k16 step kk: values 4 kk .. 4 kk + 3)
    uint32_t kb[4][D / 16][2];
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      const int key = kw0 + 8 * tt + g;
      if constexpr (INT8) {
        const uint4 w = *reinterpret_cast<const uint4*>(st + ST::K + key * D + 16 * qd);
        const float sk = scale_at(ST::KS, key);
        const uint32_t s = pack_bf16(sk, sk);
        const uint32_t words[4] = {bias8(w.x), bias8(w.y), bias8(w.z), bias8(w.w)};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          kb[tt][kk][0] = deq2(words[kk], 0, s);
          kb[tt][kk][1] = deq2(words[kk], 2, s);
        }
      } else {
        const uint4* p = reinterpret_cast<const uint4*>(st + ST::K + key * D * 2 + 32 * qd);
        const uint4 w0 = p[0], w1 = p[1];
        const uint32_t words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          kb[tt][kk][0] = words[2 * kk];
          kb[tt][kk][1] = words[2 * kk + 1];
        }
      }
    }
    // V as B fragments of k16 step ks (keys 16 ks .. of the warp's 32):
    // keys 2 qd, 2 qd + 1, 2 qd + 8, 2 qd + 9 of it (the P fragment's k
    // index), values 8 g .. 8 g + 7 (n8 tile j holds value 8 n + j in its
    // column n)
    uint32_t vb[2][D / 8][2];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int k0 = kw0 + 16 * ks;
      const int kv[4] = {k0 + 2 * qd, k0 + 2 * qd + 1, k0 + 2 * qd + 8, k0 + 2 * qd + 9};
      if constexpr (INT8) {
        uint32_t w[4][2];
        float s[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const uint2 v2 = *reinterpret_cast<const uint2*>(st + ST::V + kv[x] * D + 8 * g);
          w[x][0] = bias8(v2.x), w[x][1] = bias8(v2.y);
          s[x] = scale_at(ST::VS, kv[x]);
        }
        const uint32_t s01 = pack_bf16(s[0], s[1]), s23 = pack_bf16(s[2], s[3]);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int wi = j >> 2, by = j & 3;
          vb[ks][j][0] = hmul2_bf16(pack_bf16(int8_at(w[0][wi], by), int8_at(w[1][wi], by)), s01);
          vb[ks][j][1] = hmul2_bf16(pack_bf16(int8_at(w[2][wi], by), int8_at(w[3][wi], by)), s23);
        }
      } else {
        uint4 w[4];
#pragma unroll
        for (int x = 0; x < 4; ++x)
          w[x] = *reinterpret_cast<const uint4*>(st + ST::V + kv[x] * D * 2 + 16 * g);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int wi = j >> 1;
          const uint32_t sel = (j & 1) ? 0x7632u : 0x5410u;
          vb[ks][j][0] = __byte_perm((&w[0].x)[wi], (&w[1].x)[wi], sel);
          vb[ks][j][1] = __byte_perm((&w[2].x)[wi], (&w[3].x)[wi], sel);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // S = Q K^T for rows 16 mt .. 16 mt + 15 and the warp's 32 keys
      float s[4][4];
#pragma unroll
      for (int tt = 0; tt < 4; ++tt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[tt][e] = 0.0f;
      {
        const uint4* q0 = reinterpret_cast<const uint4*>(q_s + (16 * mt + g) * D + 16 * qd);
        const uint4* q1 = reinterpret_cast<const uint4*>(q_s + (16 * mt + g + 8) * D + 16 * qd);
        const uint4 x0 = q0[0], x1 = q0[1], y0 = q1[0], y1 = q1[1];
        const uint32_t r0[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const uint32_t r1[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t qa[4] = {r0[2 * kk], r1[2 * kk], r0[2 * kk + 1], r1[2 * kk + 1]};
#pragma unroll
          for (int tt = 0; tt < 4; ++tt) mma_bf16(s[tt], qa, kb[tt][kk][0], kb[tt][kk][1]);
        }
      }
      // masks, the online max and sum: element e of n8 tile tt is row
      // 16 mt + g + 8 (e >> 1), key j0 + kw0 + 8 tt + 2 qd + (e & 1)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * mt + g + 8 * hf;
        int wlo, whi;
        if (c < 0) {
          wlo = win_s[0][r], whi = win_s[1][r];
        } else {
          const bool mine = win_s[4][r] == c;
          wlo = mine ? win_s[2][r] : 0, whi = mine ? win_s[3][r] : 0;
        }
        bool ok[4][2];
        float mx = NEG_INF;
#pragma unroll
        for (int tt = 0; tt < 4; ++tt)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const int j = j0 + kw0 + 8 * tt + 2 * qd + e1;
            ok[tt][e1] = j >= wlo && j < whi;
            if (ok[tt][e1]) mx = fmaxf(mx, s[tt][2 * hf + e1] * scale_log2);
          }
        mx = quad_max(mx);
        const float m_new = fmaxf(m_run[mt][hf], mx);
        const float alpha = exp2_approx(fmaxf(m_run[mt][hf] - m_new, EXP2_FLOOR));
        m_run[mt][hf] = m_new;
        float sum = 0.0f;
#pragma unroll
        for (int tt = 0; tt < 4; ++tt)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const float x = s[tt][2 * hf + e1];
            const float p =
                ok[tt][e1] ? exp2_approx(fmaxf(fmaf(x, scale_log2, -m_new), EXP2_FLOOR)) : 0.0f;
            s[tt][2 * hf + e1] = p;
            sum += p;
          }
        l_run[mt][hf] = l_run[mt][hf] * alpha + sum;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[mt][j][2 * hf] *= alpha;
          acc[mt][j][2 * hf + 1] *= alpha;
        }
      }
      // O += P V, k16 step ks over keys 16 ks ..: P's A fragment is the
      // accumulators of n8 tiles 2 ks and 2 ks + 1 in the order (row g, keys
      // 0-7), (row g + 8, keys 0-7), (row g, keys 8-15), (row g + 8, keys
      // 8-15), in two bf16 terms
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int tt = 2 * ks + (x >> 1), e = (x & 1) * 2;
          const float p0 = s[tt][e], p1 = s[tt][e + 1];
          ah[x] = pack_bf16(p0, p1);
          const __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&ah[x]);
          al[x] = pack_bf16(p0 - __low2float(hv), p1 - __high2float(hv));
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          mma_bf16(acc[mt][j], ah, vb[ks][j][0], vb[ks][j][1]);
          mma_bf16(acc[mt][j], al, vb[ks][j][0], vb[ks][j][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // ---- merge: the warps in warp order, then the ranks in rank order
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = l_run[mt][hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_run[mt][hf] = l;
    }
  __syncthreads();  // every warp is done with the ring
  float* mg = reinterpret_cast<float*>(work);
  {
    float* ws = mg + warp * MG::FLOATS;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * mt + g + 8 * hf;
        if (qd == 0) ws[MG::M + r] = m_run[mt][hf], ws[MG::L + r] = l_run[mt][hf];
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1)
            ws[r * MG::LD + 8 * (2 * qd + e1) + j] = acc[mt][j][2 * hf + e1];
      }
  }
  __syncthreads();
  float* bs = mg + NWARPS * MG::FLOATS;  // the block's merged state
  const int nq = n_rows * GSq;
  for (int idx = tid; idx < nq * D; idx += NTHREADS) {
    const int r = idx / D, d = idx % D;
    float m = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m = fmaxf(m, mg[w * MG::FLOATS + MG::M + r]);
    float l = 0.0f, o = 0.0f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float* ws = mg + w * MG::FLOATS;
      const float f = exp2_approx(fmaxf(ws[MG::M + r] - m, EXP2_FLOOR));
      l += ws[MG::L + r] * f;
      o += ws[r * MG::LD + d] * f;
    }
    bs[r * MG::LD + d] = o;
    if (d == 0) bs[MG::M + r] = m, bs[MG::L + r] = l;
  }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();  // every rank's state is complete
  for (int idx = rank * NTHREADS + tid; idx < nq * D; idx += splits * NTHREADS) {
    const int r = idx / D, d = idx % D;
    float m = NEG_INF;
    for (int k = 0; k < splits; ++k) m = fmaxf(m, *cluster.map_shared_rank(bs + MG::M + r, k));
    float l = 0.0f, o = 0.0f;
    for (int k = 0; k < splits; ++k) {
      const float f = exp2_approx(fmaxf(*cluster.map_shared_rank(bs + MG::M + r, k) - m,
                                        EXP2_FLOOR));
      l += *cluster.map_shared_rank(bs + MG::L + r, k) * f;
      o += *cluster.map_shared_rank(bs + r * MG::LD + d, k) * f;
    }
    const int c = r / GSq, rr = r % GSq, gq = rr / a.Sq, i = rr % a.Sq;
    a.o[((static_cast<int64_t>(rows_s[c]) * a.Sq + i) * a.Hq + h * G + gq) * D + d] =
        __float2bfloat16(o / fmaxf(l, 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its state
}

template <typename T, bool SHARED, bool HEADS, int MT>
cudaError_t launch(const Args& a, int splits, int slots, cudaStream_t stream) {
  auto kernel = decode_attend_kernel<T, SHARED, HEADS, MT>;
  constexpr int bytes = smem_bytes<T, MT>();
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.Hkv, slots);
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

// One m16 tile of query rows (the WM's decode: G * Sq <= 8) or four.
template <typename T, bool SHARED, bool HEADS>
cudaError_t launch_rows(const Args& a, int splits, int slots, cudaStream_t stream) {
  return a.chunk_rows * (a.Hq / a.Hkv) * a.Sq <= 16
             ? launch<T, SHARED, HEADS, 1>(a, splits, slots, stream)
             : launch<T, SHARED, HEADS, 4>(a, splits, slots, stream);
}

// The body of both C entry points; HEADS picks the layout.  The plan
// (chunk_rows, slots, splits) is the wrapper's (decode_plan in
// ops/decode_attention_hd.py): slots must cover every chunk.
template <bool HEADS>
int run(const void* q, void* o, const void* k_own, const void* v_own, const void* ks_own,
        const void* vs_own, const void* k_sh, const void* v_sh, const void* ks_sh,
        const void* vs_sh, const void* prefix_map, const void* kv_lens, const void* q_offset,
        const void* kv_starts, int B, int Sq, int Hq, int Hkv, int head_dim, int Sr, int Sp,
        int shared_len, int int8_cache, int shared, float scale, int n_prefix, int chunk_rows,
        int slots, int splits, void* stream) {
  if (head_dim != D || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || B <= 0 ||
      chunk_rows < 1 || chunk_rows * (Hq / Hkv) * Sq > MAX_NQ || splits < 1 ||
      splits > MAX_SPLITS || slots < 1 || (shared && (B > MAX_ROWS || n_prefix < 1 ||
      n_prefix > MAX_ROWS)) || (!shared && chunk_rows != 1)) {
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
  a.B = B;
  a.Sq = Sq;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sr = Sr;
  a.Sp = Sp;
  a.shared_len = shared ? shared_len : 0;
  a.n_prefix = shared ? n_prefix : 0;
  a.chunk_rows = chunk_rows;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (int8_cache) {
    err = shared ? launch_rows<int8_t, true, HEADS>(a, splits, slots, s)
                 : launch_rows<int8_t, false, HEADS>(a, splits, slots, s);
  } else {
    err = shared ? launch_rows<__nv_bfloat16, true, HEADS>(a, splits, slots, s)
                 : launch_rows<__nv_bfloat16, false, HEADS>(a, splits, slots, s);
  }
  return static_cast<int>(err);
}

}  // namespace decode_attend
