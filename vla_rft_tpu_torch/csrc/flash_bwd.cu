// Flash-attention backward for Hopper (sm_90a): dQ (#2) and dK/dV (#3).
//
// Replaces the TPU kernels vla_rft_tpu/ops/attention.py::_dq_kernel and
// ::_dkv_kernel (the Pallas backward behind `attention(impl="pallas")`'s
// custom VJP).  Same function, under the forward's masks (kernel #1,
// csrc/flash_fwd.cu):
//   * q/o/dO (B, Sq, Hq, D), k/v (B, Sk, Hkv, D) bf16, lse/delta (B, Sq, Hq)
//     f32, all contiguous; GQA maps query head h to kv head h / (Hq / Hkv);
//   * key j of row b is valid for query i when kv_starts[b] <= j <
//     kv_lens[b] and, when causal, j <= q_offset[b] + i;
//   * p = exp(max(s - lse, -80)) on valid lanes and exactly 0 elsewhere, so
//     a fully-masked row (lse = -1e30) contributes nothing;
//   * dS = p (dP - delta) scale with dP = dO V^T and delta = sum_D dO * O
//     (the wrapper computes delta in f32, as the reference does outside
//     Pallas);
//   * dQ = dS K;  dV = p^T dO and dK = dS^T Q, summed over the G query heads
//     of the kv group.  f32 accumulation, bf16 dq/dk/dv out.
//
// Design.
//   #2: register-resident, #3's design turned around.  A block of 4 warps
//       (one warpgroup) owns a 64-query tile of one query head and batch
//       row, each warp 16 queries; the tile's Q and dO are staged once
//       in shared memory (read into A fragments by ldmatrix) and its lse and
//       delta sit in registers.  It streams the 64-key K/V
//       tiles that hold a valid key for some query of the tile through a
//       cp.async double-buffered ring (the next tile flies during this
//       tile's products).  Per tile:
//         S = Q K^T, dP = dO V^T   into registers, Q/dO as A, K/V as B: at
//                   D = 64 on wgmma m64n64k16 (B the swizzled K/V rows, D
//                   as the reduction), at D = 128 on mma.sync m16n8k16 with
//                   ldmatrix, 32 keys at a time;
//         p, dS     the element pass on the accumulators, as #3's: p =
//                   2^max(s scale log2 e - lse log2 e, -80 log2 e), exactly
//                   0 on masked lanes, dS = p (dP - delta) scale; masks only
//                   where the tile cuts a kv_starts / kv_lens edge, the
//                   ragged last query tile or the warp's causal diagonal;
//         dQ += dS K   dS rounded to bf16 straight from the accumulator
//                   layout into A fragments, K as B with the keys as the
//                   reduction: at D = 64 on wgmma m64n64k16 (K transposed,
//                   MN-major, as #3 takes dO), at D = 128 by ldmatrix.trans.
//       dQ never leaves registers until the epilogue; no atomics, so dq is
//       the same bits on every run.  The query tile is the grid's slowest
//       axis and, under causal masking, the last tiles (which see the most
//       keys) start first.
//   #3: register-resident.  A block of 4 warps (one warpgroup) owns a
//       64-key tile of one kv head and batch row, each warp 16 keys; its K
//       and V tiles are staged once, and it walks the (query head of the kv
//       group, 64-query tile) pairs that can see one of its keys, with the
//       next pair's Q, dO, lse and delta double-buffered in shared memory by
//       cp.async (16 bytes a copy for Q/dO, 4 for lse and delta) while the
//       current pair is multiplied.  Per pair, 32 queries at a time (few
//       enough live registers for three blocks per SM at D = 64):
//         S^T = K Q^T, dP^T = V dO^T   into registers, K/V as A, Q/dO as B:
//                   at D = 64 on wgmma m64n32k16 (A: K/V fragments read
//                   into registers once for the block; B: the Q/dO rows,
//                   read once for the warpgroup), at D = 128 on mma.sync
//                   m16n8k16 with ldmatrix;
//         p, dS     the element pass on the accumulators: p = 2^max(s
//                   scale log2 e - lse log2 e, -80 log2 e) (one FFMA and
//                   one EX2), exactly 0 on masked lanes, dS = p (dP -
//                   delta) scale; masks only where a pair cuts a kv_starts /
//                   kv_lens edge, the ragged last query tile or the causal
//                   diagonal of the warp's keys; halves wholly above the
//                   keys' diagonal are skipped;
//         dV += p^T dO, dK += dS^T Q   p^T and dS^T rounded to bf16 and used
//                   directly as A fragments (the accumulator layout is the A
//                   fragment layout, for mma.sync and wgmma alike), dO and Q
//                   as B: at D = 64 on wgmma m64n64k16 with B's queries as
//                   K (transposed), at D = 128 through ldmatrix.trans;
//       dK and dV never leave registers until the epilogue.  Shared-memory
//       rows are XOR-swizzled in 16-byte chunks (at D = 64 exactly wgmma's
//       128-byte swizzle atoms, on 1024-byte boundaries), so ldmatrix and
//       cp.async are free of bank conflicts.  Under causal masking the key
//       tiles with the most query tiles run first (the key tile is the
//       slowest grid axis; the low tiles see the most queries).  The
//       wrapper may split a key tile's pairs over a cluster of `splits`
//       blocks (rank r takes pairs r, r + splits, ...); the ranks' f32
//       dK/dV are then summed from distributed shared memory in rank
//       order, so dK/dV are the same bits on every run, with no float
//       atomics.  The dynamic shared-memory limits are raised once per
//       device (flash_bwd_setup).
// Unlike the TPU kernels, nothing is padded to block multiples: ragged
// tiles are zero-filled in shared memory and masked by index.  p and dS are
// rounded to bf16 for the second products, as #1 rounds P.
//
// What bounds it on an H100.  At the VLA-adapter shape (B = 16, S = 352,
// Hq/Hkv = 14/2, D = 64, causal) one layer's backward is about
// 12 GFLOP (4 products over the causal half of S x S per head) against
// about 46 MB of q/k/v/o/dO/dq/dk/dv, about 260 FLOP per byte: near the
// card's ~295 FLOP/byte bf16 ridge, so both bounds are ~12-14 us.  At the
// WM-SFT shape (B = 4, S = 1663, 16/16 heads) it is about 79 GFLOP against
// 110 MB, bound by operations (~80 us).  Both kernels pay one MUFU.EX2 a
// score (16 a clock per SM) beside their products; #2 does three products
// where #3 does four and streams K/V instead of Q/dO/lse/delta.
// Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py, PERF.md): #3 on
// wgmma took 0.067 ms at the VLA-adapter shape and 0.220 ms at WM-SFT
// (on mma.sync 0.079 / 0.266, where the Q/dO stream, the products and the
// element pass each took about a third); #2's first design (WMMA 16x16x16
// with S and dP through f32 shared memory and a scalar element pass) took
// 0.154 / 0.71 ms, this one 0.040 / 0.149 ms (PERF.md section 6, PR 11).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu
// Interface: plain C (flash_bwd_setup, flash_bwd_dq_bf16,
// flash_bwd_dkv_bf16), loaded with ctypes; each launch function launches on
// the given stream, never synchronises, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

constexpr int NWARPS = 4;  // one warpgroup, 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float EXP_FLOOR = -80.0f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float EXP2_FLOOR = EXP_FLOOR * LOG2E;  // exp(max(x, -80)) = 2^max(x log2 e, -80 log2 e)
// wgmma's shared-memory matrix descriptor of a tile in the 128-byte
// swizzle layout (rows of 128 bytes, 16-byte chunk c of row r at c ^ r % 8,
// on a 1024-byte boundary) from `saddr`: the 8-row groups 1024 bytes apart;
// the leading byte offset is unused, the operand being one 128-byte row
// wide (measured: 16, 1024 and 2048 give the same bits).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  constexpr uint64_t LBO = 16 >> 4, SBO = 1024 >> 4;
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | LBO << 16 | SBO << 32 | (uint64_t)1 << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The compiler takes a wgmma's registers as read and written when it is
// issued, but the warpgroup reads its A fragments and writes its
// accumulators until the wait: after the wait, these empty asm statements
// "write" them, so no read of an accumulator moves above the wait and no
// A fragment's register is reused before it.
template <int N>
__device__ __forceinline__ void hold(float (&d)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[n][e])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[n][e])::"memory");
}

// d (64 x N, f32, the warpgroup's accumulator: warp w rows 16w .. 16w + 15
// in mma.sync's m16n8 layout, n8 tile j in d[j]) += A (registers, mma.sync's
// A fragment per warp) times B (N x 16 at `desc`; TB: B's N dimension is
// contiguous in memory).
template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<32, 0>(float (&d)[4][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 1>(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64, 0>(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]),
        "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]),
        "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]),
        "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]),
        "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]),
        "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// 64 rows of D bf16 (global row stride `gstride` elements) into a swizzled
// shared tile by cp.async; rows at or beyond `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src, int64_t gstride,
                                          int valid) {
  constexpr int CH = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += NTHREADS) {
    const int r = idx / CH, c = idx % CH;
    const bool ok = r < valid;
    cp_async16(dst + swz(r, c, D * 2), ok ? src + r * gstride + c * 8 : src, ok);
  }
}


// ------------------------------------------------------------------ #2: dQ
namespace bwd_dq {

// Shared memory (bytes) from a 1024-byte boundary: the block's Q and dO
// tiles, then two stages of the streamed K and V tiles; rows of D bf16,
// XOR-swizzled in 16-byte chunks (at D = 64 wgmma's 128-byte swizzle).
template <int D>
struct Cfg {
  static constexpr int ROW = D * 2;
  static constexpr int TILE = 64 * ROW;
  static constexpr int Q_OFF = 0, DO_OFF = TILE;
  static constexpr int STAGE0 = 2 * TILE;
  static constexpr int K = 0, V = TILE;  // in a stage
  static constexpr int STAGE = 2 * TILE;
  static constexpr int BYTES = STAGE0 + 2 * STAGE + 1024;  // + alignment of the base
};

// grid (Hq, B, query tiles): the query tile is the slowest axis and, under
// causal masking, runs from the last tile (which sees the most keys) down.
template <int D>
__global__ void __launch_bounds__(NTHREADS, 2)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, const int* __restrict__ kv_lens,
                    const int* __restrict__ q_offset, const int* __restrict__ kv_starts,
                    int Sq, int Sk, int Hq, int Hkv, float scale, int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // wgmma's 128-byte swizzle reads address bits, so tiles sit on 1024 bytes
  const uint32_t s_base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = s_base + C::Q_OFF, do_s = s_base + C::DO_OFF;

  const int n_qt = (Sq + 63) / 64;
  const int qt = causal ? n_qt - 1 - static_cast<int>(blockIdx.z) : static_cast<int>(blockIdx.z);
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;

  const int q0 = qt * 64;
  const int q_rows = min(64, Sq - q0);
  const int kv_len = min(kv_lens[b], Sk);
  const int kv_start = max(kv_starts[b], 0);
  const int q_off = q_offset[b];
  const int64_t q_stride = (int64_t)Hq * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t row0 = ((int64_t)b * Sq + q0) * Hq + h;  // (row, head) of the tile's first query

  // Key tiles that can hold a valid key for some query of this tile.
  const int t_begin = kv_start / 64;
  int t_end = (kv_len + 63) / 64;
  if (causal) {
    const int last_q = q_off + q0 + q_rows - 1;
    t_end = min(t_end, last_q < 0 ? 0 : last_q / 64 + 1);
  }
  const int n_t = max(0, t_end - t_begin);

  auto load_kv = [&](int t, int stage) {
    const int k0 = t * 64;
    const int64_t kv_row0 = ((int64_t)b * Sk + k0) * Hkv + hk;
    const uint32_t st = s_base + C::STAGE0 + stage * C::STAGE;
    load_rows<D>(st + C::K, k + kv_row0 * D, kv_stride, Sk - k0);
    load_rows<D>(st + C::V, v + kv_row0 * D, kv_stride, Sk - k0);
  };
  load_rows<D>(q_s, q + row0 * D, q_stride, q_rows);
  load_rows<D>(do_s, dout + row0 * D, q_stride, q_rows);
  if (n_t > 0) load_kv(t_begin, 0);
  cp_async_commit();

  // This warp's queries: r0 .. r0 + 15 of the tile; a thread holds rows
  // r0 + g and r0 + g + 8.
  const int r0 = warp * 16;
  float lse_l2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    const bool ok = r < q_rows;
    lse_l2[hf] = ok ? lse[row0 + (int64_t)r * Hq] * LOG2E : 0.0f;
    dl[hf] = ok ? delta[row0 + (int64_t)r * Hq] : 0.0f;
  }
  const float scale_log2 = scale * LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  // ldmatrix addressing (lane's row and chunk within a 16 x 16 block).
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // A: Q/dO rows; K^T: keys
  const int lchunk = lane >> 4;
  const int brow = (lane & 7) + (lane >> 4) * 8;        // B: keys of two n8 tiles
  const int bchunk = (lane >> 3) & 1;

  // At D = 64 the products run on wgmma with Q and dO as A fragments in
  // registers (at D = 128 on mma.sync, the fragments read per k16 step).
  constexpr bool WG = D == 64;
  uint32_t qa[WG ? D / 16 : 1][4], oa[WG ? D / 16 : 1][4];

  // The element pass on NT n8 tiles of S and dP (keys key0 + 8 n ..): p
  // into dS in place, then dS as A fragments, k16 step u = n8 tiles 2u, 2u + 1.
  auto element_pass = [&](auto& s, auto& dp, auto& da, int key0, bool edge) {
    constexpr int NT = sizeof(s) / sizeof(s[0]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        bool ok = true;
        if (edge) {
          const int kp = key0 + 8 * n + 2 * qd + (e & 1), qi = q0 + r0 + g + 8 * hf;
          ok = kp >= kv_start && kp < kv_len && qi < Sq && (!causal || q_off + qi >= kp);
        }
        const float p =
            ok ? exp2_approx(fmaxf(fmaf(s[n][e], scale_log2, -lse_l2[hf]), EXP2_FLOOR)) : 0.0f;
        dp[n][e] = ok ? p * (dp[n][e] - dl[hf]) * scale : 0.0f;
      }
#pragma unroll
    for (int u = 0; u < NT / 2; ++u) {
      da[u][0] = pack_bf16(dp[2 * u][0], dp[2 * u][1]);
      da[u][1] = pack_bf16(dp[2 * u][2], dp[2 * u][3]);
      da[u][2] = pack_bf16(dp[2 * u + 1][0], dp[2 * u + 1][1]);
      da[u][3] = pack_bf16(dp[2 * u + 1][2], dp[2 * u + 1][3]);
    }
  };

  for (int j = 0; j < n_t; ++j) {
    const int stage = j & 1;
    cp_async_wait<0>();  // tile j has landed
    if constexpr (WG) fence_proxy_async();  // ... where wgmma reads it
    __syncthreads();      // ... for every thread, and every warp is done with tile j - 1
    // tile j + 1 flies during this tile's products, into tile j - 1's stage
    if (j + 1 < n_t) load_kv(t_begin + j + 1, stage ^ 1);
    cp_async_commit();
    if constexpr (WG) {
      // read every tile: the fragments held across iterations from an
      // ldmatrix of the first one only came back wrong on the card
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldsm_x4(qa[kk], q_s + swz(r0 + lrow, 2 * kk + lchunk, C::ROW));
        ldsm_x4(oa[kk], do_s + swz(r0 + lrow, 2 * kk + lchunk, C::ROW));
      }
    }
    const int k0 = (t_begin + j) * 64;
    const uint32_t k_s = s_base + C::STAGE0 + stage * C::STAGE + C::K;
    const uint32_t v_s = s_base + C::STAGE0 + stage * C::STAGE + C::V;
    // masks only where the tile cuts a kv_starts / kv_lens edge, the ragged
    // last query tile or the causal diagonal of the warp's queries
    const bool edge = k0 < kv_start || k0 + 64 > kv_len || r0 + 16 > q_rows ||
                      (causal && q_off + q0 + r0 < k0 + 63);
    if constexpr (WG) {
      // S = Q K^T and dP = dO V^T: 64 queries x 64 keys each, K/V as B
      // with D as K (their rows are 128-byte swizzle atoms)
      float s[8][4], dp[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wgmma_rs<64, 0>(s, qa[kk], desc_sw128(k_s + 32 * kk));
        wgmma_rs<64, 0>(dp, oa[kk], desc_sw128(v_s + 32 * kk));
      }
      wgmma_commit_wait();
      hold(s), hold(dp);
      uint32_t da[4][4];
      element_pass(s, dp, da, k0, edge);
      // dQ += dS K: B = K with the keys as K (transposed, MN-major)
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u) wgmma_rs<D, 1>(acc, da[u], desc_sw128(k_s + 16 * u * C::ROW));
      wgmma_commit_wait();
      hold(acc), hold(da);
    } else {
      // 32 keys at a time (fewer live registers beside dQ's 64 floats)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        float s[4][4], dp[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qf[4], of[4];
          ldsm_x4(qf, q_s + swz(r0 + lrow, 2 * kk + lchunk, C::ROW));
          ldsm_x4(of, do_s + swz(r0 + lrow, 2 * kk + lchunk, C::ROW));
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t kb[4], vb[4];
            ldsm_x4(kb, k_s + swz(32 * kh + 16 * np + brow, 2 * kk + bchunk, C::ROW));
            ldsm_x4(vb, v_s + swz(32 * kh + 16 * np + brow, 2 * kk + bchunk, C::ROW));
            mma_bf16(s[2 * np], qf, kb[0], kb[1]);
            mma_bf16(s[2 * np + 1], qf, kb[2], kb[3]);
            mma_bf16(dp[2 * np], of, vb[0], vb[1]);
            mma_bf16(dp[2 * np + 1], of, vb[2], vb[3]);
          }
        }
        uint32_t da[2][4];
        element_pass(s, dp, da, k0 + 32 * kh, edge);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int jd = 0; jd < D / 16; ++jd) {
            uint32_t kb[4];
            ldsm_x4_t(kb, k_s + swz(32 * kh + 16 * u + lrow, 2 * jd + lchunk, C::ROW));
            mma_bf16(acc[2 * jd], da[u], kb[0], kb[1]);
            mma_bf16(acc[2 * jd + 1], da[u], kb[2], kb[3]);
          }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: element e of n8 tile j is query r0 + g + 8 (e >> 1), column
  // 8j + 2 qd + (e & 1); a thread stores bf16 pairs.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    if (r >= q_rows) continue;
    __nv_bfloat16* dst = dq + (row0 + (int64_t)r * Hq) * D + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(acc[j][2 * hf], acc[j][2 * hf + 1]);
  }
}

}  // namespace bwd_dq

// --------------------------------------------------------------- #3: dK, dV
namespace dkv {

constexpr int BQ = 64;  // queries of a streamed tile
constexpr int HALF = 32;  // queries multiplied at a time
constexpr int MAX_SPLITS = 4;                   // blocks of a key tile: one cluster

// Shared memory (bytes) from a 1024-byte boundary: the block's K and V
// tiles, two stages of the streamed Q and dO tiles, then each stage's f32
// lse and delta; rows of D bf16, XOR-swizzled in 16-byte chunks.  With
// splits, the ranks' f32 dK/dV (fragment-major, 2 x 64 x D x 4 bytes) reuse
// the stages after the loop.
template <int D>
struct Cfg {
  static constexpr int ROW = D * 2;
  static constexpr int TILE = 64 * ROW;
  static constexpr int K_OFF = 0, V_OFF = TILE;
  static constexpr int STAGE0 = 2 * TILE;
  static constexpr int Q = 0, DO = TILE;  // in a stage
  static constexpr int STAGE = 2 * TILE;
  static constexpr int ROWS0 = STAGE0 + 2 * STAGE;  // lse then delta of stage s at ROWS0 + 512 s
  static constexpr int LSE = 0, DELTA = BQ * 4;
  static constexpr int BYTES = ROWS0 + 2 * 2 * BQ * 4 + 1024;  // + alignment of the base
  static constexpr int SLOTS = 2 * (D / 8) * 2;  // (dK or dV, n8 tile, row half) of a thread
  static_assert(SLOTS * NTHREADS * 2 * 4 <= 2 * STAGE, "the reduction must fit the stages");
};

// grid (splits, B * Hkv, key tiles), cluster (splits, 1, 1): the key tile
// is the slowest axis, so the low (under causal masking, heaviest) tiles
// start first; rank blockIdx.x takes every splits-th (query head, query
// tile) pair of the tile.
template <int D>
__global__ void __launch_bounds__(NTHREADS, D <= 64 ? 3 : 2)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     const int* __restrict__ kv_lens, const int* __restrict__ q_offset,
                     const int* __restrict__ kv_starts, int Sq, int Sk, int Hq, int Hkv,
                     float scale, int causal) {
  using C = Cfg<D>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // wgmma's 128-byte swizzle reads address bits, so tiles sit on 1024 bytes
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s_base - raw);
  const uint32_t k_s = s_base + C::K_OFF, v_s = s_base + C::V_OFF;

  const int rank = blockIdx.x, splits = gridDim.x;
  const int hk = blockIdx.y % Hkv, b = blockIdx.y / Hkv;
  const int k0 = blockIdx.z * 64;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, qd = lane & 3;

  const int kv_len = min(kv_lens[b], Sk);
  const int kv_start = max(kv_starts[b], 0);
  const int q_off = q_offset[b];
  const int k_rows = min(64, Sk - k0);
  const int64_t q_stride = (int64_t)Hq * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t kv_row0 = ((int64_t)b * Sk + k0) * Hkv + hk;  // (row, head) of the tile's first key

  // The query tiles that can see a key of this tile (causal: those whose
  // last query is at or past the tile's first key), for every query head of
  // the group; none if the tile holds no valid key (then dK = dV = 0).
  const int n_qt = (Sq + BQ - 1) / BQ;
  int qt_begin = 0;
  if (causal) {
    const int need = k0 - q_off - (BQ - 1);  // q0 >= need
    qt_begin = q_off + Sq - 1 < k0 ? n_qt : (need <= 0 ? 0 : (need + BQ - 1) / BQ);
  }
  const bool live = k0 < kv_len && k0 + k_rows > kv_start;
  const int n_live = live ? n_qt - qt_begin : 0;
  const int n_pairs = G * n_live;
  const int my_pairs = n_pairs > rank ? (n_pairs - rank + splits - 1) / splits : 0;

  // Pair j of this rank: pair index rank + j * splits, head-major.
  auto load_pair = [&](int j, int stage) {
    const int i = rank + j * splits;
    const int h = hk * G + i / n_live, q0 = (qt_begin + i % n_live) * BQ;
    const int q_rows = min(BQ, Sq - q0);
    const int64_t row0 = ((int64_t)b * Sq + q0) * Hq + h;
    const uint32_t st = s_base + C::STAGE0 + stage * C::STAGE;
    load_rows<D>(st + C::Q, q + row0 * D, q_stride, q_rows);
    load_rows<D>(st + C::DO, dout + row0 * D, q_stride, q_rows);
    const int r = threadIdx.x % BQ;
    const bool ok = r < q_rows;
    const float* src = (threadIdx.x < BQ ? lse : delta) + (ok ? row0 + (int64_t)r * Hq : 0);
    cp_async4(s_base + C::ROWS0 + stage * 2 * BQ * 4 + (threadIdx.x < BQ ? C::LSE : C::DELTA)
                  + r * 4, src, ok);
  };
  if (my_pairs > 0) {
    load_rows<D>(k_s, k + kv_row0 * D, kv_stride, k_rows);
    load_rows<D>(v_s, v + kv_row0 * D, kv_stride, k_rows);
    load_pair(0, 0);
  }
  cp_async_commit();

  // This warp's keys: kp0 .. kp0 + 15; a thread holds keys g and g + 8.
  const int r0 = warp * 16;
  const int kp0 = k0 + r0;
  const bool warp_live = kp0 < kv_len && kp0 + 15 >= kv_start;
  const bool key_edge = kp0 < kv_start || kp0 + 16 > kv_len;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.0f;
  const float scale_log2 = scale * LOG2E;

  // ldmatrix addressing (lane's row and chunk within a 16 x 16 block).
  const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // A: K/V rows; Q/dO^T: queries
  const int lchunk = lane >> 4;
  const int brow = (lane & 7) + (lane >> 4) * 8;        // B: queries of two n8 tiles
  const int bchunk = (lane >> 3) & 1;

  // At D = 64 the products run on wgmma (the tiles are 128-byte swizzle
  // atoms), with K and V as A fragments in registers: the warp's 16 keys
  // are the same for every pair, so they are read once (at D = 128 they
  // would not fit beside dK and dV, and are read per pair by ldmatrix).
  constexpr bool WG = D == 64;
  uint32_t ka[WG ? D / 16 : 1][4], va[WG ? D / 16 : 1][4];

  for (int j = 0; j < my_pairs; ++j) {
    const int stage = j & 1;
    cp_async_wait<0>();  // pair j has landed
    if constexpr (WG) fence_proxy_async();  // ... where wgmma reads it
    __syncthreads();      // ... for every thread, and every warp is done with pair j - 1
    // pair j + 1 flies during this pair's products, into pair j - 1's stage
    if (j + 1 < my_pairs) load_pair(j + 1, stage ^ 1);
    cp_async_commit();
    if constexpr (WG) {
      if (j == 0) {  // K and V landed with pair 0
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          ldsm_x4(ka[kk], k_s + swz(r0 + lrow, 2 * kk + lchunk, C::ROW));
          ldsm_x4(va[kk], v_s + swz(r0 + lrow, 2 * kk + lchunk, C::ROW));
        }
      }
    }

    const int i = rank + j * splits;
    const int q0 = (qt_begin + i % n_live) * BQ;
    const int qp0 = q_off + q0;  // position of the tile's first query
    // a warp whose keys are all invalid skips the pair (on wgmma the
    // warpgroup multiplies together, and the masks give such keys 0)
    if (!WG && !warp_live) continue;
    const uint32_t st = s_base + C::STAGE0 + stage * C::STAGE;
    const uint32_t q_s = st + C::Q, do_s = st + C::DO;
    const float* lse_s = reinterpret_cast<const float*>(smem + C::ROWS0 + stage * 2 * BQ * 4);
    const float* dl_s = lse_s + BQ;

    // The tile's queries 32 at a time (fewer live registers: three blocks
    // fit on an SM).  A half whose last query precedes the first key of the
    // warp (of the block, on wgmma) gets exactly nothing under causal masking.
#pragma unroll
    for (int hq = 0; hq < BQ / HALF; ++hq) {
      const int h0 = hq * HALF;  // the half's first query in the tile
      if (causal && qp0 + h0 + HALF - 1 < (WG ? k0 : kp0)) continue;
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x 32 queries each
      float s[HALF / 8][4], dp[HALF / 8][4];
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
      if constexpr (WG) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_rs<HALF, 0>(s, ka[kk], desc_sw128(q_s + h0 * C::ROW + 32 * kk));
          wgmma_rs<HALF, 0>(dp, va[kk], desc_sw128(do_s + h0 * C::ROW + 32 * kk));
        }
        wgmma_commit_wait();
        hold(s), hold(dp);
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t kf[4], vf[4];
          ldsm_x4(kf, k_s + swz(r0 + lrow, 2 * kk + lchunk, C::ROW));
          ldsm_x4(vf, v_s + swz(r0 + lrow, 2 * kk + lchunk, C::ROW));
#pragma unroll
          for (int np = 0; np < HALF / 16; ++np) {
            uint32_t qb[4], ob[4];
            ldsm_x4(qb, q_s + swz(h0 + 16 * np + brow, 2 * kk + bchunk, C::ROW));
            ldsm_x4(ob, do_s + swz(h0 + 16 * np + brow, 2 * kk + bchunk, C::ROW));
            mma_bf16(s[2 * np], kf, qb[0], qb[1]);
            mma_bf16(s[2 * np + 1], kf, qb[2], qb[3]);
            mma_bf16(dp[2 * np], vf, ob[0], ob[1]);
            mma_bf16(dp[2 * np + 1], vf, ob[2], ob[3]);
          }
        }
      }

      // The element pass: p into s, dS into dp.  Element e of n8 tile n is
      // key kp0 + g + 8 (e >> 1), query q0 + h0 + 8n + 2 qd + (e & 1).
      const bool edge = key_edge || q0 + h0 + HALF > Sq || (causal && qp0 + h0 < kp0 + 15);
#pragma unroll
      for (int n = 0; n < HALF / 8; ++n) {
        const int col = h0 + 8 * n + 2 * qd;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
          bool ok = true;
          if (edge) {
            const int kp = kp0 + g + 8 * (e >> 1), qi = q0 + col + (e & 1);
            ok = kp >= kv_start && kp < kv_len && qi < Sq && (!causal || q_off + qi >= kp);
          }
          const float p =
              ok ? exp2_approx(fmaxf(fmaf(s[n][e], scale_log2, -l * LOG2E), EXP2_FLOOR)) : 0.0f;
          dp[n][e] = ok ? p * (dp[n][e] - dl) * scale : 0.0f;
          s[n][e] = p;
        }
      }

      // dV += p^T dO and dK += dS^T Q: the accumulators of n8 tiles 2u,
      // 2u + 1 are the A fragment of the k16 step u (queries h0 + 16u ..).
      uint32_t pa[HALF / 16][4], da[HALF / 16][4];
#pragma unroll
      for (int u = 0; u < HALF / 16; ++u) {
        pa[u][0] = pack_bf16(s[2 * u][0], s[2 * u][1]);
        pa[u][1] = pack_bf16(s[2 * u][2], s[2 * u][3]);
        pa[u][2] = pack_bf16(s[2 * u + 1][0], s[2 * u + 1][1]);
        pa[u][3] = pack_bf16(s[2 * u + 1][2], s[2 * u + 1][3]);
        da[u][0] = pack_bf16(dp[2 * u][0], dp[2 * u][1]);
        da[u][1] = pack_bf16(dp[2 * u][2], dp[2 * u][3]);
        da[u][2] = pack_bf16(dp[2 * u + 1][0], dp[2 * u + 1][1]);
        da[u][3] = pack_bf16(dp[2 * u + 1][2], dp[2 * u + 1][3]);
      }
      if constexpr (WG) {
        // B = dO or Q with the queries as K: their rows are 128-byte
        // swizzled atoms of 8 queries (MN-major)
        wgmma_fence();
#pragma unroll
        for (int u = 0; u < HALF / 16; ++u) {
          wgmma_rs<D, 1>(dv_acc, pa[u], desc_sw128(do_s + (h0 + 16 * u) * C::ROW));
          wgmma_rs<D, 1>(dk_acc, da[u], desc_sw128(q_s + (h0 + 16 * u) * C::ROW));
        }
        wgmma_commit_wait();
        hold(dv_acc), hold(dk_acc), hold(pa), hold(da);
      } else {
#pragma unroll
        for (int u = 0; u < HALF / 16; ++u) {
#pragma unroll
          for (int jd = 0; jd < D / 16; ++jd) {
            uint32_t ob[4], qb[4];
            ldsm_x4_t(ob, do_s + swz(h0 + 16 * u + lrow, 2 * jd + lchunk, C::ROW));
            ldsm_x4_t(qb, q_s + swz(h0 + 16 * u + lrow, 2 * jd + lchunk, C::ROW));
            mma_bf16(dv_acc[2 * jd], pa[u], ob[0], ob[1]);
            mma_bf16(dv_acc[2 * jd + 1], pa[u], ob[2], ob[3]);
            mma_bf16(dk_acc[2 * jd], da[u], qb[0], qb[1]);
            mma_bf16(dk_acc[2 * jd + 1], da[u], qb[2], qb[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Epilogue: element e of n8 tile j is key k0 + r0 + g + 8 (e >> 1),
  // column 8j + 2 qd + (e & 1); a thread stores bf16 pairs.
  __nv_bfloat16* dk_row = dk + kv_row0 * D + 2 * qd;
  __nv_bfloat16* dv_row = dv + kv_row0 * D + 2 * qd;
  auto store = [&](int j, int half, float k_lo, float k_hi, float v_lo, float v_hi) {
    const int row = r0 + g + 8 * half;
    if (row >= k_rows) return;
    *reinterpret_cast<uint32_t*>(dk_row + row * kv_stride + 8 * j) = pack_bf16(k_lo, k_hi);
    *reinterpret_cast<uint32_t*>(dv_row + row * kv_stride + 8 * j) = pack_bf16(v_lo, v_hi);
  };
  if (splits == 1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        store(j, half, dk_acc[j][2 * half], dk_acc[j][2 * half + 1], dv_acc[j][2 * half],
              dv_acc[j][2 * half + 1]);
      }
    return;
  }
  // With splits: every rank stores its f32 dK/dV fragment-major, slot
  // (dK or dV, j, half) of thread t as a float2 at red[slot][t]; after a
  // cluster barrier rank r sums slots (j, half) with (2 j + half) % splits
  // == r over the ranks in rank order and stores them.
  __syncthreads();  // every warp is done with the stages
  float2* red = reinterpret_cast<float2*>(smem + C::STAGE0);
  constexpr int PAIRS = D / 8 * 2;  // (j, half) slots of dK, then of dV
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      red[(2 * j + half) * NTHREADS + threadIdx.x] =
          make_float2(dk_acc[j][2 * half], dk_acc[j][2 * half + 1]);
      red[(PAIRS + 2 * j + half) * NTHREADS + threadIdx.x] =
          make_float2(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
    }
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();  // every rank's partials are complete
  for (int sl = rank; sl < PAIRS; sl += splits) {
    float2 sk = make_float2(0.0f, 0.0f), sv = make_float2(0.0f, 0.0f);
    for (int r = 0; r < splits; ++r) {
      const float2 a = *cluster.map_shared_rank(red + sl * NTHREADS + threadIdx.x, r);
      const float2 c = *cluster.map_shared_rank(red + (PAIRS + sl) * NTHREADS + threadIdx.x, r);
      sk.x += a.x, sk.y += a.y, sv.x += c.x, sv.y += c.y;
    }
    store(sl / 2, sl % 2, sk.x, sk.y, sv.x, sv.y);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

}  // namespace dkv

// Raises the dynamic shared-memory limit of every instance to what it uses.
template <int D>
cudaError_t setup_one() {
  cudaError_t err = cudaFuncSetAttribute(bwd_dq::flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bwd_dq::Cfg<D>::BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(dkv::flash_bwd_dkv_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, dkv::Cfg<D>::BYTES);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, const void* kv_lens,
                      const void* q_offset, const void* kv_starts, int B, int Sq, int Sk,
                      int Hq, int Hkv, float scale, int causal, cudaStream_t stream) {
  dim3 grid(Hq, B, (Sq + 63) / 64);
  bwd_dq::flash_bwd_dq_kernel<D><<<grid, NTHREADS, bwd_dq::Cfg<D>::BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_starts), Sq, Sk, Hq, Hkv,
      scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv,
                       const void* kv_lens, const void* q_offset, const void* kv_starts, int B,
                       int Sq, int Sk, int Hq, int Hkv, float scale, int causal, int splits,
                       cudaStream_t stream) {
  if (splits < 1 || splits > dkv::MAX_SPLITS) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, B * Hkv, (Sk + 63) / 64);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = dkv::Cfg<D>::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dkv::flash_bwd_dkv_kernel<D>, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_starts), Sq, Sk, Hq, Hkv,
      scale, causal);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Raises the dynamic shared-memory limits of both kernels' instances; called
// once per device when the library is loaded.
extern "C" int flash_bwd_setup() {
  cudaError_t err = setup_one<64>();
  if (err == cudaSuccess) err = setup_one<128>();
  return static_cast<int>(err);
}

extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 const void* kv_lens, const void* q_offset,
                                 const void* kv_starts, int B, int Sq, int Sk, int Hq, int Hkv,
                                 int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    err = launch_dq<64>(q, k, v, dout, lse, delta, dq, kv_lens, q_offset, kv_starts, B, Sq, Sk,
                        Hq, Hkv, scale, causal, s);
  } else if (D == 128) {
    err = launch_dq<128>(q, k, v, dout, lse, delta, dq, kv_lens, q_offset, kv_starts, B, Sq, Sk,
                         Hq, Hkv, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// #3 over `splits` blocks (one cluster) per key tile, 1 to 4.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  const void* kv_lens, const void* q_offset,
                                  const void* kv_starts, int B, int Sq, int Sk, int Hq, int Hkv,
                                  int D, float scale, int causal, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    err = launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, kv_lens, q_offset, kv_starts, B, Sq,
                         Sk, Hq, Hkv, scale, causal, splits, s);
  } else if (D == 128) {
    err = launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, kv_lens, q_offset, kv_starts, B,
                          Sq, Sk, Hq, Hkv, scale, causal, splits, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
