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
// Design.  Both kernels use #1's structure: 4-warp blocks, 64-row tiles
// staged in shared memory, WMMA bf16 products (16x16x16, f32 accumulate),
// each warp owning 16 rows end to end so warps only __syncwarp between the
// tile loads.
//   #2: one block per (64-query tile, query head, batch row).  It keeps Q,
//       dO, lse and delta of its tile in shared memory and loops over the
//       64-key K/V tiles that hold a valid key for some query of the tile:
//       S = Q K^T and dP = dO V^T go to f32 shared memory, the element pass
//       turns them into dS (bf16), and dQ += dS K accumulates in registers.
//   #3: one block per (64-key tile, kv head, batch row).  It keeps K and V
//       of its tile and loops over the G query heads of the group and the
//       64-query tiles that can see one of its keys: S^T = K Q^T and
//       dP^T = V dO^T, the element pass gives p^T and dS^T (bf16), then
//       dV += p^T dO and dK += dS^T Q in registers.  One block owns its keys
//       for every query head, so dK/dV need no atomics and are
//       deterministic.
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
// 110 MB, bound by operations (~80 us).  This simple version (no TMA, no
// wgmma, no pipelining; the element pass goes through shared memory) is far
// from either bound; making it fast is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_bwd.so flash_bwd.cu
// Interface: plain C (flash_bwd_dq_bf16, flash_bwd_dkv_bf16), loaded with
// ctypes; each launches on the given stream, never synchronises, and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BT = 64;         // rows per tile (queries or keys)
constexpr int NWARPS = 4;      // 16 rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float EXP_FLOOR = -80.0f;

// Shared-memory layout (bytes), the same for both kernels: four bf16 row
// tiles (the block's own two, the streamed two), two f32 score tiles, two
// bf16 tiles for the element pass's outputs, and two f32 per-query vectors.
// Padding breaks bank conflicts and keeps every 16-row WMMA fragment base
// 32-byte aligned.  After the loop the score tiles hold the f32 output tile
// (ld D + 4), which fits in the two of them for D <= 128.
template <int D> struct Smem {
  static constexpr int LD = D + 8;     // bf16 row tiles
  static constexpr int LD_S = BT + 4;  // f32 score tiles
  static constexpr int LD_P = BT + 8;  // bf16 element-pass tiles
  static constexpr int LD_O = D + 4;   // f32 output staging
  static constexpr int TILE = BT * LD * 2;
  static constexpr int A_OFF = 0;                    // own tile 1 (Q or K)
  static constexpr int B_OFF = A_OFF + TILE;         // own tile 2 (dO or V)
  static constexpr int C_OFF = B_OFF + TILE;         // streamed tile 1 (K or Q)
  static constexpr int E_OFF = C_OFF + TILE;         // streamed tile 2 (V or dO)
  static constexpr int S_OFF = E_OFF + TILE;         // f32 S (or S^T)
  static constexpr int DP_OFF = S_OFF + BT * LD_S * 4;  // f32 dP (or dP^T)
  static constexpr int P_OFF = DP_OFF + BT * LD_S * 4;  // bf16 p^T (#3 only)
  static constexpr int DS_OFF = P_OFF + BT * LD_P * 2;  // bf16 dS (or dS^T)
  static constexpr int LSE_OFF = DS_OFF + BT * LD_P * 2;
  static constexpr int DELTA_OFF = LSE_OFF + BT * 4;
  static constexpr int BYTES = DELTA_OFF + BT * 4;
  static_assert(BT * LD_O * 4 <= 2 * BT * LD_S * 4, "output staging must fit the score tiles");
};

// Copy a (BT, D) bf16 tile from global memory (row stride `gstride`
// elements) into shared memory, 16 bytes per thread per step; rows at or
// beyond `valid_rows` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int64_t gstride, int valid_rows) {
  constexpr int VEC = 8;
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < BT * PER_ROW; idx += NTHREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) val = *reinterpret_cast<const uint4*>(src + r * gstride + c);
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::LD + c) = val;
  }
}

// out_w (16 x D, f32 fragments) += A_w (16 x BT, bf16 row-major, ld LD_P)
// times B (BT x D, bf16 row-major, ld LD).
template <int D>
__device__ __forceinline__ void acc_product(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16],
    const __nv_bfloat16* a, const __nv_bfloat16* b) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
    wmma::load_matrix_sync(af, a + kk * 16, Smem<D>::LD_P);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
      wmma::load_matrix_sync(bf, b + (kk * 16) * Smem<D>::LD + j * 16, Smem<D>::LD);
      wmma::mma_sync(acc[j], af, bf, acc[j]);
    }
  }
}

// out_w (16 x BT, f32 in shared memory, ld LD_S) = A_w (16 x D rows of a
// bf16 tile) times B^T, where B is a (BT, D) bf16 tile: row i of the output
// is the dot products of row i of A with every row of B.
template <int D>
__device__ __forceinline__ void row_dots(float* out, const __nv_bfloat16* a,
                                         const __nv_bfloat16* b) {
#pragma unroll
  for (int j = 0; j < BT / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
    wmma::fill_fragment(sf, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
      wmma::load_matrix_sync(af, a + kk * 16, Smem<D>::LD);
      wmma::load_matrix_sync(bf, b + (j * 16) * Smem<D>::LD + kk * 16, Smem<D>::LD);
      wmma::mma_sync(sf, af, bf, sf);
    }
    wmma::store_matrix_sync(out + j * 16, sf, Smem<D>::LD_S, wmma::mem_row_major);
  }
}

// Write a warp's 16 accumulated rows as bf16: fragments -> f32 staging in
// shared memory (ld LD_O) -> rows [row0, row0 + 16) of `dst` (row stride
// `gstride`), skipping rows at or beyond `valid_rows`.
template <int D>
__device__ __forceinline__ void store_rows(
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> (&acc)[D / 16], float* stage,
    __nv_bfloat16* dst, int64_t gstride, int row0, int valid_rows) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(stage + row0 * Smem<D>::LD_O + j * 16, acc[j], Smem<D>::LD_O,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    if (row >= valid_rows) break;
    for (int c = lane; c < D; c += 32) {
      dst[row * gstride + c] = __float2bfloat16(stage[row * Smem<D>::LD_O + c]);
    }
  }
  __syncwarp();
}

// ------------------------------------------------------------------ #2: dQ
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, const int* __restrict__ kv_lens,
                    const int* __restrict__ q_offset, const int* __restrict__ kv_starts,
                    int Sq, int Sk, int Hq, int Hkv, float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::A_OFF);
  __nv_bfloat16* do_s = reinterpret_cast<__nv_bfloat16*>(smem + L::B_OFF);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::C_OFF);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::E_OFF);
  float* s_s = reinterpret_cast<float*>(smem + L::S_OFF);
  float* dp_s = reinterpret_cast<float*>(smem + L::DP_OFF);
  __nv_bfloat16* ds_s = reinterpret_cast<__nv_bfloat16*>(smem + L::DS_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA_OFF);

  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;

  const int kv_len = min(kv_lens[b], Sk);
  const int kv_start = max(kv_starts[b], 0);
  const int q_off = q_offset[b];
  const int q_rows = min(BT, Sq - q0);
  const int64_t q_stride = (int64_t)Hq * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t q_base = ((int64_t)b * Sq + q0) * Hq + h;  // (row, head) of the tile's first query

  load_tile<D>(q_s, q + q_base * D, q_stride, q_rows);
  load_tile<D>(do_s, dout + q_base * D, q_stride, q_rows);
  for (int r = threadIdx.x; r < BT; r += NTHREADS) {
    lse_s[r] = r < q_rows ? lse[q_base + (int64_t)r * Hq] : 0.0f;
    delta_s[r] = r < q_rows ? delta[q_base + (int64_t)r * Hq] : 0.0f;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  // Key tiles that can hold a valid key for some query of this tile.
  const int t_begin = kv_start / BT;
  int t_end = (kv_len + BT - 1) / BT;
  if (causal) {
    const int last_q = q_off + q0 + q_rows - 1;
    t_end = min(t_end, last_q < 0 ? 0 : last_q / BT + 1);
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BT;
    __syncthreads();  // every warp is done with the previous K/V tile
    const int64_t kv_base = ((int64_t)b * Sk + k0) * Hkv + hk;
    load_tile<D>(k_s, k + kv_base * D, kv_stride, Sk - k0);
    load_tile<D>(v_s, v + kv_base * D, kv_stride, Sk - k0);
    __syncthreads();

    row_dots<D>(s_s + row0 * L::LD_S, q_s + row0 * L::LD, k_s);    // S = Q K^T
    row_dots<D>(dp_s + row0 * L::LD_S, do_s + row0 * L::LD, v_s);  // dP = dO V^T
    __syncwarp();

    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      const int q_pos = q_off + q0 + row;
      const bool q_ok = row < q_rows;
      const float l = lse_s[row];
      const float dl = delta_s[row];
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int col = lane + 32 * c2;
        const int kv_pos = k0 + col;
        const bool ok = q_ok && kv_pos >= kv_start && kv_pos < kv_len &&
                        (!causal || q_pos >= kv_pos);
        float ds = 0.0f;
        if (ok) {
          const float p = expf(fmaxf(s_s[row * L::LD_S + col] * scale - l, EXP_FLOOR));
          ds = p * (dp_s[row * L::LD_S + col] - dl) * scale;
        }
        ds_s[row * L::LD_P + col] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    acc_product<D>(acc, ds_s + row0 * L::LD_P, k_s);  // dQ += dS K
  }

  __syncthreads();  // the score tiles become the output staging
  store_rows<D>(acc, s_s, dq + q_base * D, q_stride, row0, q_rows);
}

// --------------------------------------------------------------- #3: dK, dV
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                     const int* __restrict__ kv_lens, const int* __restrict__ q_offset,
                     const int* __restrict__ kv_starts, int Sq, int Sk, int Hq, int Hkv,
                     float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::A_OFF);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::B_OFF);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::C_OFF);
  __nv_bfloat16* do_s = reinterpret_cast<__nv_bfloat16*>(smem + L::E_OFF);
  float* st_s = reinterpret_cast<float*>(smem + L::S_OFF);
  float* dpt_s = reinterpret_cast<float*>(smem + L::DP_OFF);
  __nv_bfloat16* pt_s = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  __nv_bfloat16* dst_s = reinterpret_cast<__nv_bfloat16*>(smem + L::DS_OFF);
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA_OFF);

  const int k0 = blockIdx.x * BT;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;

  const int kv_len = min(kv_lens[b], Sk);
  const int kv_start = max(kv_starts[b], 0);
  const int q_off = q_offset[b];
  const int k_rows = min(BT, Sk - k0);
  const int64_t q_stride = (int64_t)Hq * D;
  const int64_t kv_stride = (int64_t)Hkv * D;
  const int64_t kv_base = ((int64_t)b * Sk + k0) * Hkv + hk;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.0f);
    wmma::fill_fragment(dv_acc[j], 0.0f);
  }

  // Does this key tile hold a valid key at all?  (Else dK = dV = 0.)
  const bool live = k0 < kv_len && k0 + k_rows > kv_start;
  if (live) {
    load_tile<D>(k_s, k + kv_base * D, kv_stride, k_rows);
    load_tile<D>(v_s, v + kv_base * D, kv_stride, k_rows);
    const int n_qt = (Sq + BT - 1) / BT;
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      for (int qt = 0; qt < n_qt; ++qt) {
        const int q0 = qt * BT;
        const int q_rows = min(BT, Sq - q0);
        // causal: skip query tiles whose last query precedes this tile's
        // first key (uniform over the block)
        if (causal && q_off + q0 + q_rows - 1 < k0) continue;
        __syncthreads();  // every warp is done with the previous Q/dO tile
        const int64_t q_base = ((int64_t)b * Sq + q0) * Hq + h;
        load_tile<D>(q_s, q + q_base * D, q_stride, q_rows);
        load_tile<D>(do_s, dout + q_base * D, q_stride, q_rows);
        for (int r = threadIdx.x; r < BT; r += NTHREADS) {
          lse_s[r] = r < q_rows ? lse[q_base + (int64_t)r * Hq] : 0.0f;
          delta_s[r] = r < q_rows ? delta[q_base + (int64_t)r * Hq] : 0.0f;
        }
        __syncthreads();

        row_dots<D>(st_s + row0 * L::LD_S, k_s + row0 * L::LD, q_s);    // S^T = K Q^T
        row_dots<D>(dpt_s + row0 * L::LD_S, v_s + row0 * L::LD, do_s);  // dP^T = V dO^T
        __syncwarp();

        for (int r = 0; r < 16; ++r) {
          const int row = row0 + r;
          const int kv_pos = k0 + row;
          const bool k_ok = kv_pos >= kv_start && kv_pos < kv_len;
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int col = lane + 32 * c2;
            const int q_pos = q_off + q0 + col;
            const bool ok = k_ok && col < q_rows && (!causal || q_pos >= kv_pos);
            float p = 0.0f, ds = 0.0f;
            if (ok) {
              p = expf(fmaxf(st_s[row * L::LD_S + col] * scale - lse_s[col], EXP_FLOOR));
              ds = p * (dpt_s[row * L::LD_S + col] - delta_s[col]) * scale;
            }
            pt_s[row * L::LD_P + col] = __float2bfloat16(p);
            dst_s[row * L::LD_P + col] = __float2bfloat16(ds);
          }
        }
        __syncwarp();

        acc_product<D>(dv_acc, pt_s + row0 * L::LD_P, do_s);  // dV += p^T dO
        acc_product<D>(dk_acc, dst_s + row0 * L::LD_P, q_s);  // dK += dS^T Q
      }
    }
  }

  __syncthreads();  // the score tiles become the output staging
  float* stage = st_s;
  store_rows<D>(dk_acc, stage, dk + kv_base * D, kv_stride, row0, k_rows);
  store_rows<D>(dv_acc, stage, dv + kv_base * D, kv_stride, row0, k_rows);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, const void* kv_lens,
                      const void* q_offset, const void* kv_starts, int B, int Sq, int Sk,
                      int Hq, int Hkv, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;
  cudaError_t err = set_smem(flash_bwd_dq_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BT - 1) / BT, Hq, B);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
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
                       int Sq, int Sk, int Hq, int Hkv, float scale, int causal,
                       cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;
  cudaError_t err = set_smem(flash_bwd_dkv_kernel<D>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + BT - 1) / BT, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      static_cast<const int*>(kv_lens), static_cast<const int*>(q_offset),
      static_cast<const int*>(kv_starts), Sq, Sk, Hq, Hkv, scale, causal);
  return cudaGetLastError();
}

}  // namespace

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

extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dk, void* dv,
                                  const void* kv_lens, const void* q_offset,
                                  const void* kv_starts, int B, int Sq, int Sk, int Hq, int Hkv,
                                  int D, float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    err = launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, kv_lens, q_offset, kv_starts, B, Sq,
                         Sk, Hq, Hkv, scale, causal, s);
  } else if (D == 128) {
    err = launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, kv_lens, q_offset, kv_starts, B,
                          Sq, Sk, Hq, Hkv, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
