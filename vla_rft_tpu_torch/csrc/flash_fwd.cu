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
// Design.  One block of 4 warps per (64-query tile, query head, batch row).
// The TPU kernel walks key blocks on its sequential grid axis with K/V
// resident in VMEM; here a loop inside the block stages 64-key K/V tiles in
// shared memory and carries (m, l, O) across tiles.  Each warp owns 16 query
// rows end to end, so after a tile is staged warps only need __syncwarp:
//   S = Q K^T  and  O += P V  run on the tensor cores through WMMA
//   (16x16x16 bf16, f32 accumulate); the softmax runs on the f32 S tile in
//   shared memory, two columns per lane.  P is rounded to bf16 for the
//   P V product (the row sum l uses the f32 P).  Key tiles wholly outside
//   [kv_start, kv_len) or wholly above the causal diagonal are skipped.
//
// What bounds it on an H100.  At the serving shape (B = 1..8, S = 352,
// Hq = 14, Hkv = 2, D = 64, causal) the work is about
// 4 * B * Hq * Sq * Sk * D / 2 FLOPs against (B * S * (Hq + 2 * Hkv) * D +
// B * Sq * Hq * (D + 2)) * 2 bytes, some 150 FLOPs per byte: below the
// card's ~295 FLOP/byte bf16 ridge, so device-memory traffic sets the bound
// (under a microsecond per call at B = 1).  This simple version (no TMA, no
// wgmma, no pipelining, 84 blocks at B = 1) is far from that bound; making
// it fast is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_fwd.so flash_fwd.cu
// Interface: plain C (flash_fwd_bf16), loaded with ctypes; it launches on
// the given stream, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per staged tile
constexpr int NWARPS = 4;      // 16 query rows per warp
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;
constexpr float EXP_FLOOR = -80.0f;

// Shared-memory row strides (elements).  Padding breaks bank conflicts and
// keeps every 16-row WMMA fragment base 32-byte aligned.
template <int D> struct Smem {
  static constexpr int LD_QKV = D + 8;   // bf16
  static constexpr int LD_S = BK + 4;    // f32
  static constexpr int LD_P = BK + 8;    // bf16
  static constexpr int LD_O = D + 4;     // f32
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * LD_QKV * 2;
  static constexpr int V_OFF = K_OFF + BK * LD_QKV * 2;
  static constexpr int S_OFF = V_OFF + BK * LD_QKV * 2;
  static constexpr int P_OFF = S_OFF + BQ * LD_S * 4;
  static constexpr int O_OFF = P_OFF + BQ * LD_P * 2;
  static constexpr int M_OFF = O_OFF + BQ * LD_O * 4;
  static constexpr int L_OFF = M_OFF + BQ * 4;
  static constexpr int BYTES = L_OFF + BQ * 4;
};

// Copy a (rows, D) bf16 tile from global memory (row stride `gstride`
// elements) into shared memory, 16 bytes per thread per step; rows at or
// beyond `valid_rows` are zero-filled so masked lanes never read garbage.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int gstride, int valid_rows) {
  constexpr int VEC = 8;  // bf16 per 16-byte vector
  constexpr int PER_ROW = D / VEC;
  for (int idx = threadIdx.x; idx < BQ * PER_ROW; idx += NTHREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) {
      val = *reinterpret_cast<const uint4*>(src + (int64_t)r * gstride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<D>::LD_QKV + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, const int* __restrict__ kv_lens,
                 const int* __restrict__ q_offset, const int* __restrict__ kv_starts,
                 int Sq, int Sk, int Hq, int Hkv, float scale, int causal) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + L::Q_OFF);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem + L::K_OFF);
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem + L::V_OFF);
  float* s_s = reinterpret_cast<float*>(smem + L::S_OFF);
  __nv_bfloat16* p_s = reinterpret_cast<__nv_bfloat16*>(smem + L::P_OFF);
  float* o_s = reinterpret_cast<float*>(smem + L::O_OFF);
  float* m_s = reinterpret_cast<float*>(smem + L::M_OFF);
  float* l_s = reinterpret_cast<float*>(smem + L::L_OFF);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;  // this warp's first row inside the tile

  const int kv_len = min(kv_lens[b], Sk);
  const int kv_start = max(kv_starts[b], 0);
  const int q_off = q_offset[b];

  // Stage Q and clear this block's running state.
  const int q_rows = min(BQ, Sq - q0);
  load_tile<D>(q_s, q + (((int64_t)b * Sq + q0) * Hq + h) * D, Hq * D, q_rows);
  for (int idx = threadIdx.x; idx < BQ * L::LD_O; idx += NTHREADS) o_s[idx] = 0.0f;
  for (int idx = threadIdx.x; idx < BQ; idx += NTHREADS) {
    m_s[idx] = NEG_INF;
    l_s[idx] = 0.0f;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], q_s + row0 * L::LD_QKV + kk * 16, L::LD_QKV);
  }

  // Key tiles that can hold a valid key for some row of this block.
  int t_begin = kv_start / BK;
  int t_end = (kv_len + BK - 1) / BK;
  if (causal) {
    const int last_q = q_off + q0 + q_rows - 1;  // largest query position
    t_end = min(t_end, last_q < 0 ? 0 : last_q / BK + 1);
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    const int64_t kv_base = ((int64_t)b * Sk + k0) * Hkv + hk;
    load_tile<D>(k_s, k + kv_base * D, Hkv * D, Sk - k0);
    load_tile<D>(v_s, v + kv_base * D, Hkv * D, Sk - k0);
    __syncthreads();

    // S (16 x 64 per warp) = Q_w K^T, f32 accumulate.
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, k_s + (j * 16) * L::LD_QKV + kk * 16, L::LD_QKV);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(s_s + row0 * L::LD_S + j * 16, sf, L::LD_S, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over the warp's 16 rows; lane owns columns lane, lane+32.
    for (int r = 0; r < 16; ++r) {
      const int row = row0 + r;
      const int q_pos = q_off + q0 + row;
      float s[2];
      bool ok[2];
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int col = lane + 32 * c2;
        const int kv_pos = k0 + col;
        ok[c2] = kv_pos >= kv_start && kv_pos < kv_len && (!causal || q_pos >= kv_pos);
        s[c2] = ok[c2] ? s_s[row * L::LD_S + col] * scale : NEG_INF;
      }
      float mx = fmaxf(s[0], s[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      float p[2];
      float sum = 0.0f;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        p[c2] = ok[c2] ? expf(fmaxf(s[c2] - m_new, EXP_FLOOR)) : 0.0f;
        sum += p[c2];
        p_s[row * L::LD_P + lane + 32 * c2] = __float2bfloat16(p[c2]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(fmaxf(m_old - m_new, EXP_FLOOR));
      for (int c = lane; c < D; c += 32) o_s[row * L::LD_O + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[row] = m_new;
        l_s[row] = l_s[row] * alpha + sum;
      }
    }
    __syncwarp();

    // O_w (16 x D) += P_w V, accumulating into the rescaled f32 tile.
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, o_s + row0 * L::LD_O + j * 16, L::LD_O, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, p_s + row0 * L::LD_P + kk * 16, L::LD_P);
        wmma::load_matrix_sync(vf, v_s + (kk * 16) * L::LD_QKV + j * 16, L::LD_QKV);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(o_s + row0 * L::LD_O + j * 16, of, L::LD_O, wmma::mem_row_major);
    }
    __syncwarp();
  }

  // Epilogue: O = acc / l (0 for a fully-masked row), LSE = m + log l.
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    const int qi = q0 + row;
    if (qi >= Sq) break;
    const float l = l_s[row];
    const float inv = l == 0.0f ? 0.0f : 1.0f / l;
    __nv_bfloat16* orow = o + (((int64_t)b * Sq + qi) * Hq + h) * D;
    for (int c = lane; c < D; c += 32) orow[c] = __float2bfloat16(o_s[row * L::LD_O + c] * inv);
    if (lane == 0) {
      lse[((int64_t)b * Sq + qi) * Hq + h] = l == 0.0f ? NEG_INF : m_s[row] + logf(l);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   const void* kv_lens, const void* q_offset, const void* kv_starts, int B,
                   int Sq, int Sk, int Hq, int Hkv, float scale, int causal, cudaStream_t stream) {
  constexpr int bytes = Smem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(kv_lens),
      static_cast<const int*>(q_offset), static_cast<const int*>(kv_starts), Sq, Sk, Hq, Hkv,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                              const void* kv_lens, const void* q_offset, const void* kv_starts,
                              int B, int Sq, int Sk, int Hq, int Hkv, int D, float scale,
                              int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (D == 64) {
    err = launch<64>(q, k, v, o, lse, kv_lens, q_offset, kv_starts, B, Sq, Sk, Hq, Hkv, scale,
                     causal, s);
  } else if (D == 128) {
    err = launch<128>(q, k, v, o, lse, kv_lens, q_offset, kv_starts, B, Sq, Sk, Hq, Hkv, scale,
                      causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
