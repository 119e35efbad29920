// Split-cache decode attention over the head-dense KV cache (rows, S,
// Hkv*D), for Hopper (sm_90a).
//
// Replaces two TPU kernels of vla_rft_tpu/ops/decode_attention_hd.py, which
// share their math (`_hd_attend`):
//   * shared = 1: `_shared_kernel_hd` (decode_attention_shared_hd), the WM
//     decode step with a shared prompt prefix: each row attends over the
//     prefix cache row prefix_map[b] and its own cache, one softmax over both;
//   * shared = 0: `_plain_kernel_hd` (decode_attention_hd), the same without
//     the shared segment.
// The kernel, what it computes, its design and its bound are in
// decode_attend.cuh (HEADS = false).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode_hd.so decode_hd.cu
// Interface: plain C (decode_hd), loaded with ctypes; it launches on the
// given stream with the wrapper's plan (n_prefix, chunk_rows, slots,
// splits: decode_plan in ops/decode_attention_hd.py), never synchronises,
// and returns cudaGetLastError().

#include "decode_attend.cuh"

extern "C" int decode_hd(const void* q, void* o, const void* k_own, const void* v_own,
                         const void* ks_own, const void* vs_own, const void* k_sh,
                         const void* v_sh, const void* ks_sh, const void* vs_sh,
                         const void* prefix_map, const void* kv_lens, const void* q_offset,
                         const void* kv_starts, int B, int Sq, int Hq, int Hkv, int head_dim,
                         int Sr, int Sp, int shared_len, int int8_cache, int shared,
                         float scale, int n_prefix, int chunk_rows, int slots, int splits,
                         void* stream) {
  return decode_attend::run<false>(q, o, k_own, v_own, ks_own, vs_own, k_sh, v_sh, ks_sh, vs_sh,
                                   prefix_map, kv_lens, q_offset, kv_starts, B, Sq, Hq, Hkv,
                                   head_dim, Sr, Sp, shared_len, int8_cache, shared, scale,
                                   n_prefix, chunk_rows, slots, splits, stream);
}
