// Split-cache decode attention over the head-blocked KV cache (rows, Hkv,
// S, D), for Hopper (sm_90a).
//
// Replaces two TPU kernels of vla_rft_tpu/ops/decode_attention.py:
//   * shared = 1: `_shared_decode_kernel` (decode_attention_shared), the WM
//     decode step with a shared prompt prefix read through prefix_map and
//     the row's own cache, one softmax over both, Sq <= 8;
//   * shared = 0: `_decode_kernel` (decode_attention), one cache with
//     kv_lens / kv_starts.  The reference takes one query token there and
//     sends 2-8 token chunks to its XLA fallback; this kernel takes Sq <= 8,
//     which is the same function.
// The TPU kernels' head-pair packing of the cache (`pack_kv`, a 128-lane
// rule), their batch blocking and their int8 requantisation of q and p are
// not ported.  The kernel, what it computes, its design and its bound are
// in decode_attend.cuh (HEADS = true): the #4 / #5 kernel over the other
// strides (position stride D, head stride S*D).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdecode_heads.so decode_heads.cu
// Interface: plain C (decode_heads), loaded with ctypes; it launches on the
// given stream with the wrapper's plan (n_prefix, chunk_rows, slots,
// splits: decode_plan in ops/decode_attention_hd.py), never synchronises,
// and returns cudaGetLastError().

#include "decode_attend.cuh"

extern "C" int decode_heads(const void* q, void* o, const void* k_own, const void* v_own,
                            const void* ks_own, const void* vs_own, const void* k_sh,
                            const void* v_sh, const void* ks_sh, const void* vs_sh,
                            const void* prefix_map, const void* kv_lens, const void* q_offset,
                            const void* kv_starts, int B, int Sq, int Hq, int Hkv, int head_dim,
                            int Sr, int Sp, int shared_len, int int8_cache, int shared,
                            float scale, int n_prefix, int chunk_rows, int slots,
                            int splits, void* stream) {
  return decode_attend::run<true>(q, o, k_own, v_own, ks_own, vs_own, k_sh, v_sh, ks_sh, vs_sh,
                                  prefix_map, kv_lens, q_offset, kv_starts, B, Sq, Hq, Hkv,
                                  head_dim, Sr, Sp, shared_len, int8_cache, shared, scale,
                                  n_prefix, chunk_rows, slots, splits, stream);
}
