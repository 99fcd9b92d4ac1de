// One-token flash decode over paged KV.
//
// Replaces the TPU kernel `_decode_kernel` of
// dynamo_tpu/ops/pallas_paged_attention.py (wrapper
// `paged_attention_decode_pallas`): lane b's query attends its own pages,
// keys < max(seq_lens[b], 1) (an empty lane behaves as length 1).
//
// Bound on this card: bytes. Each lane's real context K and V are read
// once (B * seq_len * KH * D * 2 elements); the products are
// 4 * H * D * seq_len per lane, far under the roofline ridge. The design
// therefore reads each KV byte from device memory exactly once per block:
// grid = (B, KH), the G query heads of a KV head share the block's K/V
// tiles, pages past the lane's length are never touched, and several
// blocks per SM overlap one block's loads with another's arithmetic.
// Quantized pools (int8/int4) are dequantized while a tile is staged
// (flash_paged.cuh), which also replaces the TPU kernel's `_window_dequant`
// (pallas_paged_attention.py:40) for this kernel: such a pool moves half
// or a quarter of the bytes, but the kernel is not yet bound by them.
// Not yet done: split-KV across blocks for small B with long contexts.
#include "flash_paged.cuh"

namespace dyn {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_kernel(T* __restrict__ out, const T* __restrict__ q, PagedKV kv,
                    const int* __restrict__ page_tables,
                    const int* __restrict__ seq_lens, int H, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, kh = blockIdx.y;
  int len = seq_lens[b];
  if (len < 1) len = 1;
  kv.table = page_tables + (long long)b * kv.max_pages;
  const long long o = ((long long)b * H + (long long)kh * G) * D;
  flash_tile<T, D>(smem_raw, q + o, out + o, (long long)H * D, 1, G, len - 1, len, kv, kh);
}

template <typename T, int D>
int launch_decode(void* out, const void* q, PagedKV kv, const int* page_tables,
                  const int* seq_lens, int B, int H, int KH, cudaStream_t stream) {
  const int G = H / KH;
  size_t smem = flash_smem_bytes<T, D>(G);
  cudaError_t e = allow_smem(paged_decode_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  paged_decode_kernel<T, D><<<dim3(B, KH), NT, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q), kv, page_tables, seq_lens, H, G);
  return (int)cudaGetLastError();
}

}  // namespace dyn

#define LAUNCH_DECODE(T, D)                                                    \
  dyn::launch_decode<T, D>(out, q, kv, page_tables, seq_lens, B, H, KH,        \
                           static_cast<cudaStream_t>(stream))

// out, q: [B, H, D]; kv_k, kv_v: [num_phys, rows, KH, D] with strides
// (s_page, s_tok, s_head) in elements of the pool's type — T, or int8 with
// rows = page_size (kv_bits 8) or page_size / 2 (kv_bits 4); k_scale,
// v_scale: f32 [num_phys, KH] when kv_bits != 0, else null; page_tables:
// [B, max_pages] int32; seq_lens: [B] int32. Returns cudaGetLastError()
// (0 = launched), or a negative code for a dtype / head_dim / page_size /
// format that is not built.
extern "C" int dyn_paged_decode(void* out, const void* q, const void* kv_k,
                                const void* kv_v, const float* k_scale,
                                const float* v_scale, int kv_bits,
                                const int* page_tables, int max_pages, int num_phys,
                                long long s_page, long long s_tok, long long s_head,
                                const int* seq_lens, int B, int H, int KH, int D,
                                int page_size, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || !dyn::page_size_ok(page_size, kv_bits))
    return dyn::ERR_UNSUPPORTED;
  dyn::PagedKV kv = dyn::make_kv(kv_k, kv_v, k_scale, v_scale, kv_bits, max_pages,
                                 num_phys, page_size, KH, s_page, s_tok, s_head);
  DYN_DISPATCH(dtype, D, LAUNCH_DECODE);
}

extern "C" const char* dyn_error_string(int code) {
  if (code == dyn::ERR_UNSUPPORTED)
    return "unsupported dtype, head_dim, head grouping, page_size, KV format or local size";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
