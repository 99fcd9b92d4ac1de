// One-token flash decode over a READ-ONLY paged pool plus a block-local
// KV buffer, merged in one online softmax.
//
// Replaces the TPU kernel `_decode_local_kernel` of
// dynamo_tpu/ops/pallas_paged_attention.py (wrapper
// `paged_attention_decode_pallas_local`): the local decode block keeps the
// pool unwritten for its K steps, each step's new K/V sit in a per-layer
// buffer loc_k/loc_v [B, K, KH, D] (compute dtype, always full precision),
// and lane b's query attends pool keys < pool_lens[b] plus local entries
// j <= step_idx. step_idx is read from device memory (a one-element int32
// tensor), so a captured CUDA graph can replay the block unchanged.
//
// Unlike the TPU kernel, a lane with pool_lens[b] == 0 attends no pool key
// (the TPU kernel clamps the pool length to 1): this is what the reference's
// plain path computes, and only inactive lanes, whose output is discarded,
// have an empty pool.
//
// Bound on this card: bytes, as paged_decode.cu (each lane's pool pages
// read once, plus B * K * KH * D local entries). The design is the same:
// grid = (B, KH), the G query heads of a KV head share each staged tile,
// then one more tile for the K <= 64 local rows before normalising.
// Quantized pools are dequantized while a tile is staged (flash_paged.cuh),
// replacing `_window_dequant` (pallas_paged_attention.py:40) here too.
#include "flash_paged.cuh"

namespace dyn {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
paged_decode_local_kernel(T* __restrict__ out, const T* __restrict__ q, PagedKV kv,
                          const int* __restrict__ page_tables,
                          const int* __restrict__ pool_lens,
                          const T* __restrict__ loc_k, const T* __restrict__ loc_v,
                          int K, const int* __restrict__ step_idx, int H, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x, kh = blockIdx.y;
  int len = pool_lens[b];
  if (len < 0) len = 0;
  int n_loc = step_idx[0] + 1;  // local entries 0..step_idx
  if (n_loc > K) n_loc = K;
  if (n_loc < 0) n_loc = 0;
  kv.table = page_tables + (long long)b * kv.max_pages;
  const long long o = ((long long)b * H + (long long)kh * G) * D;
  Flash<T, D> f(smem_raw, 1, G);
  f.init(q + o, (long long)H * D);
  f.pool(kv, kh, 1, len - 1, len);
  // the local rows of (b, kh): row j at loc[b, j, kh, :]
  const long long loc0 = ((long long)b * K * kv.KH + kh) * D;
  const int kt = (K + 3) & ~3;  // the PV loop reads 4 keys at a time
  f.stage_dense(loc_k + loc0, loc_v + loc0, (long long)kv.KH * D, kt, n_loc);
  f.update(kt, 0, n_loc - 1, n_loc);
  f.finalize(out + o, (long long)H * D);
}

template <typename T, int D>
int launch_decode_local(void* out, const void* q, PagedKV kv, const int* page_tables,
                        const int* pool_lens, const void* loc_k, const void* loc_v,
                        int K, const int* step_idx, int B, int H, int KH,
                        cudaStream_t stream) {
  const int G = H / KH;
  size_t smem = flash_smem_bytes<T, D>(G);
  cudaError_t e = allow_smem(paged_decode_local_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  paged_decode_local_kernel<T, D><<<dim3(B, KH), NT, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q), kv, page_tables, pool_lens,
      static_cast<const T*>(loc_k), static_cast<const T*>(loc_v), K, step_idx, H, G);
  return (int)cudaGetLastError();
}

}  // namespace dyn

#define LAUNCH_DECODE_LOCAL(T, D)                                               \
  dyn::launch_decode_local<T, D>(out, q, kv, page_tables, pool_lens, loc_k,     \
                                 loc_v, K, step_idx, B, H, KH,                  \
                                 static_cast<cudaStream_t>(stream))

// out, q: [B, H, D]; pool arguments as dyn_paged_decode; pool_lens: [B]
// int32; loc_k, loc_v: [B, K, KH, D] contiguous in q's dtype, K <= 64;
// step_idx: [1] int32 on the device. Returns as dyn_paged_decode.
extern "C" int dyn_paged_decode_local(void* out, const void* q, const void* kv_k,
                                      const void* kv_v, const float* k_scale,
                                      const float* v_scale, int kv_bits,
                                      const int* page_tables, int max_pages,
                                      int num_phys, long long s_page, long long s_tok,
                                      long long s_head, const int* pool_lens,
                                      const void* loc_k, const void* loc_v, int K,
                                      const int* step_idx, int B, int H, int KH,
                                      int D, int page_size, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || K <= 0 || K > dyn::KT_MAX ||
      !dyn::page_size_ok(page_size, kv_bits))
    return dyn::ERR_UNSUPPORTED;
  dyn::PagedKV kv = dyn::make_kv(kv_k, kv_v, k_scale, v_scale, kv_bits, max_pages,
                                 num_phys, page_size, KH, s_page, s_tok, s_head);
  DYN_DISPATCH(dtype, D, LAUNCH_DECODE_LOCAL);
}
