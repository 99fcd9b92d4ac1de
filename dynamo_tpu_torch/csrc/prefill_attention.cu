// Batched chunked-prefill flash attention over paged KV.
//
// Replaces the TPU kernel `_prefill_kernel` of
// dynamo_tpu/ops/pallas_prefill_attention.py (wrapper
// `paged_prefill_attention_pallas_batched`): the chunk's K/V are already in
// the pages; query row i of sequence b sits at position starts[b] + i and
// attends keys <= its position and < total_lens[b].
//
// Bound on this card: the larger of the products (4 * H * D per visible
// query-key pair under the causal mask, bf16 at 989 TFLOP/s) and one pass
// over each sequence's context K/V; at the engine's chunk sizes the
// products dominate.
//
// bf16 (the engine's dtype) runs the tensor-core body of flash_mma.cuh
// (mma.sync.m16n8k16, cp.async double-buffered K/V tiles):
// grid = (KH, ceil(T / TQ), B) with TQ = floor(64 / G) query tokens x G
// heads = up to 64 MMA rows per block; the token tiles run in reverse, so
// the blocks with the longest causal range start first, over all heads. A
// block stops at its own causal limit min(total, start + t0 + TQ) and never
// reads pages past it, so work follows the causal triangle. f32 keeps the
// FMA body of flash_paged.cuh (16 query tokens per block, grid
// (ceil(T / 16), KH, B)): a TF32 product could not hold f32's tolerance.
//
// Quantized pools (int8/int4) are dequantized after a tile is staged, in
// both bodies. The TPU reference has no kernel for that case (it sends
// quantized prefill to its XLA path); this port keeps it on the card.
//
// Left for later: wgmma + TMA with a warp-specialised producer, a
// persistent grid.
#include "flash_mma.cuh"

namespace dyn {

// f32: the FMA body
template <typename T, int D>
__global__ void __launch_bounds__(NT)
prefill_attention_kernel(T* __restrict__ out, const T* __restrict__ q, PagedKV kv,
                         const int* __restrict__ page_tables,
                         const int* __restrict__ starts,
                         const int* __restrict__ total_lens, int Tq, int H, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int t0 = blockIdx.x * TQ_TILE, kh = blockIdx.y, b = blockIdx.z;
  int n_tok = Tq - t0;
  if (n_tok > TQ_TILE) n_tok = TQ_TILE;
  kv.table = page_tables + (long long)b * kv.max_pages;
  const long long o = (((long long)b * Tq + t0) * H + (long long)kh * G) * D;
  flash_tile<T, D>(smem_raw, q + o, out + o, (long long)H * D, n_tok, G,
                   starts[b] + t0, total_lens[b], kv, kh);
}

template <typename T, int D>
int launch_prefill(void* out, const void* q, PagedKV kv, const int* page_tables,
                   const int* starts, const int* total_lens, int B, int Tq, int H,
                   int KH, cudaStream_t stream) {
  const int G = H / KH;
  size_t smem = flash_smem_bytes<T, D>(TQ_TILE * G);
  cudaError_t e = allow_smem(prefill_attention_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Tq + TQ_TILE - 1) / TQ_TILE, KH, B);
  prefill_attention_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q), kv, page_tables, starts,
      total_lens, Tq, H, G);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core body
template <int D>
__global__ void __launch_bounds__(NT)
prefill_attention_mma_kernel(__nv_bfloat16* __restrict__ out,
                             const __nv_bfloat16* __restrict__ q, PagedKV kv,
                             const int* __restrict__ page_tables,
                             const int* __restrict__ starts,
                             const int* __restrict__ total_lens, int Tq, int H, int G,
                             int TQ) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int kh = blockIdx.x, b = blockIdx.z;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * TQ;  // longest causal range first
  int n_tok = Tq - t0;
  if (n_tok > TQ) n_tok = TQ;
  kv.table = page_tables + (long long)b * kv.max_pages;
  const long long o = (((long long)b * Tq + t0) * H + (long long)kh * G) * D;
  fm::flash_mma_tile<D>(smem_raw, q + o, out + o, (long long)H * D, n_tok, G,
                        starts[b] + t0, total_lens[b], kv, kh);
}

template <int D>
int launch_prefill_mma(void* out, const void* q, PagedKV kv, const int* page_tables,
                       const int* starts, const int* total_lens, int B, int Tq, int H,
                       int KH, cudaStream_t stream) {
  const int G = H / KH;
  if (!fm::shape_ok(G, kv)) return ERR_UNSUPPORTED;
  const int TQ = fm::M_ROWS / G;
  const size_t smem = fm::Smem<D>::bytes(kv.bits);
  cudaError_t e = allow_smem(prefill_attention_mma_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(KH, (Tq + TQ - 1) / TQ, B);
  prefill_attention_mma_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(q), kv,
      page_tables, starts, total_lens, Tq, H, G, TQ);
  return (int)cudaGetLastError();
}

}  // namespace dyn

#define LAUNCH_PREFILL(T, D)                                                    \
  dyn::launch_prefill<T, D>(out, q, kv, page_tables, starts, total_lens, B, Tq, \
                            H, KH, static_cast<cudaStream_t>(stream))
#define LAUNCH_PREFILL_MMA(D)                                                   \
  dyn::launch_prefill_mma<D>(out, q, kv, page_tables, starts, total_lens, B, Tq, \
                             H, KH, static_cast<cudaStream_t>(stream))

// out, q: [B, Tq, H, D]; page_tables: [B, max_pages]; starts, total_lens:
// [B] int32. Other arguments and the return value as dyn_paged_decode.
extern "C" int dyn_prefill_attention(void* out, const void* q, const void* kv_k,
                                     const void* kv_v, const float* k_scale,
                                     const float* v_scale, int kv_bits,
                                     const int* page_tables, int max_pages,
                                     int num_phys, long long s_page, long long s_tok,
                                     long long s_head, const int* starts,
                                     const int* total_lens, int B, int Tq, int H,
                                     int KH, int D, int page_size, int dtype,
                                     void* stream) {
  if (B <= 0 || Tq <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || !dyn::page_size_ok(page_size, kv_bits))
    return dyn::ERR_UNSUPPORTED;
  dyn::PagedKV kv = dyn::make_kv(kv_k, kv_v, k_scale, v_scale, kv_bits, max_pages,
                                 num_phys, page_size, KH, s_page, s_tok, s_head);
  DYN_DISPATCH_MMA(dtype, D, LAUNCH_PREFILL_MMA, LAUNCH_PREFILL);
}
