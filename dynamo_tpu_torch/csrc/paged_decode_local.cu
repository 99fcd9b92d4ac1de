// One-token flash decode over a READ-ONLY paged pool plus a block-local
// KV buffer, merged in one online softmax, split over the grid.
//
// Replaces the TPU kernel `_decode_local_kernel` of
// dynamo_tpu/ops/pallas_paged_attention.py (wrapper
// `paged_attention_decode_pallas_local`, :422) and, for int8/int4 pools,
// its `_window_dequant` (:40): the local decode block keeps the pool
// unwritten for its K steps, each step's new K/V sit in a per-layer buffer
// loc_k/loc_v [B, K, KH, D] (compute dtype, always full precision), and
// lane b's query attends pool keys < pool_lens[b] plus local entries
// j <= step_idx. step_idx is read from device memory (a one-element int32
// tensor), and nothing the host passes depends on it or on pool_lens, so a
// captured CUDA graph can replay the block unchanged.
//
// Unlike the TPU kernel, a lane with pool_lens[b] == 0 attends no pool key
// (the TPU kernel clamps the pool length to 1): this is what the reference's
// plain path computes, and only inactive lanes, whose output is discarded,
// have an empty pool.
//
// Bound on this card: bytes, as paged_decode.cu (each lane's pool pages
// read once, plus B * n_loc * KH * D local entries). It runs the same body
// (flash_decode.cuh with LOCAL): the pool pages of a lane are cut into
// splits walked by a grid sized to the card, and the local rows are more
// tiles of the ring in the lane's last split (a lane with an empty pool
// keeps one item holding only its local rows); splits are merged in the
// same launch.
#include "flash_decode.cuh"

#define LAUNCH_DECODE_LOCAL(T, D) \
  dyn::fd::launch<T, D, true>(a, num_sms, static_cast<cudaStream_t>(stream))

// out, q: [B, H, D]; pool arguments and the split plan, scratch and
// counters as dyn_paged_decode (the two may share one stream's scratch);
// pool_lens: [B] int32, 0 allowed; loc_k, loc_v: [B, K, KH, D] contiguous
// in q's dtype, 16-byte aligned, 1 <= K <= 64; step_idx: [1] int32 on the
// device. Returns as dyn_paged_decode.
extern "C" int dyn_paged_decode_local(void* out, const void* q, const void* kv_k,
                                      const void* kv_v, const float* k_scale,
                                      const float* v_scale, int kv_bits,
                                      const int* page_tables, int max_pages,
                                      int num_phys, long long s_page, long long s_tok,
                                      long long s_head, const int* pool_lens,
                                      const void* loc_k, const void* loc_v, int K,
                                      const int* step_idx, int B, int H, int KH,
                                      int D, int page_size, int dtype, int n_splits,
                                      int split_pages, float* ws_o, float* ws_ml,
                                      int* counters, int num_sms, void* stream) {
  if (B <= 0) return 0;
  if (!dyn::fd::plan_ok(B, H, KH, page_size, kv_bits, max_pages, n_splits, split_pages, ws_o,
                        ws_ml, counters, num_sms) ||
      K <= 0 || K > dyn::KT_MAX || loc_k == nullptr || loc_v == nullptr || step_idx == nullptr)
    return dyn::ERR_UNSUPPORTED;
  dyn::fd::DecodeArgs a{out, q,
                        dyn::make_kv(kv_k, kv_v, k_scale, v_scale, kv_bits, max_pages,
                                     num_phys, page_size, KH, s_page, s_tok, s_head),
                        page_tables, pool_lens, ws_o, ws_ml, counters, B, H, H / KH, n_splits,
                        split_pages,
                        kv_bits == 0 || ((s_page | s_tok | s_head) % 16) == 0,
                        loc_k, loc_v, K, step_idx};
  DYN_DISPATCH(dtype, D, LAUNCH_DECODE_LOCAL);
}
