// One-token flash decode over paged KV, split over the grid.
//
// Replaces the TPU kernel `_decode_kernel` of
// dynamo_tpu/ops/pallas_paged_attention.py (wrapper
// `paged_attention_decode_pallas`, :514) and, for int8/int4 pools, its
// `_window_dequant` (:40): lane b's query attends its own pages, keys
// < max(seq_lens[b], 1) (an empty lane behaves as length 1).
//
// Bound on this card: bytes — each lane's real context K and V read once
// in the pool's stored type (bf16/f32, int8 or int4 plus two f32 scales a
// page and KV head). The body (flash_decode.cuh) cuts each lane's pages
// into splits and lets a grid of as many blocks as the card holds walk the
// live (lane, KV head, split) items, so that a few long lanes still fill
// the SMs and short lanes cost no block; it streams raw tiles through a
// 2-4 stage cp.async ring so loads overlap the arithmetic, and keeps q, the
// softmax state and O in registers (CUDA cores, f32). Lanes that needed
// more than one split are combined by the last of their splits' blocks to
// finish, inside the same launch.
// Left for later: TMA.
#include "flash_decode.cuh"

#define LAUNCH_DECODE(T, D) \
  dyn::fd::launch<T, D, false>(a, num_sms, static_cast<cudaStream_t>(stream))

// out, q: [B, H, D]; kv_k, kv_v: [num_phys, rows, KH, D] with strides
// (s_page, s_tok, s_head) in elements of the pool's type — T, or int8 with
// rows = page_size (kv_bits 8) or page_size / 2 (kv_bits 4); k_scale,
// v_scale: f32 [num_phys, KH] when kv_bits != 0, else null; page_tables:
// [B, max_pages] int32; seq_lens: [B] int32. The caller's split plan:
// n_splits runs of split_pages logical pages (n_splits * split_pages >=
// max_pages); when n_splits > 1, ws_o (f32 [B, KH, n_splits, G, D]) and
// ws_ml (f32 [B, KH, n_splits, G, 2]) are scratch and counters (int32
// [B, KH]) must hold zeros, which the launch leaves behind for the next
// one on the same stream; else all three may be null. B is bounded
// by shared memory: every block holds 8 bytes a lane (the lanes' lengths
// and live-split prefix) beside its ring, so at D = 128 a launch takes up
// to about 20,000 lanes on a bf16 pool and 12,000 on an f32 one; past
// that the launch fails with the kernel's shared-memory error. Returns
// cudaGetLastError() (0 = launched), or a negative code for a dtype /
// head_dim / page_size / format / plan that is not built.
extern "C" int dyn_paged_decode(void* out, const void* q, const void* kv_k,
                                const void* kv_v, const float* k_scale,
                                const float* v_scale, int kv_bits,
                                const int* page_tables, int max_pages, int num_phys,
                                long long s_page, long long s_tok, long long s_head,
                                const int* seq_lens, int B, int H, int KH, int D,
                                int page_size, int dtype, int n_splits, int split_pages,
                                float* ws_o, float* ws_ml, int* counters, int num_sms,
                                void* stream) {
  if (B <= 0) return 0;
  if (!dyn::fd::plan_ok(B, H, KH, page_size, kv_bits, max_pages, n_splits, split_pages, ws_o,
                        ws_ml, counters, num_sms))
    return dyn::ERR_UNSUPPORTED;
  dyn::fd::DecodeArgs a{out, q,
                        dyn::make_kv(kv_k, kv_v, k_scale, v_scale, kv_bits, max_pages,
                                     num_phys, page_size, KH, s_page, s_tok, s_head),
                        page_tables, seq_lens, ws_o, ws_ml, counters, B, H, H / KH, n_splits,
                        split_pages,
                        kv_bits == 0 || ((s_page | s_tok | s_head) % 16) == 0,
                        nullptr, nullptr, 0, nullptr};
  DYN_DISPATCH(dtype, D, LAUNCH_DECODE);
}

extern "C" const char* dyn_error_string(int code) {
  if (code == dyn::ERR_UNSUPPORTED)
    return "unsupported dtype, head_dim, head grouping, page_size, KV format, local size "
           "or split plan";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
