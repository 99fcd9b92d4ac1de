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
// Left for later: TMA, folding the local kernel in.
#include "flash_decode.cuh"

namespace dyn {

// at most 128 registers a thread at 3 rows (four blocks an SM where the
// ring's shared memory allows: more warps to hide each one's latency); 8
// rows keep their registers
template <typename T, int D, int GC>
__global__ void __launch_bounds__(NT, GC >= 8 ? 1 : 4) paged_decode_kernel(fd::DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  fd::decode_items<T, D, GC>(smem_raw, a);
}

template <typename T, int D, int GC>
int launch_decode(const fd::DecodeArgs& a, int num_sms, cudaStream_t stream) {
  const size_t smem = fd::smem_bytes<T, D, GC>(a);
  cudaError_t e = allow_smem(paged_decode_kernel<T, D, GC>, smem);
  if (e != cudaSuccess) return (int)e;
  // as many blocks as fit the card at once, none idle from the start
  static size_t occ_smem = 0;
  static int occ = 0;
  if (occ_smem != smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, paged_decode_kernel<T, D, GC>,
                                                      NT, smem);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    occ_smem = smem;
  }
  const long long items = (long long)a.B * a.kv.KH * a.n_splits;
  const int grid = (int)(items < (long long)occ * num_sms ? items : (long long)occ * num_sms);
  paged_decode_kernel<T, D, GC><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// two row counts live in registers: GC = 3 (Llama-3.2-3B's G, the served
// and timed one; G = 1, 2 leave rows idle) and GC = 8 (G = 4..8 in one
// group; more loop over groups of 8). Each GC is 6 more instantiations
// (dtype x D) to build.
template <typename T, int D>
int launch_decode_g(const fd::DecodeArgs& a, int num_sms, cudaStream_t stream) {
  if (a.G <= 3) return launch_decode<T, D, 3>(a, num_sms, stream);
  return launch_decode<T, D, 8>(a, num_sms, stream);
}

}  // namespace dyn

#define LAUNCH_DECODE(T, D) \
  dyn::launch_decode_g<T, D>(a, num_sms, static_cast<cudaStream_t>(stream))

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
  if (KH <= 0 || H % KH != 0 || !dyn::page_size_ok(page_size, kv_bits) || n_splits < 1 ||
      split_pages < 1 || (long long)n_splits * split_pages < max_pages ||
      (long long)(n_splits - 1) * split_pages >= max_pages || num_sms < 1 ||
      (n_splits > 1 && (ws_o == nullptr || ws_ml == nullptr || counters == nullptr)))
    return dyn::ERR_UNSUPPORTED;
  dyn::fd::DecodeArgs a{out, q,
                        dyn::make_kv(kv_k, kv_v, k_scale, v_scale, kv_bits, max_pages,
                                     num_phys, page_size, KH, s_page, s_tok, s_head),
                        page_tables, seq_lens, ws_o, ws_ml, counters, B, H, H / KH, n_splits,
                        split_pages,
                        kv_bits == 0 || ((s_page | s_tok | s_head) % 16) == 0};
  DYN_DISPATCH(dtype, D, LAUNCH_DECODE);
}

extern "C" const char* dyn_error_string(int code) {
  if (code == dyn::ERR_UNSUPPORTED)
    return "unsupported dtype, head_dim, head grouping, page_size, KV format, local size "
           "or split plan";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
