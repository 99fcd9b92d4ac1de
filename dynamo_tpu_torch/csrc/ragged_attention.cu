// Ragged paged attention over a flat buffer of mixed prefill + decode rows.
//
// Replaces the TPU kernel `_ragged_kernel` of
// dynamo_tpu/ops/pallas_ragged_attention.py (wrapper
// `ragged_paged_attention_pallas`): one flat [N, H, D] buffer packs R rows
// — prefill chunks (row_len > 1) and decode lanes (row_len == 1). The
// token at in-row offset j of row r has position ctx_lens[r] + j and
// attends keys <= its position and < ctx_lens[r] + row_lens[r]; flat
// tokens outside every row are not computed (the wrapper hands in a
// zero-filled output, so they stay finite).
//
// Bound on this card: as the prefill kernel for chunk rows (products) and
// as the decode kernel for one-token rows (bytes of the row's context).
// Unlike the TPU kernel, rows need NO alignment in the flat buffer
// (`ragged_tile_q()` is 1): a block finds its row itself. Tile i of the
// grid belongs to the row whose running tile count covers i (row r owns
// ceil(row_lens[r] / 16) tiles); one thread walks the <= R row lengths to
// find it — R is at most a few hundred and the walk is an L2-resident
// read. grid.x = ceil(N / 16) + R bounds the tile count for any packing;
// surplus blocks exit at once. Quantized pools (int8/int4) are dequantized
// while a tile is staged (flash_paged.cuh), replacing the TPU kernel's
// `dequant_window` (pallas_ragged_attention.py:142).
#include "flash_paged.cuh"

namespace dyn {

template <typename T, int D>
__global__ void __launch_bounds__(NT)
ragged_attention_kernel(T* __restrict__ out, const T* __restrict__ q, PagedKV kv,
                        const int* __restrict__ page_tables,
                        const int* __restrict__ row_starts,
                        const int* __restrict__ row_lens,
                        const int* __restrict__ ctx_lens, int N, int R_rows, int H,
                        int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_row, s_local0;
  if (threadIdx.x == 0) {
    int tile = blockIdx.x, acc = 0, row = -1, local0 = 0;
    for (int r = 0; r < R_rows; ++r) {
      int len = row_lens[r];
      int nt = len > 0 ? (len + TQ_TILE - 1) / TQ_TILE : 0;
      if (tile < acc + nt) {
        row = r;
        local0 = (tile - acc) * TQ_TILE;
        break;
      }
      acc += nt;
    }
    s_row = row;
    s_local0 = local0;
  }
  __syncthreads();
  const int row = s_row, local0 = s_local0;
  if (row < 0) return;
  const int kh = blockIdx.y;
  const int len = row_lens[row], ctx = ctx_lens[row];
  const int tok0 = row_starts[row] + local0;
  int n_tok = len - local0;
  if (n_tok > TQ_TILE) n_tok = TQ_TILE;
  if (tok0 < 0 || tok0 + n_tok > N) return;  // malformed row: leave zeros
  kv.table = page_tables + (long long)row * kv.max_pages;
  const long long o = ((long long)tok0 * H + (long long)kh * G) * D;
  flash_tile<T, D>(smem_raw, q + o, out + o, (long long)H * D, n_tok, G, ctx + local0,
                   ctx + len, kv, kh);
}

template <typename T, int D>
int launch_ragged(void* out, const void* q, PagedKV kv, const int* page_tables,
                  const int* row_starts, const int* row_lens, const int* ctx_lens,
                  int N, int R_rows, int H, int KH, cudaStream_t stream) {
  const int G = H / KH;
  size_t smem = flash_smem_bytes<T, D>(TQ_TILE * G);
  cudaError_t e = allow_smem(ragged_attention_kernel<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + TQ_TILE - 1) / TQ_TILE + R_rows, KH);
  ragged_attention_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q), kv, page_tables, row_starts,
      row_lens, ctx_lens, N, R_rows, H, G);
  return (int)cudaGetLastError();
}

}  // namespace dyn

#define LAUNCH_RAGGED(T, D)                                                    \
  dyn::launch_ragged<T, D>(out, q, kv, page_tables, row_starts, row_lens,      \
                           ctx_lens, N, R_rows, H, KH,                         \
                           static_cast<cudaStream_t>(stream))

// out, q: [N, H, D] (out zero-filled by the caller); page_tables:
// [R_rows, max_pages]; row_starts, row_lens, ctx_lens: [R_rows] int32.
// Other arguments and the return value as dyn_paged_decode.
extern "C" int dyn_ragged_attention(void* out, const void* q, const void* kv_k,
                                    const void* kv_v, const float* k_scale,
                                    const float* v_scale, int kv_bits,
                                    const int* page_tables, int max_pages,
                                    int num_phys, long long s_page, long long s_tok,
                                    long long s_head, const int* row_starts,
                                    const int* row_lens, const int* ctx_lens, int N,
                                    int R_rows, int H, int KH, int D, int page_size,
                                    int dtype, void* stream) {
  if (N <= 0 || R_rows <= 0) return 0;
  if (KH <= 0 || H % KH != 0 || !dyn::page_size_ok(page_size, kv_bits))
    return dyn::ERR_UNSUPPORTED;
  dyn::PagedKV kv = dyn::make_kv(kv_k, kv_v, k_scale, v_scale, kv_bits, max_pages,
                                 num_phys, page_size, KH, s_page, s_tok, s_head);
  DYN_DISPATCH(dtype, D, LAUNCH_RAGGED);
}
