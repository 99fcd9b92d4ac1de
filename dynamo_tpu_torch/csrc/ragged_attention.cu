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
// Bound on this card: as the prefill kernel for chunk rows (products,
// bf16 at 989 TFLOP/s) and as the decode kernel for one-token rows (bytes
// of the row's context, 3.35 TB/s).
//
// Unlike the TPU kernel, rows need NO alignment in the flat buffer
// (`ragged_tile_q()` is 1): a block finds its row itself. Row r owns
// ceil(row_lens[r] / TQ) tiles; tile i of the grid belongs to the row
// whose running tile count covers i, and the first warp finds it from the
// row lengths, 32 rows at a time with a prefix sum across its lanes.
// ceil(N / TQ) + R tiles bound the count for any packing; surplus blocks
// exit at once.
//
// bf16 (the engine's dtype) runs the tensor-core body of flash_mma.cuh
// (mma.sync.m16n8k16, cp.async double-buffered K/V tiles) with
// TQ = floor(64 / G) tokens x G heads per block: grid = (KH, ceil(N / TQ) +
// R), the tiles in reverse, so within a row its longest causal ranges start
// first. A decode row is one tile of G rows: 3 of the 4 warps skip its
// products, and the block stays bound by its context's bytes. f32 keeps
// the FMA body of flash_paged.cuh with TQ = 16 (grid (ceil(N / 16) + R,
// KH)). Quantized pools (int8/int4) are dequantized after a tile is staged,
// replacing the TPU kernel's `dequant_window`
// (pallas_ragged_attention.py:142).
//
// Left for later: split-KV for long one-token rows, wgmma + TMA, a
// persistent grid.
#include "flash_mma.cuh"

namespace dyn {

// The tile of up to TQ tokens a block serves: tile `tile` belongs to the
// row whose running count of TQ-token tiles covers it, found by the first
// warp 32 row lengths at a time with a prefix sum across its lanes. False
// (for every thread) past the last tile and for a malformed row, whose
// tokens stay the wrapper's zeros.
struct RaggedTile {
  int row, tok0, n_tok, kv_base, kv_total;
};

__device__ bool ragged_tile(int tile, int TQ, const int* __restrict__ row_starts,
                            const int* __restrict__ row_lens,
                            const int* __restrict__ ctx_lens, int N, int R_rows,
                            RaggedTile& t) {
  __shared__ int s_row, s_local0;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int acc = 0, row = -1, local0 = 0;
    for (int base = 0; base < R_rows; base += 32) {
      const int r = base + lane;
      const int len = r < R_rows ? row_lens[r] : 0;
      const int nt = len > 0 ? (len + TQ - 1) / TQ : 0;
      int incl = nt;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(fm::FULL, incl, d);
        if (lane >= d) incl += v;
      }
      const int lo = acc + incl - nt;
      const unsigned hit = __ballot_sync(fm::FULL, tile >= lo && tile < acc + incl);
      if (hit) {
        const int src = __ffs(hit) - 1;
        row = base + src;
        local0 = (tile - __shfl_sync(fm::FULL, lo, src)) * TQ;
        break;
      }
      acc += __shfl_sync(fm::FULL, incl, 31);
    }
    if (lane == 0) {
      s_row = row;
      s_local0 = local0;
    }
  }
  __syncthreads();
  const int row = s_row, local0 = s_local0;
  if (row < 0) return false;
  const int len = row_lens[row], ctx = ctx_lens[row];
  t.row = row;
  t.tok0 = row_starts[row] + local0;
  t.n_tok = len - local0 < TQ ? len - local0 : TQ;
  t.kv_base = ctx + local0;
  t.kv_total = ctx + len;
  return t.tok0 >= 0 && t.tok0 + t.n_tok <= N;
}

// f32: the FMA body
template <typename T, int D>
__global__ void __launch_bounds__(NT)
ragged_attention_kernel(T* __restrict__ out, const T* __restrict__ q, PagedKV kv,
                        const int* __restrict__ page_tables,
                        const int* __restrict__ row_starts,
                        const int* __restrict__ row_lens,
                        const int* __restrict__ ctx_lens, int N, int R_rows, int H,
                        int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RaggedTile t;
  if (!ragged_tile(blockIdx.x, TQ_TILE, row_starts, row_lens, ctx_lens, N, R_rows, t))
    return;
  const int kh = blockIdx.y;
  kv.table = page_tables + (long long)t.row * kv.max_pages;
  const long long o = ((long long)t.tok0 * H + (long long)kh * G) * D;
  flash_tile<T, D>(smem_raw, q + o, out + o, (long long)H * D, t.n_tok, G, t.kv_base,
                   t.kv_total, kv, kh);
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

// bf16: the tensor-core body; the tiles run in reverse
template <int D>
__global__ void __launch_bounds__(NT)
ragged_attention_mma_kernel(__nv_bfloat16* __restrict__ out,
                            const __nv_bfloat16* __restrict__ q, PagedKV kv,
                            const int* __restrict__ page_tables,
                            const int* __restrict__ row_starts,
                            const int* __restrict__ row_lens,
                            const int* __restrict__ ctx_lens, int N, int R_rows, int H,
                            int G, int TQ) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  RaggedTile t;
  if (!ragged_tile(gridDim.y - 1 - blockIdx.y, TQ, row_starts, row_lens, ctx_lens, N,
                   R_rows, t))
    return;
  const int kh = blockIdx.x;
  kv.table = page_tables + (long long)t.row * kv.max_pages;
  const long long o = ((long long)t.tok0 * H + (long long)kh * G) * D;
  fm::flash_mma_tile<D>(smem_raw, q + o, out + o, (long long)H * D, t.n_tok, G,
                        t.kv_base, t.kv_total, kv, kh);
}

template <int D>
int launch_ragged_mma(void* out, const void* q, PagedKV kv, const int* page_tables,
                      const int* row_starts, const int* row_lens, const int* ctx_lens,
                      int N, int R_rows, int H, int KH, cudaStream_t stream) {
  const int G = H / KH;
  if (!fm::shape_ok(G, kv)) return ERR_UNSUPPORTED;
  const int TQ = fm::M_ROWS / G;
  const size_t smem = fm::Smem<D>::bytes(kv.bits);
  cudaError_t e = allow_smem(ragged_attention_mma_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(KH, (N + TQ - 1) / TQ + R_rows);
  ragged_attention_mma_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<__nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(q), kv,
      page_tables, row_starts, row_lens, ctx_lens, N, R_rows, H, G, TQ);
  return (int)cudaGetLastError();
}

}  // namespace dyn

#define LAUNCH_RAGGED(T, D)                                                    \
  dyn::launch_ragged<T, D>(out, q, kv, page_tables, row_starts, row_lens,      \
                           ctx_lens, N, R_rows, H, KH,                         \
                           static_cast<cudaStream_t>(stream))
#define LAUNCH_RAGGED_MMA(D)                                                   \
  dyn::launch_ragged_mma<D>(out, q, kv, page_tables, row_starts, row_lens,     \
                            ctx_lens, N, R_rows, H, KH,                        \
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
  DYN_DISPATCH_MMA(dtype, D, LAUNCH_RAGGED_MMA, LAUNCH_RAGGED);
}
