// Tensor-core flash attention over one sequence's paged KV: the bf16 body of
// the two multi-query kernels, prefill_attention.cu and ragged_attention.cu.
//
// Replaces, for bf16 inputs, the f32-FMA body (flash_paged.cuh) in the
// Hopper counterparts of the TPU kernels `_prefill_kernel`
// (dynamo_tpu/ops/pallas_prefill_attention.py:250) and `_ragged_kernel`
// (dynamo_tpu/ops/pallas_ragged_attention.py:336), together with the
// latter's page dequant `dequant_window` (pallas_ragged_attention.py:142).
// f32 inputs keep the FMA body: a TF32 product could not hold f32's
// tolerance.
//
// Bound on this card: chunk rows are bound by their products (4 * D
// operations per visible query-key pair and query head, bf16 at 989
// TFLOP/s dense); one-token rows by the bytes of their context (each K/V
// byte read once, 3.35 TB/s).
//
// Design (route: mma.sync, not wgmma). One block of 4 warps serves one KV
// head of one sequence (or ragged row) and a tile of TQ = floor(64 / G)
// query tokens x G query heads as the MMA's M rows: row r is token r / G,
// head kh * G + r % G (per-row q addresses; the rows of a KV head are not
// evenly strided). Each warp owns 16 rows. Q.K^T and P.V run on the tensor
// cores as mma.sync.m16n8k16 bf16 x bf16 -> f32, fragments loaded by
// ldmatrix (V through ldmatrix.trans: the pool keeps D contiguous). Scores
// stay in registers and are scaled by 1/sqrt(D) in f32 after the product
// (q is never scaled before it is rounded); the online softmax runs in
// registers, row max and row sum across the 4 lanes of a quad; P is
// rounded to bf16 straight from the score accumulators as the A operand of
// P.V, as the plain version and the reference round probabilities; O
// accumulates in f32 registers and is normalised once. K/V tiles of
// kt = min(page_size, 64) keys (never across a page; padded with masked
// zero keys to the 16-key MMA depth) stream through a 2-stage ring in
// shared memory filled by cp.async.cg 16-byte copies, so tile k+1 is in
// flight while tile k is multiplied. Shared-memory rows are padded by 16
// bytes, which leaves ldmatrix free of bank conflicts. Page ids (and the
// scales of a quantized page) are read one tile ahead of their use.
// Quantized pools: cp.async cannot dequantize on the way, so it copies the
// stored ints into a 2-stage byte ring, and each tile is dequantized
// shared -> shared into one bf16 tile (float(q) * scale rounded to bf16,
// dequant_vec's arithmetic with a cheaper int -> float step) before the
// products; everything after that is format-blind.
//
// Contract (as flash_paged.cuh): f32 softmax state, masked scores NEG with
// the guard against exp(NEG - NEG), clamped page ids, token t of the tile
// sees keys < min(kv_base + t + 1, kv_total), the block stops at its last
// token's limit (causal early exit) and a warp skips the products of a tile
// none of its rows can see; a row that sees no key returns zeros.
//
// Left for later: wgmma with TMA loads and a warp-specialised producer,
// a persistent grid, split-KV for long one-token rows.
#pragma once

#include "flash_paged.cuh"

namespace dyn {
namespace fm {

typedef __nv_bfloat16 bf16;
constexpr int WARPS = NT / 32;      // 4
constexpr int M_ROWS = 16 * WARPS;  // query rows (tokens x heads) per block
constexpr int KT = KT_MAX;          // key slots of a shared-memory tile
constexpr int STAGES = 2;
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory layout of a block: the Q tile, then (bf16 pool) a ring of
// STAGES K+V tiles, or (quantized pool) one K+V tile and a ring of STAGES
// raw K+V byte tiles.
template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // padded bf16 row: conflict-free ldmatrix
  static constexpr size_t Q = (size_t)M_ROWS * LD * sizeof(bf16);
  static constexpr size_t TILE = (size_t)2 * KT * LD * sizeof(bf16);
  static constexpr size_t RAW = (size_t)2 * KT * D;
  static size_t bytes(int bits) { return Q + (bits ? TILE + STAGES * RAW : STAGES * TILE); }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 8 stored values of one key row (8 int8 bytes, or the low / high nibbles
// of 8 int4 bytes) -> 8 bf16 at dst: float(q) * scale rounded to bf16, the
// arithmetic of dequant_vec (flash_paged.cuh), bit for bit. The int ->
// float step is a byte permute into the mantissa of 2^23 and one exact f32
// subtraction (q biased to unsigned by an xor of its sign bit), in place of
// the quarter-rate I2F conversion that dominated the dequant.
__device__ __forceinline__ void dequant8(const int8_t* src, int bits, bool high,
                                         float scale, bf16* dst) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  uint32_t w[2] = {raw.x, raw.y};
  float bias;
  if (bits == 4) {
#pragma unroll
    for (int i = 0; i < 2; ++i) w[i] = ((high ? w[i] >> 4 : w[i]) & 0x0F0F0F0Fu) ^ 0x08080808u;
    bias = 8388608.f + 8.f;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) w[i] ^= 0x80808080u;
    bias = 8388608.f + 128.f;
  }
  uint4 out;
  uint32_t* o = &out.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float a = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650u | (2 * p))) - bias;
      const float b = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7651u | (2 * p))) - bias;
      o[2 * i + p] = pack_bf16(a * scale, b * scale);
    }
  }
  *reinterpret_cast<uint4*>(dst) = out;
}

// Where tile `key0` of a sequence lives: its clamped physical page and,
// for a quantized pool, that page's two scales.
struct TileSrc {
  int phys;
  float k_sc, v_sc;
};

__device__ __forceinline__ TileSrc tile_src(const PagedKV& kv, int kh, int key0) {
  int lp = key0 / kv.page_size;
  if (lp > kv.max_pages - 1) lp = kv.max_pages - 1;
  int phys = kv.table[lp];
  if (phys > kv.num_phys - 1) phys = kv.num_phys - 1;
  if (phys < 0) phys = 0;
  TileSrc s{phys, 0.f, 0.f};
  if (kv.bits) {
    s.k_sc = kv.k_scale[(long long)phys * kv.KH + kh];
    s.v_sc = kv.v_scale[(long long)phys * kv.KH + kh];
  }
  return s;
}

// Host side: what the body takes besides flash_paged.cuh's page rules.
inline bool shape_ok(int G, const PagedKV& kv) {
  if (G < 1 || G > M_ROWS) return false;
  // cp.async moves 16-byte pieces of the stored rows (bf16 strides are
  // already multiples of 8 elements)
  return kv.bits == 0 || ((kv.s_page | kv.s_tok | kv.s_head) % 16) == 0;
}

// Flash attention of one tile of n_tok (<= M_ROWS / G) query tokens x G
// heads over one sequence's pages. q0/out0 point at the tile's first token
// and the KV head's first query head ([.., H, D], token stride tok_stride).
template <int D>
__device__ void flash_mma_tile(unsigned char* smem, const bf16* __restrict__ q0,
                               bf16* __restrict__ out0, long long tok_stride, int n_tok,
                               int G, int kv_base, int kv_total, const PagedKV& kv,
                               int kh) {
  using L = Smem<D>;
  constexpr int LD = L::LD;
  constexpr int CPR = D / 8;       // 16-byte chunks of a bf16 row
  constexpr int RAW_CPR = D / 16;  // 16-byte chunks of a stored int8 row
  constexpr int KSTEPS = D / 16;   // MMA depth steps over D
  constexpr int DBLK = D / 8;      // 8-wide column blocks of O
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* tiles = reinterpret_cast<bf16*>(smem + L::Q);
  int8_t* raw = reinterpret_cast<int8_t*>(smem + L::Q + L::TILE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = n_tok * G;

  // Q rows -> shared memory; rows past R are zeros
  for (int c = tid; c < M_ROWS * CPR; c += NT) {
    const int r = c / CPR, dc = (c - r * CPR) * 8;
    const bool ok = r < R;
    const int t = ok ? r / G : 0, g = ok ? r - t * G : 0;
    cp_async16(qs + r * LD + dc, q0 + t * tok_stride + g * D + dc, ok);
  }
  cp_async_commit();

  int limit = kv_base + n_tok;
  if (limit > kv_total) limit = kv_total;
  const int ps = kv.page_size;
  const int kt = ps < KT ? ps : KT;
  const int n_tiles = limit > 0 ? (limit + kt - 1) / kt : 0;
  const int k16 = (kt + 15) >> 4;  // 16-key MMA steps of a tile
  const int ktp = k16 * 16;        // staged key slots (zeros past kt)
  const int half = ps / 2;

  // keys visible to row r: < min(kv_base + t + 1, kv_total); none past R
  auto kv_len = [&](int r) {
    if (r >= R) return 0;
    const int n = kv_base + r / G + 1;
    return n < kv_total ? n : kv_total;
  };
  const int ra = warp * 16 + (lane >> 2), rb = ra + 8;  // this thread's two rows
  const int len_a = kv_len(ra), len_b = kv_len(rb);
  const int w_last = warp * 16 + 15 < R ? warp * 16 + 15 : R - 1;
  const int warp_len = warp * 16 < R ? kv_len(w_last) : 0;  // rows grow with r

  // start the copies of tile ti (page `phys`) into ring slot `stage`
  auto fetch = [&](int ti, int phys, int stage) {
    const int key0 = ti * kt;
    const int off = key0 - (key0 / ps) * ps;
    int n_valid = limit - key0;
    if (n_valid > kt) n_valid = kt;
    const long long head_off = (long long)kh * kv.s_head;
    if (kv.bits == 0) {
      const bf16* kp = static_cast<const bf16*>(kv.k);
      const bf16* vp = static_cast<const bf16*>(kv.v);
      const long long base = (long long)phys * kv.s_page + (long long)off * kv.s_tok + head_off;
      bf16* ks = tiles + stage * 2 * KT * LD;
      bf16* vs = ks + KT * LD;
      for (int c = tid; c < ktp * CPR; c += NT) {
        const int j = c / CPR, dc = (c - j * CPR) * 8;
        const bool ok = j < n_valid;
        const long long src = base + (ok ? (long long)j * kv.s_tok + dc : 0);
        cp_async16(ks + j * LD + dc, kp + src, ok);
        cp_async16(vs + j * LD + dc, vp + src, ok);
      }
    } else {
      // stored rows of the tile: int8 key j in row off + j; int4 key o of
      // the page in row o mod ps/2 (a tile of a page > 64 keys lies in one
      // half; a page <= 64 keys is one tile and needs its ps/2 rows)
      const int row0 = (kv.bits == 4 && off >= half) ? off - half : off;
      const int n_rows = (kv.bits == 4 && ps <= KT) ? kt / 2 : kt;
      const int8_t* kp = static_cast<const int8_t*>(kv.k);
      const int8_t* vp = static_cast<const int8_t*>(kv.v);
      const long long base = (long long)phys * kv.s_page + (long long)row0 * kv.s_tok + head_off;
      int8_t* rk = raw + stage * 2 * KT * D;
      int8_t* rv = rk + KT * D;
      for (int c = tid; c < n_rows * RAW_CPR; c += NT) {
        const int j = c / RAW_CPR, dc = (c - j * RAW_CPR) * 16;
        const long long src = base + (long long)j * kv.s_tok + dc;
        cp_async16(rk + j * D + dc, kp + src, true);
        cp_async16(rv + j * D + dc, vp + src, true);
      }
    }
  };

  // quantized pool: raw ring slot `stage` (tile ti) -> the bf16 tile
  auto dequant = [&](int ti, int stage, float k_sc, float v_sc) {
    const int key0 = ti * kt;
    const int off = key0 - (key0 / ps) * ps;
    int n_valid = limit - key0;
    if (n_valid > kt) n_valid = kt;
    const int row0 = (kv.bits == 4 && off >= half) ? off - half : off;
    const int8_t* rk = raw + stage * 2 * KT * D;
    const int8_t* rv = rk + KT * D;
    bf16* ks = tiles;
    bf16* vs = ks + KT * LD;
    for (int c = tid; c < ktp * CPR; c += NT) {
      const int j = c / CPR, dc = (c - j * CPR) * 8;
      if (j < n_valid) {
        const int key = off + j;
        const bool high = kv.bits == 4 && key >= half;
        const int row = (high ? key - half : key) - row0;
        dequant8(rk + row * D + dc, kv.bits, high, k_sc, ks + j * LD + dc);
        dequant8(rv + row * D + dc, kv.bits, high, v_sc, vs + j * LD + dc);
      } else {
        *reinterpret_cast<uint4*>(ks + j * LD + dc) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vs + j * LD + dc) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  float o[DBLK][4];
#pragma unroll
  for (int db = 0; db < DBLK; ++db) o[db][0] = o[db][1] = o[db][2] = o[db][3] = 0.f;
  float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;  // l: this lane's partial sums
  const float scale = rsqrtf((float)D);

  TileSrc cur{0, 0.f, 0.f}, nxt{0, 0.f, 0.f};
  if (n_tiles > 0) {
    cur = tile_src(kv, kh, 0);
    fetch(0, cur.phys, 0);
  }
  cp_async_commit();
  if (n_tiles > 1) nxt = tile_src(kv, kh, kt);
  cp_async_wait<1>();  // the Q group has landed
  __syncthreads();

  // Q fragments (A operand): lane l addresses row (l % 8) + 8 * ((l / 8) % 2)
  // of the warp's 16, columns 8 * (l / 16) of each 16-wide step
  uint32_t qf[KSTEPS][4];
  {
    const bf16* p = qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) ldsm_x4(qf[kk], p + kk * 16);
  }

  for (int ti = 0; ti < n_tiles; ++ti) {
    const int stage = ti & 1;
    if (ti + 1 < n_tiles) fetch(ti + 1, nxt.phys, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // tile ti has landed (tile ti + 1 may be in flight)
    __syncthreads();
    const bf16* ks = tiles + stage * 2 * KT * LD;
    if (kv.bits) {
      dequant(ti, stage, cur.k_sc, cur.v_sc);
      __syncthreads();
      ks = tiles;
    }
    const bf16* vs = ks + KT * LD;
    cur = nxt;
    if (ti + 2 < n_tiles) nxt = tile_src(kv, kh, (ti + 2) * kt);  // used next round
    const int key0 = ti * kt;

    if (key0 < warp_len) {  // warp-uniform: some row of this warp sees a key
      // S = Q K^T: K fragments (B operand) by ldmatrix over key rows; lane l
      // addresses key (l % 8) + 8 * (l / 16), column 8 * ((l / 8) % 2)
      float s[8][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p < k16) {
#pragma unroll
          for (int i = 0; i < 4; ++i) s[2 * p][i] = s[2 * p + 1][i] = 0.f;
          const bf16* kp = ks + (p * 16 + (lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int kk = 0; kk < KSTEPS; ++kk) {
            uint32_t b[4];
            ldsm_x4(b, kp + kk * 16);
            mma_bf16(s[2 * p], qf[kk], b[0], b[1]);
            mma_bf16(s[2 * p + 1], qf[kk], b[2], b[3]);
          }
        }
      }
      // scale, mask and the tile's row max: this lane holds rows a (c0, c1)
      // and b (c2, c3) at keys 8 * nb + 2 * (lane % 4) + {0, 1}
      int lim_a = len_a - key0, lim_b = len_b - key0;
      if (lim_a > kt) lim_a = kt;
      if (lim_b > kt) lim_b = kt;
      float mx_a = NEG, mx_b = NEG;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (nb < 2 * k16) {
          const int j = nb * 8 + 2 * (lane & 3);
          s[nb][0] = j < lim_a ? s[nb][0] * scale : NEG;
          s[nb][1] = j + 1 < lim_a ? s[nb][1] * scale : NEG;
          s[nb][2] = j < lim_b ? s[nb][2] * scale : NEG;
          s[nb][3] = j + 1 < lim_b ? s[nb][3] * scale : NEG;
          mx_a = fmaxf(mx_a, fmaxf(s[nb][0], s[nb][1]));
          mx_b = fmaxf(mx_b, fmaxf(s[nb][2], s[nb][3]));
        }
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float al_a = __expf(m_a - mn_a), al_b = __expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      // P = exp(S - m) (masked keys 0, and never exp(NEG - NEG)), rounded to
      // bf16 as the A operand of P.V: a0/a2 row a, a1/a3 row b
      uint32_t pa[4][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p < k16) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float* sv = s[2 * p + h];
            const float p0 = sv[0] > 0.5f * NEG ? __expf(sv[0] - mn_a) : 0.f;
            const float p1 = sv[1] > 0.5f * NEG ? __expf(sv[1] - mn_a) : 0.f;
            const float p2 = sv[2] > 0.5f * NEG ? __expf(sv[2] - mn_b) : 0.f;
            const float p3 = sv[3] > 0.5f * NEG ? __expf(sv[3] - mn_b) : 0.f;
            sum_a += p0 + p1;
            sum_b += p2 + p3;
            pa[p][2 * h] = pack_bf16(p0, p1);
            pa[p][2 * h + 1] = pack_bf16(p2, p3);
          }
        }
      }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int db = 0; db < DBLK; ++db) {
        o[db][0] *= al_a;
        o[db][1] *= al_a;
        o[db][2] *= al_b;
        o[db][3] *= al_b;
      }
      // O += P V: V fragments (B operand) by ldmatrix.trans over key rows;
      // lane l addresses key (l % 8) + 8 * ((l / 8) % 2), column 8 * (l / 16)
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (p < k16) {
          const bf16* vp = vs + (p * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
          for (int dp = 0; dp < DBLK / 2; ++dp) {
            uint32_t b[4];
            ldsm_x4_trans(b, vp + dp * 16);
            mma_bf16(o[2 * dp], pa[p], b[0], b[1]);
            mma_bf16(o[2 * dp + 1], pa[p], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // the slot read here is refilled next round
  }

  // normalise once; a row that saw no key returns zeros
  l_a += __shfl_xor_sync(FULL, l_a, 1);
  l_a += __shfl_xor_sync(FULL, l_a, 2);
  l_b += __shfl_xor_sync(FULL, l_b, 1);
  l_b += __shfl_xor_sync(FULL, l_b, 2);
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  const int col = 2 * (lane & 3);
  if (ra < R) {
    const int t = ra / G, g = ra - t * G;
    bf16* dst = out0 + t * tok_stride + g * D + col;
#pragma unroll
    for (int db = 0; db < DBLK; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(o[db][0] * inv_a, o[db][1] * inv_a);
  }
  if (rb < R) {
    const int t = rb / G, g = rb - t * G;
    bf16* dst = out0 + t * tok_stride + g * D + col;
#pragma unroll
    for (int db = 0; db < DBLK; ++db)
      *reinterpret_cast<__nv_bfloat162*>(dst + db * 8) =
          __floats2bfloat162_rn(o[db][2] * inv_b, o[db][3] * inv_b);
  }
}

}  // namespace fm
}  // namespace dyn

// Dispatch on (dtype, head_dim): bf16 to the tensor-core body's launcher
// LAUNCH_MMA(D), f32 to the FMA body's LAUNCH_FMA(float, D). Both must be
// expressions returning int.
#define DYN_DISPATCH_MMA(dtype, D, LAUNCH_MMA, LAUNCH_FMA)               \
  do {                                                                   \
    if ((dtype) == dyn::DT_BF16) {                                       \
      if ((D) == 128) return LAUNCH_MMA(128);                            \
      if ((D) == 64) return LAUNCH_MMA(64);                              \
      if ((D) == 16) return LAUNCH_MMA(16);                              \
    } else if ((dtype) == dyn::DT_F32) {                                 \
      if ((D) == 128) return LAUNCH_FMA(float, 128);                     \
      if ((D) == 64) return LAUNCH_FMA(float, 64);                       \
      if ((D) == 16) return LAUNCH_FMA(float, 16);                       \
    }                                                                    \
    return dyn::ERR_UNSUPPORTED;                                         \
  } while (0)
