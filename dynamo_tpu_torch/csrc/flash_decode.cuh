// Split-KV flash decode over paged KV: the body of paged_decode.cu and
// paged_decode_local.cu.
//
// Replaces the TPU kernels `_decode_kernel` and `_decode_local_kernel` of
// dynamo_tpu/ops/pallas_paged_attention.py (wrappers
// `paged_attention_decode_pallas`, :514, and
// `paged_attention_decode_pallas_local`, :422) together with their page
// dequant `_window_dequant` (:40): one query token per lane b, its G query
// heads per KV head attend the lane's own pages, keys < max(seq_lens[b], 1);
// the local variant (LOCAL) attends pool keys < pool_lens[b] (none when it
// is 0) plus the block-local rows j <= step_idx of loc_k / loc_v
// [B, K, KH, D] (q's type), in one softmax.
//
// Bound on this card: bytes. Each lane's real context K and V are read
// once (stored type: bf16/f32, or int8 / int4 plus two f32 scales a page
// and KV head); the products, 4 * H * D per key, are far under the FMA
// rate. Decode has G = 2..8 rows per KV head, so the tensor cores would
// idle on 16-row tiles: products run on the CUDA cores in f32.
//
// What the design does about that bound:
// - Split-KV. A lane's pages are cut into splits of at most `split_pages`
//   logical pages, chosen on the host from B, KH, max_pages and page_size
//   (never from seq_lens, which stays on the card): a lane of len keys has
//   max(ceil(len / (split_pages * page_size)), 1) live splits, and they
//   share its pages evenly, so that no split is a sliver. The grid is as
//   many blocks as the card holds at once; each block lists the live (lane,
//   KV head, split) items from seq_lens (a prefix sum over the lanes' live
//   split counts) and walks its share, so a split past a lane's length costs
//   nothing and a few long lanes still fill the SMs. A lane whose keys fit
//   in one split gets its normalised output; the others write f32 partials
//   (running max m in log2 units, running sum l, unnormalised O), and the
//   last of a (lane, KV head)'s splits to finish combines them by the
//   log-sum-exp rule (a self-resetting arrival counter a (lane, KV head)):
//   one launch a call, no second kernel.
// - A cp.async ring of 2-4 raw tiles: K and V rows in the pool's stored
//   type (16-byte cp.async.cg copies, or 8-byte .ca copies for quantized
//   pools whose rows are only 8-byte aligned), zero-filled past the
//   split's last key, with the tile's two scales, so the next tiles are in
//   flight while tile t is used. The ring holds as many tiles as fit ~50
//   KB (2 bf16 tiles at D = 128, 3 int8, 4 int4), which leaves room for 3-4
//   blocks an SM. One barrier per tile: the ring's.
//   A tile is min(rows of a page, 64) stored rows and never straddles a
//   page; an int4 row holds keys o and o + page_size/2 (low nibble first),
//   read once for both.
// - Block-local rows (LOCAL) are more tiles of the lane's last split, after
//   its pool tiles, through the same ring: pieces of as many rows of T as
//   one stage holds (64 over a bf16 pool, 32 int8, 16 int4 at D = 128), only
//   rows < min(step_idx + 1, K) copied, masked by that count and not by the
//   pool's length. A lane with an empty pool keeps one item that holds only
//   its local rows and issues no pool load.
// - Register-resident state. The G rows of q (times log2(e)/sqrt(D)) live
//   in registers as f32; a key's D elements are split over D/8 lanes
//   (8 each), so a warp works on 32*8/D keys at once and a score is a
//   lane-partial product finished by __shfl_xor_sync. Quantized values are
//   dequantized in registers (byte permute into 2^23, float(q) * scale
//   rounded to T: dequant_vec's formula). Each (warp, key slot) keeps its
//   own online softmax (m, l, its O slice) in f32 registers, probabilities
//   unrounded; slots merge by shuffles and warps once through shared
//   memory at the end of the split. G > GC loops over groups of rows.
//
// Contract kept from flash_paged.cuh: f32 softmax state, masked scores NEG
// with the guard against exp(NEG - NEG), an empty lane behaves as length
// 1 (not under LOCAL: there it attends no pool key, as the reference's
// plain path), page ids clamped to the pool, table entries past the lane's
// length never read. A row that sees no key returns zeros.
//
// Left for later: with 12-16 warps an SM each warp's chain of products,
// shuffles and exponentials is long enough that the kernel waits on
// latency before it reaches the byte bound (more independent work per
// warp without more registers); overlapping one item's first loads with
// the previous item's merge; TMA.
#pragma once

#include <type_traits>

#include "flash_paged.cuh"

namespace dyn {
namespace fd {

constexpr int WARPS = NT / 32;
constexpr int RING_BUDGET = 51200;  // bytes a ring aims at: more blocks an SM
constexpr int MAX_STAGES = 4;
constexpr int EPL = 8;  // elements of a key row per lane
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

struct DecodeArgs {
  void* out;          // [B, H, D] T
  const void* q;      // [B, H, D] T
  PagedKV kv;         // table set per block
  const int* tables;  // [B, max_pages]
  const int* seq_lens;
  float* ws_o;   // [B, KH, n_splits, G, D] partial O (null when n_splits == 1)
  float* ws_ml;  // [B, KH, n_splits, G, 2] partial (m, l)
  int* counters;  // [B, KH] splits arrived, zero between launches
  int B, H, G, n_splits, split_pages;
  int a16;  // stored rows 16-byte aligned: one cp.async.cg per 16 bytes
  // LOCAL only (else null / 0): block-local rows [B, K, KH, D] of T, rows
  // 0..step_idx[0] valid (clamped to [0, K]); seq_lens then holds the pool
  // lengths, which may be 0
  const void* loc_k;
  const void* loc_v;
  int K;
  const int* step_idx;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp8(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 8 : 0));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 8 consecutive elements of T -> floats (16 bytes bf16, 32 bytes f32)
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// two products float(q) * scale rounded to T, as floats: bf16 rounds the
// pair with one packed conversion (F2FP) and unpacks it with integer ops,
// which is cheaper than two scalar conversions (F2F)
__device__ __forceinline__ void round_pair(float a, float b, float* f, const __nv_bfloat16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&h);
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xFFFF0000u);
}
__device__ __forceinline__ void round_pair(float a, float b, float* f, const float*) {
  f[0] = a;
  f[1] = b;
}

// 8 stored values of one key row (8 int8 bytes, or the low / high nibbles
// of 8 int4 bytes) -> float(q) * scale rounded to T. The int -> float step
// is a byte permute into the mantissa of 2^23 and one exact subtraction
// (q biased to unsigned by an xor of its sign bit), as in flash_mma.cuh.
template <typename T>
__device__ __forceinline__ void dequant8(uint2 raw, bool int4, bool high, float scale,
                                         float* f) {
  uint32_t w[2] = {raw.x, raw.y};
  float bias;
  if (int4) {
#pragma unroll
    for (int i = 0; i < 2; ++i) w[i] = ((high ? w[i] >> 4 : w[i]) & 0x0F0F0F0Fu) ^ 0x08080808u;
    bias = 8388608.f + 8.f;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i) w[i] ^= 0x80808080u;
    bias = 8388608.f + 128.f;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; j += 2) {
      const float v0 = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650u | j)) - bias;
      const float v1 = __int_as_float(__byte_perm(w[i], 0x4B000000u, 0x7651u | j)) - bias;
      round_pair(v0 * scale, v1 * scale, f + 4 * i + j, static_cast<const T*>(nullptr));
    }
  }
}

// Geometry of a block's tiles, the same on host and device.
struct Tiles {
  int rows_page;  // stored rows a page: page_size, or page_size / 2 (int4)
  int tr;         // stored rows a tile
  int esz;        // bytes a stored element
  int tsz;        // bytes an element of T
  int lr;         // block-local rows of T a stage holds (at least 1)
  __host__ __device__ Tiles(int page_size, int bits, int t_size)
      : rows_page(bits == 4 ? page_size / 2 : page_size),
        tr(rows_page < KT_MAX ? rows_page : KT_MAX),
        esz(bits ? 1 : t_size),
        tsz(t_size),
        lr(tr * esz >= t_size ? tr * esz / t_size : 1) {}
};

template <int D>
__host__ __device__ inline size_t stage_bytes(const Tiles& t) {
  // K rows, V rows (pool rows, or the local rows of T in their place: as
  // many bytes, or one row where a pool tile is smaller), two scales
  const int rows_bytes = t.tr * t.esz > t.lr * t.tsz ? t.tr * t.esz : t.lr * t.tsz;
  return (size_t)2 * rows_bytes * D + 16;
}

// tiles in the ring: as many as fit RING_BUDGET, 2 to MAX_STAGES (bf16 at
// D = 128: 2 tiles of 32 KB; int8: 3 of 16 KB; int4: 4 of 8 KB)
__host__ __device__ inline int ring_stages(size_t stage) {
  const int n = (int)(RING_BUDGET / stage);
  return n < 2 ? 2 : (n > MAX_STAGES ? MAX_STAGES : n);
}

// the ring, reused for the warps' merge (a multiple of 16 bytes)
template <typename T, int D, int GC>
__host__ __device__ inline size_t ring_bytes(int page_size, int bits) {
  const Tiles t(page_size, bits, (int)sizeof(T));
  const size_t ring = ring_stages(stage_bytes<D>(t)) * stage_bytes<D>(t);
  const size_t merge = (size_t)WARPS * GC * (D + 2) * sizeof(float);
  return ((ring > merge ? ring : merge) + 15) & ~(size_t)15;
}

// dynamic shared memory of a block: the ring, then the item's page ids
// [split_pages], the lanes' lengths [B] and their live-split prefix [B + 1]
template <typename T, int D, int GC>
__host__ __device__ inline size_t smem_bytes(const DecodeArgs& a) {
  return ring_bytes<T, D, GC>(a.kv.page_size, a.kv.bits) +
         sizeof(int) * ((size_t)a.split_pages + 2 * (size_t)a.B + 1);
}

// lens[b] = max(seq_lens[b], 1) (LOCAL: max(pool_lens[b], 0)); pref[b] =
// live splits of lanes < b (a lane has max(ceil(len / keys a split), 1) of
// them, at most n_splits: an empty pool's one holds its local rows)
template <bool LOCAL>
__device__ inline void live_prefix(const DecodeArgs& a, int* lens, int* pref) {
  const int sk = a.split_pages * a.kv.page_size;
  constexpr int MIN_LEN = LOCAL ? 0 : 1;
  for (int b = threadIdx.x; b < a.B; b += NT) {
    const int len = a.seq_lens[b] < MIN_LEN ? MIN_LEN : a.seq_lens[b];
    int n = (len + sk - 1) / sk;
    if (n < 1) n = 1;
    lens[b] = len;
    pref[b + 1] = n < a.n_splits ? n : a.n_splits;
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // inclusive scan of pref[1..B], 32 lanes at a time
    const int lane = threadIdx.x;
    int carry = 0;
    for (int base = 0; base < a.B; base += 32) {
      const int i = base + lane;
      int v = i < a.B ? pref[i + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += y;
      }
      if (i < a.B) pref[i + 1] = v + carry;
      carry += __shfl_sync(FULL, v, 31);
    }
    if (lane == 0) pref[0] = 0;
  }
  __syncthreads();
}

// Rows [g0, g0 + GC) of one (split, KV head, lane): keys [k_lo, k_hi),
// then (LOCAL, the lane's last split) block-local rows [0, n_loc).
template <typename T, int D, int GC, bool LOCAL>
__device__ void split_rows(unsigned char* smem, int* pages, const DecodeArgs& a,
                           const PagedKV& kv, int b, int kh, int s, int g0, int k_lo,
                           int k_hi, int n_loc, bool direct) {
  constexpr int LPK = D / EPL;     // lanes a key
  constexpr int KPW = 32 / LPK;    // keys a warp reads at once
  constexpr int NSLOT = WARPS * KPW;
  constexpr int NC = GC >= 8 ? 2 : 4;  // keys a chunk (registers: NC x GC scores)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int slot = warp * KPW + lane / LPK;
  const int d0 = (lane % LPK) * EPL;
  const int G = a.G;
  const int ng = G - g0 < GC ? G - g0 : GC;

  float qr[GC][EPL], o[GC][EPL], m[GC], l[GC];
  const float qscale = rsqrtf((float)D) * LOG2E;  // scores in log2 units
  const T* qp = static_cast<const T*>(a.q) + ((long long)b * a.H + (long long)kh * G + g0) * D + d0;
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < ng) {
      load8(qp + g * D, qr[g]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] *= qscale;
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qr[g][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[g][e] = 0.f;
    m[g] = NEG;
    l[g] = 0.f;
  }

  const int ps = kv.page_size, bits = kv.bits;
  const int p_lo = k_lo / ps;
  if (g0 == 0) {
    // the item's page ids, clamped to the table and the pool, once for
    // every group of rows (their loads overlap q's); only entries below the
    // lane's length are read
    int np = (k_hi - k_lo + ps - 1) / ps;
    if (np > kv.max_pages - p_lo) np = kv.max_pages - p_lo;
    for (int i = tid; i < np; i += NT) {
      int phys = kv.table[p_lo + i];
      if (phys > kv.num_phys - 1) phys = kv.num_phys - 1;
      if (phys < 0) phys = 0;
      pages[i] = phys;
    }
  }
  __syncthreads();
  const Tiles tg(ps, bits, (int)sizeof(T));
  const int TR = tg.tr, RP = tg.rows_page, esz = tg.esz;
  const int tpp = RP / TR;  // tiles a page
  const int rowb = D * esz;
  const int tileb = TR * rowb;
  const int stageb = (int)stage_bytes<D>(tg);
  const int stages = ring_stages(stageb);
  const int n_tiles = bits == 4 ? ((k_hi - k_lo + ps - 1) / ps) * tpp
                                : (k_hi - k_lo + TR - 1) / TR;
  // block-local pieces after the pool tiles: LR rows of T each
  const int LR = tg.lr;
  constexpr int rowb_l = D * (int)sizeof(T);
  const int tileb_l = LR * rowb_l;
  const int n_all = LOCAL ? n_tiles + (n_loc + LR - 1) / LR : n_tiles;
  const long long head_off = (long long)kh * kv.s_head;
  const int cpr = rowb / 16;  // 16-byte pieces a row (a power of two)
  const int cpr_sh = __ffs(cpr) - 1;

  // first key (low nibble) of tile t's row 0
  auto tile_key = [&](int t) {
    const int pt = t / tpp;
    return (p_lo + pt) * ps + (t - pt * tpp) * TR;
  };

  auto fetch = [&](int t) {
    unsigned char* dst = smem + (t % stages) * stageb;
    if constexpr (LOCAL) {
      if (t >= n_tiles) {
        // rows [r0, r0 + nr) of loc[b, :, kh, :], 16-byte pieces (rows of T
        // at D >= 16 are whole pieces, 16-byte aligned); no row >= n_loc
        constexpr int CPL = rowb_l / 16;
        const int r0 = (t - n_tiles) * LR;
        const int nr = n_loc - r0 < LR ? n_loc - r0 : LR;
        const long long off = (((long long)b * a.K + r0) * kv.KH + kh) * D;
        const T* lk = static_cast<const T*>(a.loc_k) + off;
        const T* lv = static_cast<const T*>(a.loc_v) + off;
        for (int c = tid; c < 2 * nr * CPL; c += NT) {
          const int which = c >= nr * CPL;  // 0: K, 1: V
          const int rem = c - which * nr * CPL;
          const int r = rem / CPL, ch = rem % CPL;
          const char* src = reinterpret_cast<const char*>((which ? lv : lk) +
                                                          (long long)r * kv.KH * D);
          cp16(dst + which * tileb_l + r * rowb_l + ch * 16, src + ch * 16, true);
        }
        return;
      }
    }
    const int pt = t / tpp;
    const int row0 = (t - pt * tpp) * TR;
    const int kbase = (p_lo + pt) * ps + row0;
    const int lp = p_lo + pt < kv.max_pages ? p_lo + pt : kv.max_pages - 1;
    const int phys = pages[lp - p_lo];
    const long long off = ((long long)phys * kv.s_page + head_off + (long long)row0 * kv.s_tok) * esz;
    const char* kp = static_cast<const char*>(kv.k) + off;
    const char* vp = static_cast<const char*>(kv.v) + off;
    const long long tok_b = kv.s_tok * esz;
    for (int c = tid; c < 2 * TR * cpr; c += NT) {
      const int which = c >= TR * cpr;  // 0: K, 1: V
      const int rem = c - which * TR * cpr;
      const int r = rem >> cpr_sh, ch = rem & (cpr - 1);
      const bool full = kbase + r < k_hi;  // an int4 row's low key is its first
      const char* src = (which ? vp : kp) + r * tok_b + ch * 16;
      unsigned char* d = dst + which * tileb + r * rowb + ch * 16;
      if (a.a16) {
        cp16(d, src, full);
      } else {
        cp8(d, src, full);
        cp8(d + 8, src + 8, full);
      }
    }
    if (bits && tid == 0) {
      const long long si = (long long)phys * kv.KH + kh;
      cp4(dst + 2 * tileb, kv.k_scale + si);
      cp4(dst + 2 * tileb + 4, kv.v_scale + si);
    }
  };

  // one stored row of this lane's 8 elements -> KPR keys' floats
  // (FMT: 0 the pool's own T, 1 int8, 2 int4)
  auto load_row = [&](const unsigned char* p, float sc, auto fmt_tag, float (*f)[EPL]) {
    constexpr int FMT = decltype(fmt_tag)::value;
    if constexpr (FMT == 0) {
      load8(reinterpret_cast<const T*>(p), f[0]);
    } else {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      dequant8<T>(raw, FMT == 2, false, sc, f[0]);
      if constexpr (FMT == 2) dequant8<T>(raw, true, true, sc, f[1]);
    }
  };

  // One chunk of NC keys of the staged tile (tr rows of rb bytes; keys <
  // limit valid): CR rows of this slot (KPR keys a row). Every lane runs the
  // same straight-line code: a row past the tile reads the tile's last row
  // and is masked like a key past the split, so scores and shuffles of all
  // (key, row) pairs interleave.
  auto chunk = [&](const unsigned char* kt, const unsigned char* vt, float ksc, float vsc,
                   int kbase, int limit, int tr, int rb, int c, auto fmt_tag) {
    constexpr int FMT = decltype(fmt_tag)::value;
    constexpr int KPR = FMT == 2 ? 2 : 1;
    constexpr int CR = NC / KPR;  // rows a chunk
    constexpr int ESZ = FMT == 0 ? (int)sizeof(T) : 1;
    float kf[NC][EPL];
    float sc[NC][GC];
    int rows[CR];
    bool in_tile[CR];
#pragma unroll
    for (int i = 0; i < CR; ++i) {
      const int r = (c * CR + i) * NSLOT + slot;
      in_tile[i] = r < tr;
      rows[i] = r < tr ? r : tr - 1;
      load_row(kt + rows[i] * rb + d0 * ESZ, ksc, fmt_tag, &kf[i * KPR]);
    }
    // scores: lane-partial products over its 8 elements, summed over the
    // key's LPK lanes
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc = fmaf(qr[g][e], kf[j][e], acc);
        sc[j][g] = acc;
      }
    }
#pragma unroll
    for (int x = LPK / 2; x > 0; x >>= 1)
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int g = 0; g < GC; ++g) sc[j][g] += __shfl_xor_sync(FULL, sc[j][g], x);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int key = kbase + rows[j / KPR] + (j % KPR) * RP;
      const bool valid = in_tile[j / KPR] && key < limit;
#pragma unroll
      for (int g = 0; g < GC; ++g) sc[j][g] = valid ? sc[j][g] : NEG;
    }
    // online softmax of this slot's rows (f32 probabilities); rows past G
    // hold q = 0 and are never written
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int j = 1; j < NC; ++j) mx = fmaxf(mx, sc[j][g]);
      const float mn = fmaxf(m[g], mx);
      const float alpha = ex2(m[g] - mn);  // 1 while both are NEG
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float p = sc[j][g] > 0.5f * NEG ? ex2(sc[j][g] - mn) : 0.f;
        sc[j][g] = p;
        psum += p;
      }
      l[g] = l[g] * alpha + psum;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[g][e] *= alpha;
    }
    // O += P V
#pragma unroll
    for (int i = 0; i < CR; ++i) {
      float vf[KPR][EPL];
      load_row(vt + rows[i] * rb + d0 * ESZ, vsc, fmt_tag, vf);
#pragma unroll
      for (int n = 0; n < KPR; ++n)
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e) o[g][e] = fmaf(sc[i * KPR + n][g], vf[n][e], o[g][e]);
    }
  };

  // all chunks of one staged tile of tr rows (K rows, then V rows tb
  // bytes on), the format fixed for the whole tile
  auto tile = [&](const unsigned char* kt, int tb, float ksc, float vsc, int kbase,
                  int limit, int tr, int rb, auto fmt_tag) {
    constexpr int CR = NC / (decltype(fmt_tag)::value == 2 ? 2 : 1);
    for (int c = 0; c * CR * NSLOT < tr; ++c)
      chunk(kt, kt + tb, ksc, vsc, kbase, limit, tr, rb, c, fmt_tag);
  };

  // the ring: stages - 1 tiles ahead
  for (int t = 0; t < stages - 1; ++t) {
    if (t < n_all) fetch(t);
    commit();
  }
  for (int t = 0; t < n_all; ++t) {
    if (stages == 2) wait_group<0>();
    else if (stages == 3) wait_group<1>();
    else wait_group<2>();
    __syncthreads();  // tile t landed for all; tile t - 1's stage is free
    if (t + stages - 1 < n_all) fetch(t + stages - 1);
    commit();
    const unsigned char* kt = smem + (t % stages) * stageb;
    const bool pool_t = !LOCAL || t < n_tiles;
    float ksc = 1.f, vsc = 1.f;
    if (bits && pool_t) {
      ksc = reinterpret_cast<const float*>(kt + 2 * tileb)[0];
      vsc = reinterpret_cast<const float*>(kt + 2 * tileb)[1];
    }
    if (pool_t && bits == 4) {
      tile(kt, tileb, ksc, vsc, tile_key(t), k_hi, TR, rowb, std::integral_constant<int, 2>());
    } else if (pool_t && bits == 8) {
      tile(kt, tileb, ksc, vsc, tile_key(t), k_hi, TR, rowb, std::integral_constant<int, 1>());
    } else if (pool_t) {
      tile(kt, tileb, ksc, vsc, tile_key(t), k_hi, TR, rowb, std::integral_constant<int, 0>());
    } else {
      // a block-local piece: its nr rows are local keys r0.., all valid
      const int r0 = (t - n_tiles) * LR;
      const int nr = n_loc - r0 < LR ? n_loc - r0 : LR;
      tile(kt, tileb_l, 1.f, 1.f, r0, n_loc, nr, rowb_l, std::integral_constant<int, 0>());
    }
  }
  wait_group<0>();
  __syncthreads();  // the ring is idle: reuse it for the merge

  // merge the KPW key slots of a warp (lanes LPK apart)
#pragma unroll
  for (int x = LPK; x < 32; x <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= ng) continue;
      const float mo = __shfl_xor_sync(FULL, m[g], x);
      const float mn = fmaxf(m[g], mo);
      const float as = ex2(m[g] - mn), ao = ex2(mo - mn);
      l[g] = l[g] * as + __shfl_xor_sync(FULL, l[g], x) * ao;
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[g][e] = o[g][e] * as + __shfl_xor_sync(FULL, o[g][e], x) * ao;
      m[g] = mn;
    }
  }
  // then the warps, through shared memory
  float* sm_m = reinterpret_cast<float*>(smem);  // [WARPS][GC]
  float* sm_l = sm_m + WARPS * GC;               // [WARPS][GC]
  float* sm_o = sm_l + WARPS * GC;               // [WARPS][GC][D]
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g >= ng) continue;
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_o[(warp * GC + g) * D + d0 + e] = o[g][e];
      if (lane == 0) {
        sm_m[warp * GC + g] = m[g];
        sm_l[warp * GC + g] = l[g];
      }
    }
  }
  __syncthreads();
  const long long part = ((long long)b * kv.KH + kh) * a.n_splits + s;
  for (int idx = tid; idx < ng * D; idx += NT) {
    const int g = idx / D, d = idx - g * D;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w * GC + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = ex2(sm_m[w * GC + g] - M);
      L += sm_l[w * GC + g] * f;
      O += sm_o[(w * GC + g) * D + d] * f;
    }
    if (direct) {
      T* out = static_cast<T*>(a.out) + ((long long)b * a.H + (long long)kh * G + g0 + g) * D + d;
      store_out(out, L > 0.f ? O / L : 0.f);
    } else {
      const long long row = part * G + g0 + g;
      a.ws_o[row * D + d] = O;
      if (d == 0) {
        a.ws_ml[2 * row] = M;
        a.ws_ml[2 * row + 1] = L;
      }
    }
  }
  __syncthreads();  // before the next group of rows refills the ring
}

// Called by every block that wrote a split's partials of (b, kh): the one
// whose arrival completes the lane's n_live splits merges them,
// out = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s, and sets the counter
// back to 0 for the next launch. Partials are published by a fence before
// the arrival and read back through L2 (__ldcg). A warp a row: lanes
// reduce M and L over the splits, then each lane sums 4 columns of O over
// the splits (loads of 4 splits in flight).
template <typename T, int D>
__device__ void merge_if_last(const DecodeArgs& a, int b, int kh, int n_live) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  int* cnt = a.counters + (long long)b * a.kv.KH + kh;
  if (threadIdx.x == 0) last = atomicAdd(cnt, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = ((long long)b * a.kv.KH + kh) * a.n_splits * a.G;
  for (int g = warp; g < a.G; g += WARPS) {
    // split s of row g: (m, l) at ml[s * G], O at o + s * G * D
    const float2* ml = reinterpret_cast<const float2*>(a.ws_ml) + row0 + g;
    const float* o = a.ws_o + (row0 + g) * D;
    float M = NEG;
    for (int s = lane; s < n_live; s += 32) M = fmaxf(M, __ldcg(ml + (long long)s * a.G).x);
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) M = fmaxf(M, __shfl_xor_sync(FULL, M, x));
    float L = 0.f;
    for (int s = lane; s < n_live; s += 32) {
      const float2 v = __ldcg(ml + (long long)s * a.G);
      L += ex2(v.x - M) * v.y;
    }
#pragma unroll
    for (int x = 16; x > 0; x >>= 1) L += __shfl_xor_sync(FULL, L, x);
    const float inv = L > 0.f ? 1.f / L : 0.f;
    T* out = static_cast<T*>(a.out) + ((long long)b * a.H + (long long)kh * a.G + g) * D;
    for (int c = lane; c < D / 4; c += 32) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int s = 0; s < n_live; ++s) {
        const float f = ex2(__ldcg(ml + (long long)s * a.G).x - M);
        const float4 v = __ldcg(reinterpret_cast<const float4*>(o + (long long)s * a.G * D) + c);
        acc.x = fmaf(f, v.x, acc.x);
        acc.y = fmaf(f, v.y, acc.y);
        acc.z = fmaf(f, v.z, acc.z);
        acc.w = fmaf(f, v.w, acc.w);
      }
      store_out(out + 4 * c, acc.x * inv);
      store_out(out + 4 * c + 1, acc.y * inv);
      store_out(out + 4 * c + 2, acc.z * inv);
      store_out(out + 4 * c + 3, acc.w * inv);
    }
  }
  if (threadIdx.x == 0) *cnt = 0;
}

// The block's share of the live (lane, KV head, split) items: item i is
// split i / KH - pref[b] of lane b (pref[b] <= i / KH < pref[b + 1]) and
// KV head i % KH. Dead splits are never listed, so a short lane costs no
// block. Under LOCAL the last split of each lane also takes its block-local
// rows (n_loc of them, the same for every lane).
template <typename T, int D, int GC, bool LOCAL>
__device__ void decode_items(unsigned char* smem, const DecodeArgs& a) {
  int* pages = reinterpret_cast<int*>(smem + ring_bytes<T, D, GC>(a.kv.page_size, a.kv.bits));
  int* lens = pages + a.split_pages;
  int* pref = lens + a.B;
  int n_loc = 0;
  if constexpr (LOCAL) {
    n_loc = a.step_idx[0] + 1;  // local rows 0..step_idx
    if (n_loc > a.K) n_loc = a.K;
    if (n_loc < 0) n_loc = 0;
  }
  live_prefix<LOCAL>(a, lens, pref);
  const int KH = a.kv.KH, ps = a.kv.page_size;
  const int sk = a.split_pages * ps;
  const int n_items = pref[a.B] * KH;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int pair = item / KH, kh = item - pair * KH;
    int lo = 0, hi = a.B - 1;  // the last lane with pref[lane] <= pair
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (pref[mid] <= pair) lo = mid;
      else hi = mid - 1;
    }
    const int b = lo, s = pair - pref[b], len = lens[b];
    const int n_live = pref[b + 1] - pref[b];
    int k_lo, k_hi;
    if (len <= a.n_splits * sk) {
      // the lane's pages spread evenly over its live splits (each at most
      // split_pages pages), so its items take about the same time
      const int np = (len + ps - 1) / ps;
      k_lo = (int)((long long)s * np / n_live) * ps;
      k_hi = s == n_live - 1 ? len : (int)((long long)(s + 1) * np / n_live) * ps;
    } else {
      // keys past the table: fixed runs, the last split takes the rest
      // (their pages clamp)
      k_lo = s * sk;
      k_hi = s == a.n_splits - 1 ? len : k_lo + sk;
    }
    PagedKV kv = a.kv;
    kv.table = a.tables + (long long)b * kv.max_pages;
    const bool direct = n_live == 1;
    const int nl = LOCAL && s == n_live - 1 ? n_loc : 0;
    for (int g0 = 0; g0 < a.G; g0 += GC)
      split_rows<T, D, GC, LOCAL>(smem, pages, a, kv, b, kh, s, g0, k_lo, k_hi, nl, direct);
    if (!direct) merge_if_last<T, D>(a, b, kh, n_live);
  }
}

// at most 128 registers a thread at 3 rows (four blocks an SM where the
// ring's shared memory allows: more warps to hide each one's latency); 8
// rows keep their registers
template <typename T, int D, int GC, bool LOCAL>
__global__ void __launch_bounds__(NT, GC >= 8 ? 1 : 4) decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  decode_items<T, D, GC, LOCAL>(smem_raw, a);
}

template <typename T, int D, int GC, bool LOCAL>
int launch_rows(const DecodeArgs& a, int num_sms, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D, GC>(a);
  cudaError_t e = allow_smem(decode_kernel<T, D, GC, LOCAL>, smem);
  if (e != cudaSuccess) return (int)e;
  // as many blocks as fit the card at once, none idle from the start
  static size_t occ_smem = 0;
  static int occ = 0;
  if (occ_smem != smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, decode_kernel<T, D, GC, LOCAL>,
                                                      NT, smem);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    occ_smem = smem;
  }
  const long long items = (long long)a.B * a.kv.KH * a.n_splits;
  const int grid = (int)(items < (long long)occ * num_sms ? items : (long long)occ * num_sms);
  decode_kernel<T, D, GC, LOCAL><<<grid, NT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// two row counts live in registers: GC = 3 (Llama-3.2-3B's G, the served
// and timed one; G = 1, 2 leave rows idle) and GC = 8 (G = 4..8 in one
// group; more loop over groups of 8). Each GC is 6 more instantiations
// (dtype x D) a kernel to build.
template <typename T, int D, bool LOCAL>
int launch(const DecodeArgs& a, int num_sms, cudaStream_t stream) {
  if (a.G <= 3) return launch_rows<T, D, 3, LOCAL>(a, num_sms, stream);
  return launch_rows<T, D, 8, LOCAL>(a, num_sms, stream);
}

// The checks both C entries make of a call's shapes and split plan.
inline bool plan_ok(int B, int H, int KH, int page_size, int kv_bits, int max_pages,
                    int n_splits, int split_pages, const float* ws_o, const float* ws_ml,
                    const int* counters, int num_sms) {
  return KH > 0 && H % KH == 0 && page_size_ok(page_size, kv_bits) && n_splits >= 1 &&
         split_pages >= 1 && (long long)n_splits * split_pages >= max_pages &&
         (long long)(n_splits - 1) * split_pages < max_pages && num_sms >= 1 &&
         (n_splits == 1 || (ws_o != nullptr && ws_ml != nullptr && counters != nullptr));
}

}  // namespace fd
}  // namespace dyn
