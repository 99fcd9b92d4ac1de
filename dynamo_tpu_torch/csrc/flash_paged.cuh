// Flash attention over one sequence's paged KV on the CUDA cores (the FMA
// body): what f32 prefill and f32 ragged attention run
// (prefill_attention.cu, ragged_attention.cu), and the pool layout, dequant
// formula, constants and C-interface helpers every kernel shares.
//
// One thread block serves ONE KV head and a tile of up to TQ_TILE
// consecutive query tokens of one sequence, i.e. R = n_tok * G query rows
// (G = query heads per KV head; any G, no power of two assumed). It walks
// the sequence's real pages in order, reading its own page-table entries,
// stages one K tile and one V tile (<= KT_MAX keys, never straddling a
// page) in shared memory with 16-byte loads, and keeps the online-softmax
// state (running max m, running sum l, un-normalised output O) in f32 in
// shared memory. Products are plain FMA with f32 accumulation; wgmma/TMA,
// split-KV and double buffering are left to a later change.
//
// Contract shared with the reference TPU kernels: softmax state in f32,
// masked scores are NEG = -1e30, physical page ids are clamped to the
// pool, query token t (0-based in the tile) sees keys
// [0, min(kv_base + t + 1, kv_total)), scale = 1/sqrt(D) is applied to q.
// A row that sees no key returns zeros (finite).
//
// Quantized pools (int8, or int4 two keys to a byte) are dequantized where
// a tile is staged: float(q) * scale[phys, kh], rounded to T, written into
// the same shared-memory tile a full-precision pool fills; everything after
// staging is format-blind. The format is a run-time argument (uniform over
// the block), so each (T, D) is instantiated once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dyn {

constexpr float NEG = -1e30f;
constexpr int NT = 128;      // threads per block
constexpr int KT_MAX = 64;   // keys per shared-memory tile
constexpr int TQ_TILE = 16;  // query tokens per block (prefill / ragged)

// 16-byte vectors: elements per vector
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec<float> { static constexpr int N = 4; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// one 16-byte shared-memory load -> Vec<T>::N floats
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  float4 raw = *reinterpret_cast<const float4*>(p);
  out[0] = raw.x; out[1] = raw.y; out[2] = raw.z; out[3] = raw.w;
}

// four consecutive elements -> floats (8-byte load for bf16, 16 for f32)
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float2 a = __bfloat1622float2(h[0]);
  float2 b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void load4(const float* p, float* out) {
  float4 raw = *reinterpret_cast<const float4*>(p);
  out[0] = raw.x; out[1] = raw.y; out[2] = raw.z; out[3] = raw.w;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Where one sequence's KV lives: one layer's K and V pools and the
// sequence's page-table row. Full precision (bits 0): pools of T in the
// public layout [num_phys, page_size, KH, D]. Quantized (bits 8 or 4):
// int8 pools [num_phys, rows, KH, D] with rows = page_size (int8) or
// page_size / 2 (int4: key o and key o + page_size/2 share a byte, low
// nibble first) plus f32 scales [num_phys, KH] per pool. Strides are in
// elements of the pool's own type (bytes when quantized), D contiguous.
struct PagedKV {
  const void* k;
  const void* v;
  const float* k_scale;  // null when bits == 0
  const float* v_scale;
  const int* table;  // [max_pages] logical page -> physical page
  int max_pages;
  int num_phys;
  int page_size;  // tokens per page (logical)
  int bits;       // 0, 8 or 4
  int KH;
  long long s_page, s_tok, s_head;
};

// dynamic shared memory a block needs for R query rows
template <typename T, int D>
__host__ __device__ inline size_t flash_smem_bytes(int R) {
  size_t nfl = (size_t)2 * R * D + (size_t)R * KT_MAX + (size_t)3 * R;
  nfl = (nfl + 3) & ~(size_t)3;
  return nfl * sizeof(float) + (size_t)2 * KT_MAX * (D + Vec<T>::N) * sizeof(T);
}

// VN (= Vec<T>::N) float values -> one 16-byte vector of T in shared memory
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

// VN consecutive int8 bytes (VN-byte aligned) -> raw bytes
template <int VN> struct Bytes;
template <> struct Bytes<8> {
  __device__ static void load(const int8_t* p, int8_t* b) {
    *reinterpret_cast<uint2*>(b) = *reinterpret_cast<const uint2*>(p);
  }
};
template <> struct Bytes<4> {
  __device__ static void load(const int8_t* p, int8_t* b) {
    *reinterpret_cast<uint32_t*>(b) = *reinterpret_cast<const uint32_t*>(p);
  }
};

// Dequantize VN stored values of one key row: float(int) * scale, rounded
// to T by store_vec — the formula of the reference's gather_dequant and
// _window_dequant. int4: the high nibble when `high`, else the low one,
// both sign-extended through a signed 8-bit value.
template <typename T>
__device__ __forceinline__ void dequant_vec(const int8_t* src, int bits, bool high,
                                            float scale, T* dst) {
  constexpr int VN = Vec<T>::N;
  alignas(8) int8_t b[VN];
  Bytes<VN>::load(src, b);
  float f[VN];
#pragma unroll
  for (int i = 0; i < VN; ++i) {
    int val;
    if (bits == 8) val = b[i];
    else if (high) val = b[i] >> 4;
    else val = (int8_t)((uint8_t)b[i] << 4) >> 4;
    f[i] = (float)val * scale;
  }
  store_vec(dst, f);
}

// Online-softmax state of one block's R query rows in shared memory.
template <typename T, int D>
struct Flash {
  static constexpr int VN = Vec<T>::N;
  static constexpr int KS = D + VN;   // padded tile row: consecutive keys land
                                      // on distinct banks for 16-byte loads
  static constexpr int CPR = D / VN;  // 16-byte chunks per key row
  int R, G;
  float* qs;  // [R][D] scaled q
  float* O;   // [R][D] un-normalised output
  float* S;   // [R][KT_MAX] scores / probs
  float *m_s, *l_s, *a_s;  // [R]
  T* ks;  // [KT_MAX][KS]
  T* vs;

  __device__ Flash(unsigned char* smem_raw, int n_tok, int G_) : R(n_tok * G_), G(G_) {
    qs = reinterpret_cast<float*>(smem_raw);
    O = qs + R * D;
    S = O + R * D;
    m_s = S + R * KT_MAX;
    l_s = m_s + R;
    a_s = l_s + R;
    size_t nfl = (size_t)2 * R * D + (size_t)R * KT_MAX + (size_t)3 * R;
    nfl = (nfl + 3) & ~(size_t)3;
    ks = reinterpret_cast<T*>(qs + nfl);
    vs = ks + KT_MAX * KS;
  }

  // q0 points at the tile's first token and the KV head's first query head
  // ([.., H, D] layout: token stride `tok_stride`, head stride D)
  __device__ void init(const T* __restrict__ q0, long long tok_stride) {
    const float scale = rsqrtf((float)D);
    for (int idx = threadIdx.x; idx < R * D; idx += NT) {
      int r = idx / D, d = idx - r * D;
      int t = r / G, g = r - t * G;
      qs[idx] = to_float(q0[t * tok_stride + g * D + d]) * scale;
      O[idx] = 0.f;
    }
    for (int r = threadIdx.x; r < R; r += NT) {
      m_s[r] = NEG;
      l_s[r] = 0.f;
    }
    __syncthreads();
  }

  // Stage keys [key0, key0 + kt) of one page of `kv` (kt keys, never
  // across a page) into ks/vs; keys at or past `limit` become zeros.
  __device__ void stage_pool(const PagedKV& kv, int kh, int key0, int kt, int limit) {
    int lp = key0 / kv.page_size;
    const int off = key0 - lp * kv.page_size;
    if (lp > kv.max_pages - 1) lp = kv.max_pages - 1;
    int phys = kv.table[lp];
    if (phys > kv.num_phys - 1) phys = kv.num_phys - 1;
    if (phys < 0) phys = 0;
    const long long head_off = (long long)kh * kv.s_head;
    if (kv.bits == 0) {
      const T* kp = static_cast<const T*>(kv.k);
      const T* vp = static_cast<const T*>(kv.v);
      const long long base = (long long)phys * kv.s_page + (long long)off * kv.s_tok + head_off;
      for (int c = threadIdx.x; c < kt * CPR; c += NT) {
        int j = c / CPR, dc = (c - j * CPR) * VN;
        uint4 kraw = make_uint4(0u, 0u, 0u, 0u), vraw = kraw;
        if (key0 + j < limit) {
          long long src = base + (long long)j * kv.s_tok + dc;
          kraw = *reinterpret_cast<const uint4*>(kp + src);
          vraw = *reinterpret_cast<const uint4*>(vp + src);
        }
        *reinterpret_cast<uint4*>(ks + j * KS + dc) = kraw;
        *reinterpret_cast<uint4*>(vs + j * KS + dc) = vraw;
      }
    } else {
      const int8_t* kp = static_cast<const int8_t*>(kv.k);
      const int8_t* vp = static_cast<const int8_t*>(kv.v);
      const float k_sc = kv.k_scale[(long long)phys * kv.KH + kh];
      const float v_sc = kv.v_scale[(long long)phys * kv.KH + kh];
      const int half = kv.page_size / 2;
      const long long base = (long long)phys * kv.s_page + head_off;
      for (int c = threadIdx.x; c < kt * CPR; c += NT) {
        int j = c / CPR, dc = (c - j * CPR) * VN;
        if (key0 + j < limit) {
          int key = off + j;  // key within the page
          bool high = kv.bits == 4 && key >= half;
          int row = high ? key - half : key;
          long long src = base + (long long)row * kv.s_tok + dc;
          dequant_vec<T>(kp + src, kv.bits, high, k_sc, ks + j * KS + dc);
          dequant_vec<T>(vp + src, kv.bits, high, v_sc, vs + j * KS + dc);
        } else {
          *reinterpret_cast<uint4*>(ks + j * KS + dc) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vs + j * KS + dc) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    __syncthreads();
  }

  // One online-softmax step over the kt staged keys (kt a multiple of 4).
  // Staged key j is key key0 + j; query token t sees keys
  // < min(kv_base + t + 1, kv_total).
  __device__ void update(int kt, int key0, int kv_base, int kv_total) {
    const int tid = threadIdx.x;
    // scores: S[r][j] = q_r . k_j, masked per row
    for (int idx = tid; idx < R * kt; idx += NT) {
      int r = idx / kt, j = idx - r * kt;
      const float* qr = qs + r * D;
      const T* kj = ks + j * KS;
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += VN) {
        float kf[VN], qf[VN];
        load_vec(kj + d, kf);
#pragma unroll
        for (int i = 0; i < VN; i += 4) load4(qr + d + i, qf + i);
#pragma unroll
        for (int i = 0; i < VN; ++i) acc = fmaf(qf[i], kf[i], acc);
      }
      int t = r / G;
      int kvlen = kv_base + t + 1;
      if (kvlen > kv_total) kvlen = kv_total;
      S[r * KT_MAX + j] = (key0 + j < kvlen) ? acc : NEG;
    }
    __syncthreads();

    // online softmax, one warp per row
    for (int r = tid >> 5; r < R; r += NT / 32) {
      const int lane = tid & 31;
      float s0 = lane < kt ? S[r * KT_MAX + lane] : NEG;
      float s1 = lane + 32 < kt ? S[r * KT_MAX + lane + 32] : NEG;
      float m_old = m_s[r];
      float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      float p0 = s0 > 0.5f * NEG ? __expf(s0 - m_new) : 0.f;
      float p1 = s1 > 0.5f * NEG ? __expf(s1 - m_new) : 0.f;
      if (lane < kt) S[r * KT_MAX + lane] = p0;
      if (lane + 32 < kt) S[r * KT_MAX + lane + 32] = p1;
      float psum = warp_sum(p0 + p1);
      if (lane == 0) {
        float alpha = __expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O[r][d0..d0+3] = O * alpha + P[r][:] @ V[:, d0..d0+3]
    for (int idx = tid; idx < R * (D / 4); idx += NT) {
      int r = idx / (D / 4), d0 = (idx - r * (D / 4)) * 4;
      const float* prob = S + r * KT_MAX;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int j = 0; j < kt; j += 4) {
        float4 p = *reinterpret_cast<const float4*>(prob + j);
        float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float vf[4];
          load4(vs + (j + jj) * KS + d0, vf);
          a0 = fmaf(pv[jj], vf[0], a0);
          a1 = fmaf(pv[jj], vf[1], a1);
          a2 = fmaf(pv[jj], vf[2], a2);
          a3 = fmaf(pv[jj], vf[3], a3);
        }
      }
      float al = a_s[r];
      float* o = O + r * D + d0;
      o[0] = o[0] * al + a0;
      o[1] = o[1] * al + a1;
      o[2] = o[2] * al + a2;
      o[3] = o[3] * al + a3;
    }
    __syncthreads();
  }

  // Walk the sequence's pages: keys < min(kv_base + n_tok, kv_total) (the
  // tile's last token bounds what any row can see: causal early exit).
  __device__ void pool(const PagedKV& kv, int kh, int n_tok, int kv_base, int kv_total) {
    const int kt = kv.page_size < KT_MAX ? kv.page_size : KT_MAX;
    int limit = kv_base + n_tok;
    if (limit > kv_total) limit = kv_total;
    const int n_tiles = limit > 0 ? (limit + kt - 1) / kt : 0;
    for (int ti = 0; ti < n_tiles; ++ti) {
      stage_pool(kv, kh, ti * kt, kt, limit);
      update(kt, ti * kt, kv_base, kv_total);
    }
  }

  // out0 as q0 in init(); a row that saw no key returns zeros
  __device__ void finalize(T* __restrict__ out0, long long tok_stride) {
    for (int idx = threadIdx.x; idx < R * D; idx += NT) {
      int r = idx / D, d = idx - r * D;
      int t = r / G, g = r - t * G;
      float l = l_s[r];
      float inv = l > 0.f ? 1.f / l : 0.f;
      store_out(out0 + t * tok_stride + g * D + d, O[idx] * inv);
    }
  }
};

// Flash attention of one tile of n_tok query tokens over one sequence's
// pages (the three paged kernels' shared body).
template <typename T, int D>
__device__ void flash_tile(unsigned char* smem_raw, const T* __restrict__ q0,
                           T* __restrict__ out0, long long tok_stride, int n_tok,
                           int G, int kv_base, int kv_total, const PagedKV& kv,
                           int kh) {
  Flash<T, D> f(smem_raw, n_tok, G);
  f.init(q0, tok_stride);
  f.pool(kv, kh, n_tok, kv_base, kv_total);
  f.finalize(out0, tok_stride);
}

// Host side: raise a kernel's dynamic shared-memory limit when it needs
// more than the 48 KB default, then report whether it fits the card.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// dtype codes of the C interface
constexpr int DT_BF16 = 0;
constexpr int DT_F32 = 1;
// own error codes (negative, so they never collide with cudaError_t)
constexpr int ERR_UNSUPPORTED = -1;  // dtype / head_dim / page_size / format not built

inline bool page_size_ok(int page_size, int bits) {
  // tiles never straddle a page and the PV loop reads 4 keys at a time
  if (page_size <= 0 || page_size % 4 != 0) return false;
  if (bits != 0 && bits != 8 && bits != 4) return false;
  // int4: a 64-key tile never straddles the nibble boundary either
  if (bits == 4) return page_size <= KT_MAX || (page_size / 2) % KT_MAX == 0;
  return page_size <= KT_MAX || page_size % KT_MAX == 0;
}

// Build a PagedKV from the C interface's arguments (table set per block).
inline PagedKV make_kv(const void* kv_k, const void* kv_v, const float* k_scale,
                       const float* v_scale, int kv_bits, int max_pages,
                       int num_phys, int page_size, int KH, long long s_page,
                       long long s_tok, long long s_head) {
  return PagedKV{kv_k, kv_v, k_scale, v_scale, nullptr, max_pages, num_phys,
                 page_size, kv_bits, KH, s_page, s_tok, s_head};
}

}  // namespace dyn

// Dispatch a templated launcher on (dtype, head_dim). LAUNCH(T, D) must be
// an expression returning int.
#define DYN_DISPATCH(dtype, D, LAUNCH)                                   \
  do {                                                                   \
    if ((dtype) == dyn::DT_BF16) {                                       \
      if ((D) == 128) return LAUNCH(__nv_bfloat16, 128);                 \
      if ((D) == 64) return LAUNCH(__nv_bfloat16, 64);                   \
      if ((D) == 16) return LAUNCH(__nv_bfloat16, 16);                   \
    } else if ((dtype) == dyn::DT_F32) {                                 \
      if ((D) == 128) return LAUNCH(float, 128);                         \
      if ((D) == 64) return LAUNCH(float, 64);                           \
      if ((D) == 16) return LAUNCH(float, 16);                           \
    }                                                                    \
    return dyn::ERR_UNSUPPORTED;                                         \
  } while (0)
