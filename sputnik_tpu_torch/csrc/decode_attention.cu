// Decode attention: qlen <= 8 query rows per replica against the KV blocks
// its block table names, online softmax across the table's slots; over a
// per-replica block cache (B19) or over a shared page pool (B20a).
//
// Replaces the TPU kernels
// sputnik_tpu/ops/pallas/decode_attention.py:decode_attention_kernel and
// sputnik_tpu/ops/pallas/paged_attention.py:paged_attention_kernel. The two
// compute the same attention and differ only in where a table slot's keys
// live, so one kernel body serves both, templated on an address policy
// (ContigAddr, PagedAddr below); the contiguous one is described first.
// q is f32 [R, qlen, hd] (unscaled; the kernel multiplies by `scale`), the
// caches k / v are [R_kv, s_max, hd] in f32, bf16 or int8 with per-token
// dequant scales k_scale / v_scale f32 [R_kv, s_max] (ones for fp caches),
// tbl / valid are i32 [R, S] per QUERY replica, kv_len i32 [R_kv]. Query
// replica r reads KV replica r / group (GQA). Query row `row` sits at cache
// position kv_len[r / group] - qlen + row and sees keys at or before it.
//
// Semantics, slot by slot as the TPU kernel runs them: a slot with
// valid == 0 (or a block id outside [0, s_max / bk)) is skipped; otherwise the block's scores for every row are
// formed first (fp: (q*scale) . k * k_scale in f32 on the upcast cache;
// int8: q quantised per row to int8, int8 x int8 -> int32 by __dp4a, times
// q_scale * k_scale), masked causally with the finite -1e30 sentinel; then
// per row the block max, p = exp(sc - m_new) (0 where sc <= -5e29), the
// running denominator l and the correction exp(m_prev - m_new); then
// acc = acc * corr + (p * v_scale) @ v (fp) or, for int8, p * v_scale
// quantised per row over the whole bk block to 0..127 (rintf, half to
// even), int32 products with the int8 values, times that block's scale.
// The output is acc / max(l, 1e-30): a replica with no valid slot gives
// exactly 0, never NaN. The int8 p scale is per bk block, so the block's
// scores are held whole in shared memory (qlen x bk floats, 32 KiB at
// qlen = 8, bk = 1024): bk <= 1024, hd <= 128.
//
// What bounds it on an H100: bytes. A decode step reads each tabled KV
// block once (2 * bk * hd * itemsize bytes) for a few FLOPs per byte; the
// speed of light is the attended KV bytes over 3.35 TB/s.
//
// The simple design: one block of 8 warps per query replica. A lane owns
// four consecutive head-dim elements, so a warp reads a whole key (or
// value) row in one coalesced access; the warps split a block's keys, eight
// consecutive keys per warp per step, loaded before they are used so that
// eight rows are in flight per warp. Scores are reduced across the warp
// with shuffles; row statistics run one warp per row; each warp keeps its
// own partial acc for its keys in registers, rescaled by corr at every
// slot (the rescale is linear, so the warps' partials are summed once, at
// the end, through shared memory). Keys past kv_len - 1 are masked for
// every row and contribute nothing: they are neither loaded nor summed.
// Split-KV across blocks, one read of K/V per GQA group and TMA are later
// work.
//
// Paged (B20a): k / v are a page pool [P_alloc, bk, hd] with scales
// f32 [P_alloc, bk], shared by every replica; per query replica the table
// gives for each slot a PHYSICAL page id `phys` (the rows it reads,
// page * bk .. page * bk + bk - 1 of the pool) and a LOGICAL block id
// (the keys' positions, logical * bk + j, for the causal mask). A page id
// outside [0, P_alloc) is a skipped slot. Everything else, the bound
// included, is as above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace stt_decode {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QMAX = 8;        // query rows (speculative verification)
constexpr int HD_MAX = 128;    // four head-dim elements per lane
constexpr int UNROLL = 8;      // keys in flight per warp
constexpr float NEG_LARGE = -1e30f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Elements d0 .. d0 + 3 of a row as floats, 0 past hd. `vec`: hd % 4 == 0
// and the base pointer is 16-byte aligned, so one vector load serves.
__device__ __forceinline__ void load4(const float* p, int d0, int hd,
                                      bool vec, float o[4]) {
  if (vec) {
    if (d0 < hd) {
      const float4 x = *reinterpret_cast<const float4*>(p + d0);
      o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
    } else {
      o[0] = o[1] = o[2] = o[3] = 0.f;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = d0 + i < hd ? p[d0 + i] : 0.f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int d0, int hd,
                                      bool vec, float o[4]) {
  if (vec) {
    if (d0 < hd) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p + d0);
      const float2 a =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 b =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
    } else {
      o[0] = o[1] = o[2] = o[3] = 0.f;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    o[i] = d0 + i < hd ? __bfloat162float(p[d0 + i]) : 0.f;
}

// Four int8 elements packed little-endian into one word (0 past hd).
__device__ __forceinline__ int load4i(const int8_t* p, int d0, int hd,
                                      bool vec) {
  if (vec) return d0 < hd ? *reinterpret_cast<const int*>(p + d0) : 0;
  int w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (d0 + i < hd) w |= (int)(uint8_t)p[d0 + i] << (8 * i);
  return w;
}

__device__ __forceinline__ int byte_at(int w, int i) {
  return (int)(int8_t)((w >> (8 * i)) & 0xff);
}

// Where table slot `i` (= r * S + s) of KV replica rk reads: the position of
// its first key (key0) and the row of that key in k / v and in the scales
// (base). False: the slot is skipped.
struct ContigAddr {  // B19: tbl holds block ids of the replica's own cache
  const int* tbl;
  int s_max;
  __device__ __forceinline__ bool resolve(int i, int rk, int bk, int& key0,
                                          size_t& base) const {
    const int blk = tbl[i];
    if (blk < 0 || blk >= s_max / bk) return false;
    key0 = blk * bk;
    base = (size_t)rk * s_max + key0;
    return true;
  }
};

struct PagedAddr {  // B20a: physical page for the rows, logical for positions
  const int* phys;
  const int* logical;
  int n_pages;  // P_alloc
  __device__ __forceinline__ bool resolve(int i, int, int bk, int& key0,
                                          size_t& base) const {
    const int page = phys[i];
    if (page < 0 || page >= n_pages) return false;
    key0 = logical[i] * bk;
    base = (size_t)page * bk;
    return true;
  }
};

template <typename T, bool INT8, typename Addr>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(Addr addr, const int* __restrict__ valid,
                        const int* __restrict__ kv_len,
                        const float* __restrict__ q,
                        const T* __restrict__ kc, const T* __restrict__ vc,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        float* __restrict__ out, int S, int bk, int qlen,
                        int group, int hd, float scale, int vec_i) {
  // scores / probabilities [qlen][bk], reused at the end for the warps'
  // partial outputs [WARPS][qlen][HD_MAX]
  extern __shared__ __align__(16) float smem[];
  __shared__ float m_s[QMAX], l_s[QMAX], corr_s[QMAX], ps_s[QMAX];

  const bool vec = vec_i != 0;
  const int r = blockIdx.x, rk = r / group;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = lane * 4;
  const int len = kv_len[rk];
  const int qpos0 = len - qlen;  // row `row` sits at qpos0 + row

  float qf[QMAX][4];
  int qw[QMAX];
  float qsc[QMAX];
#pragma unroll
  for (int row = 0; row < QMAX; ++row) {
    qw[row] = 0;
    qsc[row] = 0.f;
    if (row < qlen) {
      load4(q + ((size_t)r * qlen + row) * hd, d0, hd, vec, qf[row]);
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[row][i] *= scale;
      if (INT8) {  // per-row symmetric int8, as the TPU kernel's q tile
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) a = fmaxf(a, fabsf(qf[row][i]));
        qsc[row] = fmaxf(warp_max(a), 1e-30f) / 127.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float t = fminf(fmaxf(rintf(qf[row][i] / qsc[row]), -127.f),
                                127.f);
          qw[row] |= ((int)t & 0xff) << (8 * i);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qf[row][i] = 0.f;
    }
  }
  if (threadIdx.x < QMAX) {
    m_s[threadIdx.x] = NEG_LARGE;
    l_s[threadIdx.x] = 0.f;
  }

  float acc[QMAX][4];
#pragma unroll
  for (int row = 0; row < QMAX; ++row)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[row][i] = 0.f;
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    int key0;
    size_t base;
    // an out-of-range block or page id counts as an invalid slot, never a
    // read
    if (valid[r * S + s] != 1 || !addr.resolve(r * S + s, rk, bk, key0, base))
      continue;
    // keys past len - 1 are masked for every row: skipping them is exact
    const int kend = min(bk, len - key0);
    if (kend <= 0) continue;  // the slot's update is the identity

    // -- scores of the block, every row
    for (int j0 = warp * UNROLL; j0 < kend; j0 += WARPS * UNROLL) {
      float kf[UNROLL][4];
      int kw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u;
        if constexpr (INT8) {
          kw[u] = j < kend ? load4i(reinterpret_cast<const int8_t*>(kc) +
                                        (base + j) * hd, d0, hd, vec)
                           : 0;
        } else if (j < kend) {
          load4(kc + (base + j) * hd, d0, hd, vec, kf[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u;
        if (j >= kend) break;
        const float ks = k_scale[base + j];
#pragma unroll
        for (int row = 0; row < QMAX; ++row) {
          if (row >= qlen) break;
          float sc;
          if constexpr (INT8) {
            sc = (float)warp_sum(__dp4a(qw[row], kw[u], 0)) * qsc[row] * ks;
          } else {
            float part = 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) part = fmaf(qf[row][i], kf[u][i], part);
            sc = warp_sum(part) * ks;
          }
          if (lane == 0)
            smem[row * bk + j] = key0 + j <= qpos0 + row ? sc : NEG_LARGE;
        }
      }
    }
    __syncthreads();

    // -- row statistics and p, one warp per row
    if (warp < qlen) {
      const int row = warp;
      float* prow = smem + row * bk;
      float mb = NEG_LARGE;
      for (int j = lane; j < kend; j += 32) mb = fmaxf(mb, prow[j]);
      const float m_prev = m_s[row];
      const float m_new = fmaxf(m_prev, warp_max(mb));
      float sum = 0.f, pmax = 0.f;
      for (int j = lane; j < kend; j += 32) {
        const float sc = prow[j];
        const float p = sc <= NEG_LARGE / 2 ? 0.f : expf(sc - m_new);
        sum += p;
        const float pv = p * v_scale[base + j];
        prow[j] = pv;
        pmax = fmaxf(pmax, pv);
      }
      sum = warp_sum(sum);
      float ps = 1.f;
      if (INT8) {
        ps = fmaxf(warp_max(pmax), 1e-30f) / 127.f;
        for (int j = lane; j < kend; j += 32)
          prow[j] = fminf(fmaxf(rintf(prow[j] / ps), 0.f), 127.f);
      }
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[row] = l_s[row] * corr + sum;
        m_s[row] = m_new;
        corr_s[row] = corr;
        ps_s[row] = ps;
      }
    }
    __syncthreads();

    // -- acc = acc * corr + p @ v over this warp's keys
    float part[QMAX][4];
    int ipart[QMAX][4];
#pragma unroll
    for (int row = 0; row < QMAX; ++row)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        part[row][i] = 0.f;
        ipart[row][i] = 0;
      }
    for (int j0 = warp * UNROLL; j0 < kend; j0 += WARPS * UNROLL) {
      float vf[UNROLL][4];
      int vw[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u;
        if constexpr (INT8) {
          vw[u] = j < kend ? load4i(reinterpret_cast<const int8_t*>(vc) +
                                        (base + j) * hd, d0, hd, vec)
                           : 0;
        } else if (j < kend) {
          load4(vc + (base + j) * hd, d0, hd, vec, vf[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u;
        if (j >= kend) break;
#pragma unroll
        for (int row = 0; row < QMAX; ++row) {
          if (row >= qlen) break;
          const float p = smem[row * bk + j];
          if constexpr (INT8) {
            const int pi = (int)p;
#pragma unroll
            for (int i = 0; i < 4; ++i) ipart[row][i] += pi * byte_at(vw[u], i);
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i) part[row][i] = fmaf(p, vf[u][i], part[row][i]);
          }
        }
      }
    }
#pragma unroll
    for (int row = 0; row < QMAX; ++row) {
      if (row >= qlen) break;
      const float corr = corr_s[row];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[row][i] = INT8 ? acc[row][i] * corr + (float)ipart[row][i] * ps_s[row]
                           : acc[row][i] * corr + part[row][i];
    }
    __syncthreads();
  }

  // -- sum the warps' partial outputs, divide by the denominator
#pragma unroll
  for (int row = 0; row < QMAX; ++row) {
    if (row >= qlen) break;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      smem[(warp * qlen + row) * HD_MAX + d0 + i] = acc[row][i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < qlen * hd; e += THREADS) {
    const int row = e / hd, d = e % hd;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += smem[(w * qlen + row) * HD_MAX + d];
    out[((size_t)r * qlen + row) * hd + d] = sum / fmaxf(l_s[row], 1e-30f);
  }
}

template <typename T, bool INT8, typename Addr>
int launch(Addr addr, const void* valid, const void* kv_len, const void* q,
           const void* k, const void* v, const void* ks, const void* vs,
           void* out, int R, int S, int bk, int qlen, int group, int hd,
           float scale, int vec, cudaStream_t stream) {
  const int floats = std::max(qlen * bk, WARPS * qlen * HD_MAX);
  decode_attention_kernel<T, INT8, Addr>
      <<<R, THREADS, floats * sizeof(float), stream>>>(
          addr, (const int*)valid, (const int*)kv_len, (const float*)q,
          (const T*)k, (const T*)v, (const float*)ks, (const float*)vs,
          (float*)out, S, bk, qlen, group, hd, scale, vec);
  return (int)cudaGetLastError();
}

template <typename Addr>
int dispatch(Addr addr, const void* valid, const void* kv_len, const void* q,
             const void* k, const void* v, const void* ks, const void* vs,
             void* out, int R, int S, int bk, int qlen, int group, int hd,
             int dtype, int vec, float scale, void* stream) {
  if (qlen < 1 || qlen > QMAX || hd < 1 || hd > HD_MAX || bk < 1 ||
      bk > 1024)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define STT_DEC_ARGS                                                         \
  addr, valid, kv_len, q, k, v, ks, vs, out, R, S, bk, qlen, group, hd, scale, \
      vec, st
  if (dtype == 0) return launch<float, false>(STT_DEC_ARGS);
  if (dtype == 1) return launch<__nv_bfloat16, false>(STT_DEC_ARGS);
  if (dtype == 2) return launch<int8_t, true>(STT_DEC_ARGS);
#undef STT_DEC_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace stt_decode

// dtype: 0 f32, 1 bf16, 2 int8 (the cache's). q f32 [R, qlen, hd],
// k / v [R_kv, s_max, hd], scales f32 [R_kv, s_max], tbl / valid i32 [R, S],
// kv_len i32 [R_kv], out f32 [R, qlen, hd]. qlen <= 8, hd <= 128,
// bk <= 1024 (the wrapper checks). vec: hd % 4 == 0 and q / k / v 16-byte
// aligned.
extern "C" int decode_attention(const void* tbl, const void* valid,
                                const void* kv_len, const void* q,
                                const void* k, const void* v, const void* ks,
                                const void* vs, void* out, int R, int S,
                                int bk, int qlen, int group, int hd,
                                int s_max, int dtype, int vec, float scale,
                                void* stream) {
  using namespace stt_decode;
  return dispatch(ContigAddr{(const int*)tbl, s_max}, valid, kv_len, q, k, v,
                  ks, vs, out, R, S, bk, qlen, group, hd, dtype, vec, scale,
                  stream);
}

// Paged (B20a): k / v [n_pages, bk, hd] (the whole pool, P_alloc rows),
// scales f32 [n_pages, bk], phys / logical / valid i32 [R, S] per QUERY
// replica, kv_len i32 [R_kv]; everything else as decode_attention.
extern "C" int paged_attention(const void* phys, const void* logical,
                               const void* valid, const void* kv_len,
                               const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, void* out,
                               int R, int S, int bk, int qlen, int group,
                               int hd, int n_pages, int dtype, int vec,
                               float scale, void* stream) {
  using namespace stt_decode;
  return dispatch(PagedAddr{(const int*)phys, (const int*)logical, n_pages},
                  valid, kv_len, q, k, v, ks, vs, out, R, S, bk, qlen, group,
                  hd, dtype, vec, scale, stream);
}
