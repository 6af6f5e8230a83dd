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
// Semantics, as the TPU kernel computes them slot by slot: a slot with
// valid == 0 (or a block id outside [0, s_max / bk)) is skipped; the
// others' keys enter one softmax per query row, online across the slots
// (a running max m and denominator l, acc rescaled by exp(m_prev - m_new)),
// and the output is acc / max(l, 1e-30). For int8 caches p * v_scale is
// quantised per row over each whole bk block. The split below computes
// the same softmax in another order.
//
// What bounds it on an H100: bytes. A decode step reads each tabled KV
// block once (2 * bk * hd * itemsize bytes) for a few FLOPs per byte; the
// speed of light is the attended KV bytes over 3.35 TB/s.
//
// Split-KV. One block per query replica walking its table slot after slot
// runs R blocks (32 at the serving shape) on 132 SMs with a few rows in
// flight each: 3% of the card's memory rate. So every query replica's
// table is cut into key chunks, one block of 8 warps each (grid [chunks,
// R]), and a second launch in the same call merges them:
//  * f32 / bf16 caches: chunks of `keys` keys inside a slot (the slot's
//    last chunk may be shorter when keys does not divide bk); the wrapper
//    picks keys, a power of two >= 64, so that R * chunks stays near a few
//    waves of the SMs (ops/kernels/decode_attention.py: split_keys).
//  * int8 caches: one chunk per slot (keys = bk). The int8 path quantises
//    p * v_scale per row over the whole bk block, so a chunk must hold a
//    whole block to keep the TPU kernel's quantisation grid. Its p is taken
//    against the serial walk's running max at that slot (any other max
//    gives the same codes only up to rounding ties, which do occur at
//    these sizes), so an int8 call first runs the chunks' scores alone
//    (MAXPASS, reading K once more) to write each slot's row maxima, and a
//    chunk's max is the largest of its own and the earlier slots'.
// Pass 1 computes each chunk's softmax state: its scores for every row
// (fp: (q*scale) . k * k_scale in f32 on the upcast cache; int8: q
// quantised per row to int8, int8 x int8 -> int32 by __dp4a, times
// q_scale * k_scale), masked causally with the finite -1e30 sentinel; per
// row a max m (int8: the running max above), p = exp(sc - m) (0 where
// sc <= -5e29) and l = sum p; acc = (p * v_scale) @ v (fp) or, for int8,
// p * v_scale quantised per row over the block to 0..127 (rintf, half to
// even), int32 products with the int8 values, times the block's scale. It
// writes the unnormalised acc [qlen, hd], m and l [qlen] to a workspace.
// A chunk that holds no key (past kv_len - 1, an invalid slot, a block or
// page id out of range) loads nothing and writes m = -1e30, l = 0, acc = 0.
// The merge (decode_merge_kernel), per replica and row, in a fixed order:
// M = max_j m_j, out = sum_j e^(m_j - M) acc_j / max(sum_j e^(m_j - M) l_j,
// 1e-30). A replica with no valid slot gives exactly 0, never NaN; no
// atomics, so the same bits run to run.
//
// Inside a chunk a lane owns four consecutive head-dim elements of each
// 128-wide group of head dims (G groups: 1 for hd <= 128, 2 for hd <= 256),
// so a warp reads a whole key (or value) row in G coalesced accesses, and
// scores are reduced across the warp with shuffles. At G = 1 the second
// group's loops vanish: hd <= 128 runs the one-group body, bit for bit.
//  * fp (decode_chunk_fp): each warp walks its own keys, two at a time,
//    loading their K and V rows and both scales together (one dependent
//    read a step), and keeps an online softmax of its own in registers; the
//    eight warps' states are merged through shared memory at the end. No
//    barrier inside the walk. Two keys a step keep the registers low, so
//    more blocks share an SM; four or eight keys a step were slower.
//  * int8 (decode_chunk_int8): the block-wide body, as the per-block p
//    scale needs: the warps split the keys for the scores, held in shared
//    memory (qlen x bk floats, 32 KiB at qlen = 8, bk = 1024); one warp a
//    row forms the statistics and quantises p; the warps split the keys
//    again for the int32 products, summed through shared memory.
// Both are compiled for one query row (a decode step: fewer registers,
// more blocks an SM) and for up to eight. bk <= 1024, hd <= 256. One read
// of K/V per GQA group and TMA are later work.
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
#include <type_traits>

namespace stt_decode {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QMAX = 8;        // query rows (speculative verification)
constexpr int HD_GROUP = 128;  // a group of head dims: four per lane
constexpr int HD_MAX = 2 * HD_GROUP;
constexpr int UNROLL = 8;      // keys in flight per warp (int8)
constexpr int FP_UNROLL = 2;   // keys a warp's step (fp: K and V rows)
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

// A block's chunk: keys lo .. lo + n - 1 of table slot s of query replica
// r, at positions key0 + j and rows base + j (key0 and base moved to the
// chunk's first key); n <= 0: nothing to attend. An out-of-range block or
// page id counts as an invalid slot, never a read; keys past len - 1 are
// masked for every row, so skipping them is exact. at: the chunk's state
// slot, r * chunks + c.
struct Chunk {
  int r, s, n, key0, qpos0;
  size_t base, at;
};

template <typename Addr>
__device__ __forceinline__ Chunk chunk_of(const Addr& addr, const int* valid,
                                          const int* kv_len, int S, int bk,
                                          int keys, int qlen, int group) {
  Chunk ch;
  const int c = blockIdx.x, per_slot = (bk + keys - 1) / keys;
  const int lo = (c % per_slot) * keys;
  ch.r = blockIdx.y;
  ch.s = c / per_slot;
  ch.at = (size_t)ch.r * gridDim.x + c;
  const int rk = ch.r / group, len = kv_len[rk], i = ch.r * S + ch.s;
  ch.qpos0 = len - qlen;  // row `row` sits at qpos0 + row
  ch.key0 = 0;
  ch.base = 0;
  const bool live = valid[i] == 1 && addr.resolve(i, rk, bk, ch.key0, ch.base);
  ch.n = live ? min(min(bk, lo + keys), len - ch.key0) - lo : 0;
  ch.key0 += lo;
  ch.base += lo;
  return ch;
}

// The identity of the merge: acc = 0, m = -1e30, l = 0.
__device__ __forceinline__ void write_empty(float* acc_out, float* ml_out,
                                            int qlen, int hd) {
  for (int e = threadIdx.x; e < qlen * hd; e += THREADS) acc_out[e] = 0.f;
  if (threadIdx.x < qlen) {
    ml_out[2 * threadIdx.x] = NEG_LARGE;
    ml_out[2 * threadIdx.x + 1] = 0.f;
  }
}

// Elements d0 + 128 gi .. + 3 (gi < G) of q's rows of replica r, times
// scale (0 past qlen).
template <int QN, int G>
__device__ __forceinline__ void load_q(const float* q, int r, int qlen,
                                       int hd, int d0, bool vec, float scale,
                                       float qf[QN][G][4]) {
#pragma unroll
  for (int row = 0; row < QN; ++row)
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      if (row < qlen) {
        load4(q + ((size_t)r * qlen + row) * hd, d0 + HD_GROUP * gi, hd,
              vec, qf[row][gi]);
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[row][gi][i] *= scale;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) qf[row][gi][i] = 0.f;
      }
    }
}

// f32 / bf16 caches: each warp runs an online softmax of its own over its
// keys, FP_UNROLL at a time, and the warps' states are merged at the end. QN:
// the query rows the registers hold, 1 (a decode step) or QMAX; G: the
// 128-wide head-dim groups a lane covers.
template <typename T, int QN, int G, typename Addr>
__global__ void __launch_bounds__(THREADS)
decode_chunk_fp(Addr addr, const int* __restrict__ valid,
                const int* __restrict__ kv_len, const float* __restrict__ q,
                const T* __restrict__ kc, const T* __restrict__ vc,
                const float* __restrict__ k_scale,
                const float* __restrict__ v_scale,
                float* __restrict__ part_acc, float* __restrict__ part_ml,
                int S, int bk, int keys, int qlen, int group, int hd,
                float scale, int vec_i) {
  __shared__ __align__(16) float wacc[WARPS][QN][HD_GROUP];
  __shared__ float wm[WARPS][QN], wl[WARPS][QN];
  const bool vec = vec_i != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = lane * 4;
  const Chunk ch = chunk_of(addr, valid, kv_len, S, bk, keys, qlen, group);
  float* acc_out = part_acc + ch.at * qlen * hd;
  float* ml_out = part_ml + ch.at * qlen * 2;
  if (ch.n <= 0) {
    write_empty(acc_out, ml_out, qlen, hd);
    return;
  }

  float qf[QN][G][4], m[QN], l[QN], acc[QN][G][4];
  load_q<QN, G>(q, ch.r, qlen, hd, d0, vec, scale, qf);
#pragma unroll
  for (int row = 0; row < QN; ++row) {
    m[row] = NEG_LARGE;
    l[row] = 0.f;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[row][gi][i] = 0.f;
  }

  for (int j0 = warp * FP_UNROLL; j0 < ch.n; j0 += WARPS * FP_UNROLL) {
    // K and V rows and both scales of FP_UNROLL keys, all in flight at once
    float kf[FP_UNROLL][G][4], vf[FP_UNROLL][G][4], ks[FP_UNROLL],
        vs[FP_UNROLL];
#pragma unroll
    for (int u = 0; u < FP_UNROLL; ++u) {
      const size_t row = ch.base + j0 + u;
      if (j0 + u < ch.n) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          load4(kc + row * hd, d0 + HD_GROUP * gi, hd, vec, kf[u][gi]);
          load4(vc + row * hd, d0 + HD_GROUP * gi, hd, vec, vf[u][gi]);
        }
        ks[u] = k_scale[row];
        vs[u] = v_scale[row];
      } else {
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int i = 0; i < 4; ++i) kf[u][gi][i] = vf[u][gi][i] = 0.f;
        ks[u] = vs[u] = 0.f;
      }
    }
#pragma unroll
    for (int row = 0; row < QN; ++row) {
      if (row >= qlen) break;
      float sc[FP_UNROLL];
      float mx = m[row];
#pragma unroll
      for (int u = 0; u < FP_UNROLL; ++u) {
        const int j = j0 + u;
        float part = 0.f;
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            part = fmaf(qf[row][gi][i], kf[u][gi][i], part);
        part = warp_sum(part) * ks[u];
        sc[u] = j < ch.n && ch.key0 + j <= ch.qpos0 + row ? part : NEG_LARGE;
        mx = fmaxf(mx, sc[u]);
      }
      const float corr = expf(m[row] - mx);
      l[row] *= corr;
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[row][gi][i] *= corr;
#pragma unroll
      for (int u = 0; u < FP_UNROLL; ++u) {
        const float p = sc[u] <= NEG_LARGE / 2 ? 0.f : expf(sc[u] - mx);
        l[row] += p;
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[row][gi][i] = fmaf(p * vs[u], vf[u][gi][i], acc[row][gi][i]);
      }
      m[row] = mx;
    }
  }

  // -- merge the warps' states into the chunk's, one head-dim group at a
  // time through shared memory
#pragma unroll
  for (int row = 0; row < QN; ++row) {
    if (row >= qlen) break;
    if (lane == 0) {
      wm[warp][row] = m[row];
      wl[warp][row] = l[row];
    }
  }
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int dg = HD_GROUP * gi, nd = min(HD_GROUP, hd - dg);
    if (gi > 0) __syncthreads();  // every thread has read the last group
#pragma unroll
    for (int row = 0; row < QN; ++row) {
      if (row >= qlen) break;
#pragma unroll
      for (int i = 0; i < 4; ++i) wacc[warp][row][d0 + i] = acc[row][gi][i];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < qlen * nd; e += THREADS) {
      const int row = e / nd, d = e % nd;
      float mx = NEG_LARGE, sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w][row]);
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        sum += expf(wm[w][row] - mx) * wacc[w][row][d];
      acc_out[row * hd + dg + d] = sum;
    }
  }
  if (threadIdx.x < qlen) {
    const int row = threadIdx.x;
    float mx = NEG_LARGE, sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wm[w][row]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += expf(wm[w][row] - mx) * wl[w][row];
    ml_out[2 * row] = mx;
    ml_out[2 * row + 1] = sum;
  }
}

// int8 caches: one slot a chunk (keys = bk), the block-wide body. The
// warps split the keys for the scores, held in shared memory; one warp a
// row forms the statistics against the slot walk's running max and
// quantises p * v_scale over the whole block; the warps split the keys
// again for the int32 products, summed through shared memory. MAXPASS:
// the scores alone, their row maxima written to slot_max [R, S, qlen]. G:
// the 128-wide head-dim groups a lane covers.
template <bool MAXPASS, int QN, int G, typename Addr>
__global__ void __launch_bounds__(THREADS)
decode_chunk_int8(Addr addr, const int* __restrict__ valid,
                  const int* __restrict__ kv_len, const float* __restrict__ q,
                  const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
                  const float* __restrict__ k_scale,
                  const float* __restrict__ v_scale,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  float* __restrict__ slot_max, int S, int bk, int keys,
                  int qlen, int group, int hd, float scale, int vec_i) {
  // scores / probabilities [qlen][keys], reused at the end for the warps'
  // partial outputs [WARPS][qlen][HD_GROUP], one head-dim group at a time
  extern __shared__ __align__(16) float smem[];
  __shared__ float m_s[QMAX], l_s[QMAX], ps_s[QMAX];
  const bool vec = vec_i != 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = lane * 4;
  const Chunk ch = chunk_of(addr, valid, kv_len, S, bk, keys, qlen, group);
  float* acc_out = part_acc + ch.at * qlen * hd;
  float* ml_out = part_ml + ch.at * qlen * 2;
  const int n = ch.n;
  if (n <= 0) {
    if constexpr (MAXPASS) {
      if (threadIdx.x < qlen)
        slot_max[ch.at * qlen + threadIdx.x] = NEG_LARGE;
    } else {
      write_empty(acc_out, ml_out, qlen, hd);
    }
    return;
  }

  // per-row symmetric int8 q, as the TPU kernel's q tile
  float qf[QN][G][4];
  int qw[QN][G];
  float qsc[QN];
  load_q<QN, G>(q, ch.r, qlen, hd, d0, vec, scale, qf);
#pragma unroll
  for (int row = 0; row < QN; ++row) {
    float a = 0.f;
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) a = fmaxf(a, fabsf(qf[row][gi][i]));
    qsc[row] = fmaxf(warp_max(a), 1e-30f) / 127.f;
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      qw[row][gi] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float t =
            fminf(fmaxf(rintf(qf[row][gi][i] / qsc[row]), -127.f), 127.f);
        qw[row][gi] |= ((int)t & 0xff) << (8 * i);
      }
    }
  }

  // -- scores of the chunk, every row
  for (int j0 = warp * UNROLL; j0 < n; j0 += WARPS * UNROLL) {
    int kw[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        kw[u][gi] = j0 + u < n ? load4i(kc + (ch.base + j0 + u) * hd,
                                        d0 + HD_GROUP * gi, hd, vec)
                               : 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u;
      if (j >= n) break;
      const float ks = k_scale[ch.base + j];
#pragma unroll
      for (int row = 0; row < QN; ++row) {
        if (row >= qlen) break;
        int dot = 0;
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          dot = __dp4a(qw[row][gi], kw[u][gi], dot);
        const float sc = (float)warp_sum(dot) * qsc[row] * ks;
        if (lane == 0)
          smem[row * keys + j] =
              ch.key0 + j <= ch.qpos0 + row ? sc : NEG_LARGE;
      }
    }
  }
  __syncthreads();

  // -- row statistics and p, one warp per row
  if (warp < qlen) {
    const int row = warp;
    float* prow = smem + row * keys;
    float mb = NEG_LARGE;
    for (int j = lane; j < n; j += 32) mb = fmaxf(mb, prow[j]);
    float m = warp_max(mb);
    if constexpr (MAXPASS) {
      if (lane == 0) slot_max[ch.at * qlen + row] = m;
      return;
    }
    // the running max of the slot walk at slot s
    const float* sm = slot_max + (size_t)ch.r * S * qlen + row;
    for (int t = 0; t < ch.s; ++t) m = fmaxf(m, sm[t * qlen]);
    float sum = 0.f, pmax = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float sc = prow[j];
      const float p = sc <= NEG_LARGE / 2 ? 0.f : expf(sc - m);
      sum += p;
      const float pv = p * v_scale[ch.base + j];
      prow[j] = pv;
      pmax = fmaxf(pmax, pv);
    }
    sum = warp_sum(sum);
    const float ps = fmaxf(warp_max(pmax), 1e-30f) / 127.f;
    for (int j = lane; j < n; j += 32)
      prow[j] = fminf(fmaxf(rintf(prow[j] / ps), 0.f), 127.f);
    if (lane == 0) {
      m_s[row] = m;
      l_s[row] = sum;
      ps_s[row] = ps;
    }
  }
  if constexpr (MAXPASS) return;
  __syncthreads();

  // -- acc = (codes @ v) * ps over this warp's keys, exact int32 sums
  int ipart[QN][G][4];
#pragma unroll
  for (int row = 0; row < QN; ++row)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int i = 0; i < 4; ++i) ipart[row][gi][i] = 0;
  for (int j0 = warp * UNROLL; j0 < n; j0 += WARPS * UNROLL) {
    int vw[UNROLL][G];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        vw[u][gi] = j0 + u < n ? load4i(vc + (ch.base + j0 + u) * hd,
                                        d0 + HD_GROUP * gi, hd, vec)
                               : 0;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u;
      if (j >= n) break;
#pragma unroll
      for (int row = 0; row < QN; ++row) {
        if (row >= qlen) break;
        const int pi = (int)smem[row * keys + j];
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            ipart[row][gi][i] += pi * byte_at(vw[u][gi], i);
      }
    }
  }

  // -- sum the warps' partial outputs into the chunk's unnormalised acc,
  // one head-dim group at a time
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const int dg = HD_GROUP * gi, nd = min(HD_GROUP, hd - dg);
    __syncthreads();  // every warp is done with the probabilities (gi = 0)
                      // or with the last group's sums
#pragma unroll
    for (int row = 0; row < QN; ++row) {
      if (row >= qlen) break;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        smem[(warp * qlen + row) * HD_GROUP + d0 + i] =
            (float)ipart[row][gi][i] * ps_s[row];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < qlen * nd; e += THREADS) {
      const int row = e / nd, d = e % nd;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        sum += smem[(w * qlen + row) * HD_GROUP + d];
      acc_out[row * hd + dg + d] = sum;
    }
  }
  if (threadIdx.x < qlen) {
    ml_out[2 * threadIdx.x] = m_s[threadIdx.x];
    ml_out[2 * threadIdx.x + 1] = l_s[threadIdx.x];
  }
}

// The merge, one block per query replica: the chunks' states
// [R, chunks, qlen, hd] / [R, chunks, qlen, 2] rescaled to their common max
// and summed. One warp a row finds the max and the denominator (its lanes
// striding the chunks, reduced in a fixed order), then a thread an output
// element sums its numerator in chunk order.
__global__ void __launch_bounds__(THREADS)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    float* __restrict__ out, int chunks, int qlen, int hd) {
  __shared__ float mx_s[QMAX], den_s[QMAX];
  const int r = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t acc_step = (size_t)qlen * hd, ml_step = (size_t)qlen * 2;
  const float* ml = part_ml + (size_t)r * chunks * ml_step;
  if (warp < qlen) {
    float mx = NEG_LARGE, den = 0.f;
    for (int c = lane; c < chunks; c += 32)
      mx = fmaxf(mx, ml[c * ml_step + 2 * warp]);
    mx = warp_max(mx);
    for (int c = lane; c < chunks; c += 32)
      den += expf(ml[c * ml_step + 2 * warp] - mx) *
             ml[c * ml_step + 2 * warp + 1];
    den = warp_sum(den);
    if (lane == 0) {
      mx_s[warp] = mx;
      den_s[warp] = den;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < qlen * hd; e += THREADS) {
    const int row = e / hd;
    const float* acc = part_acc + (size_t)r * chunks * acc_step + e;
    const float mx = mx_s[row];
    float num = 0.f;
#pragma unroll 4
    for (int c = 0; c < chunks; ++c)
      num += expf(ml[c * ml_step + 2 * row] - mx) * acc[c * acc_step];
    out[(size_t)r * acc_step + e] = num / fmaxf(den_s[row], 1e-30f);
  }
}

template <typename T, int G, typename Addr>
int launch(Addr addr, const void* valid, const void* kv_len, const void* q,
           const void* k, const void* v, const void* ks, const void* vs,
           void* out, void* work, int R, int S, int bk, int keys, int qlen,
           int group, int hd, float scale, int vec, cudaStream_t stream) {
  const int chunks = S * ((bk + keys - 1) / keys);
  float* part_acc = (float*)work;
  float* part_ml = part_acc + (size_t)R * chunks * qlen * hd;
  float* slot_max = part_ml + (size_t)R * chunks * qlen * 2;
  if (chunks > 0) {
    const dim3 grid(chunks, R);
    const int *va = (const int*)valid, *kl = (const int*)kv_len;
    const float *qf = (const float*)q, *ksf = (const float*)ks,
                *vsf = (const float*)vs;
    // the body for one query row (a decode step) or for up to QMAX
    if constexpr (std::is_same<T, int8_t>::value) {
      const size_t smem =
          std::max(qlen * keys, WARPS * qlen * HD_GROUP) * sizeof(float);
      const int8_t *k8 = (const int8_t*)k, *v8 = (const int8_t*)v;
#define STT_INT8_ARGS                                                     \
  addr, va, kl, qf, k8, v8, ksf, vsf, part_acc, part_ml, slot_max, S, bk, \
      keys, qlen, group, hd, scale, vec
      if (qlen == 1)
        decode_chunk_int8<true, 1, G, Addr>
            <<<grid, THREADS, smem, stream>>>(STT_INT8_ARGS);
      else
        decode_chunk_int8<true, QMAX, G, Addr>
            <<<grid, THREADS, smem, stream>>>(STT_INT8_ARGS);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      if (qlen == 1)
        decode_chunk_int8<false, 1, G, Addr>
            <<<grid, THREADS, smem, stream>>>(STT_INT8_ARGS);
      else
        decode_chunk_int8<false, QMAX, G, Addr>
            <<<grid, THREADS, smem, stream>>>(STT_INT8_ARGS);
#undef STT_INT8_ARGS
    } else {
#define STT_FP_ARGS                                                        \
  addr, va, kl, qf, (const T*)k, (const T*)v, ksf, vsf, part_acc, part_ml, \
      S, bk, keys, qlen, group, hd, scale, vec
      if (qlen == 1)
        decode_chunk_fp<T, 1, G, Addr>
            <<<grid, THREADS, 0, stream>>>(STT_FP_ARGS);
      else
        decode_chunk_fp<T, QMAX, G, Addr>
            <<<grid, THREADS, 0, stream>>>(STT_FP_ARGS);
#undef STT_FP_ARGS
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  decode_merge_kernel<<<R, THREADS, 0, stream>>>(part_acc, part_ml,
                                                 (float*)out, chunks, qlen,
                                                 hd);
  return (int)cudaGetLastError();
}

template <typename Addr>
int dispatch(Addr addr, const void* valid, const void* kv_len, const void* q,
             const void* k, const void* v, const void* ks, const void* vs,
             void* out, void* work, int R, int S, int bk, int keys, int qlen,
             int group, int hd, int dtype, int vec, float scale,
             void* stream) {
  if (qlen < 1 || qlen > QMAX || hd < 1 || hd > HD_MAX || bk < 1 ||
      bk > 1024 || keys < 1 || keys > bk || (dtype == 2 && keys != bk))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define STT_DEC_ARGS                                                       \
  addr, valid, kv_len, q, k, v, ks, vs, out, work, R, S, bk, keys, qlen,   \
      group, hd, scale, vec, st
  // one 128-wide group of head dims a lane up to 128, two up to 256
  if (hd <= HD_GROUP) {
    if (dtype == 0) return launch<float, 1>(STT_DEC_ARGS);
    if (dtype == 1) return launch<__nv_bfloat16, 1>(STT_DEC_ARGS);
    if (dtype == 2) return launch<int8_t, 1>(STT_DEC_ARGS);
  } else {
    if (dtype == 0) return launch<float, 2>(STT_DEC_ARGS);
    if (dtype == 1) return launch<__nv_bfloat16, 2>(STT_DEC_ARGS);
    if (dtype == 2) return launch<int8_t, 2>(STT_DEC_ARGS);
  }
#undef STT_DEC_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace stt_decode

// dtype: 0 f32, 1 bf16, 2 int8 (the cache's). q f32 [R, qlen, hd],
// k / v [R_kv, s_max, hd], scales f32 [R_kv, s_max], tbl / valid i32 [R, S],
// kv_len i32 [R_kv], out f32 [R, qlen, hd]; keys: the keys of a chunk
// (<= bk; = bk for int8); work f32 [R * chunks * qlen * (hd + 2) +
// R * S * qlen] with chunks = S * ceil(bk / keys). qlen <= 8, hd <= 256,
// bk <= 1024 (the wrapper checks). vec: hd % 4 == 0 and q / k / v 16-byte
// aligned. Two launches, the chunks then the merge; int8 three, the slot
// maxima first.
extern "C" int decode_attention(const void* tbl, const void* valid,
                                const void* kv_len, const void* q,
                                const void* k, const void* v, const void* ks,
                                const void* vs, void* out, void* work, int R,
                                int S, int bk, int keys, int qlen, int group,
                                int hd, int s_max, int dtype, int vec,
                                float scale, void* stream) {
  using namespace stt_decode;
  return dispatch(ContigAddr{(const int*)tbl, s_max}, valid, kv_len, q, k, v,
                  ks, vs, out, work, R, S, bk, keys, qlen, group, hd, dtype,
                  vec, scale, stream);
}

// Paged (B20a): k / v [n_pages, bk, hd] (the whole pool, P_alloc rows),
// scales f32 [n_pages, bk], phys / logical / valid i32 [R, S] per QUERY
// replica, kv_len i32 [R_kv]; everything else as decode_attention.
extern "C" int paged_attention(const void* phys, const void* logical,
                               const void* valid, const void* kv_len,
                               const void* q, const void* k, const void* v,
                               const void* ks, const void* vs, void* out,
                               void* work, int R, int S, int bk, int keys,
                               int qlen, int group, int hd, int n_pages,
                               int dtype, int vec, float scale,
                               void* stream) {
  using namespace stt_decode;
  return dispatch(PagedAddr{(const int*)phys, (const int*)logical, n_pages},
                  valid, kv_len, q, k, v, ks, vs, out, work, R, S, bk, keys,
                  qlen, group, hd, dtype, vec, scale, stream);
}
