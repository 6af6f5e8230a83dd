// The compressed panel's sparse softmax, in two kernel bodies: a segment
// reduction over each row's ragged tiles (B15a) and an elementwise pass
// over the tiles (B15b). Each body has a second mode that the softmax
// backward runs, so forward and backward are two launches each.
//
// Replaces the TPU kernels sputnik_tpu/ops/pallas/bsr_compressed.py:
// c_softmax_stats and c_softmax_apply, and in the backward the ragged row
// sum that JAX takes with bsr_spmm_panel_c against a ones column. The panel
// is the true-BSR layout values[R, T, bm, bk] (blocking.CompressedView,
// T = num_blocks + 1, the last tile a dump): row block i owns tiles
// block_offsets[i] .. block_offsets[i + 1], so a row's nonzeros are ragged
// across back-to-back tiles. mask[T, bm, bk] is 1 at the nonzeros (0
// everywhere in the dump).
//
// Semantics. B15a (STATS): per row, the max m over the row's nonzeros
// (masked elements score -1e30, so m >= -1e30) and the denominator l =
// sum exp(v - m); a row without nonzeros ends at (-1e30, 0). B15a (ROWSUM,
// the backward): rs = sum p * g over the row's nonzeros, g taken as 0 at
// masked slots. Both write f32[R, mb * bm]. B15b (APPLY): exp(v - m[row]) /
// max(l[row], 1e-30) at the nonzeros; B15b (GRAD, the backward): p * (g -
// rs[row]) at the nonzeros; both an exact 0 at every other slot and in the
// dump tile, so no slot of the output is undefined and a NaN cotangent at a
// masked slot cannot leak. expf and a true divide (no __expf), so the
// kernels and their plain versions agree slot by slot.
//
// B15a's design. A row block may hold one tile or a whole row of them (the
// dense rows of a sliding window with global tokens), so one block a row
// block would leave the card idle behind a few long walks. The host cuts
// every row block's tiles into chunks of at most `chunk` tiles
// (ops/kernels/bsr_compressed.py split_plan, the plan B13a also walks); one
// CUDA block per (chunk, replica) reduces all bm rows of its tiles in one
// pass: a group of lanes a row, 16-byte loads, each lane folding its
// elements online into (m, l) (STATS) or a sum (ROWSUM), the group's lanes
// combined by shuffles. A row block's only chunk writes its result. A cut
// row block's chunks write partials (m_c, l_c) or rs_c; the last of its
// blocks to finish (an integer counter after __threadfence, reset to 0 by
// that block, so repeated calls need no fill; launches that may overlap
// take separate counters) merges them,
// all its threads reading the partials at once, in a fixed order: m =
// max_c m_c, exact in any order, and l = sum_c l_c * exp(m_c - m). No
// float atomics, so two calls give the same bits.
//
// B15b's design: one block of 256 threads per (tile, replica), the row
// statistics of the tile's bm rows read once into shared memory, 16-byte
// loads and stores; the dump tile is written as zeros without a read.
#include <cuda_runtime.h>

namespace stt_csoftmax {

constexpr int THREADS = 256;
constexpr int MAX_BM = 1024;         // shared row statistics of B15b
constexpr float NEG_LARGE = -1e30f;  // the TPU kernel's masked score
constexpr float MIN_DENOM = 1e-30f;  // the TPU kernel's denominator floor

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ float get(const float4& v, int k) {
    return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ void set(float4& v, int k, float x) {
    if (k == 0) v.x = x;
    else if (k == 1) v.y = x;
    else if (k == 2) v.z = x;
    else v.w = x;
  }
};
template <>
struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ float get(const float& v, int) {
    return v;
  }
  static __device__ __forceinline__ void set(float& v, int, float x) {
    v = x;
  }
};

// Lanes a row (a power of two <= 32): enough rows in flight to cover the
// tile's bm rows in one pass of the block where the row allows it.
__host__ __device__ __forceinline__ int row_lanes(int bm, int segs) {
  int g = 1;
  while (g < 32 && g * 2 * bm <= THREADS) g *= 2;
  int s = 1;
  while (s < segs) s *= 2;
  return g < s ? g : s;
}

struct Chunk {
  int row, first, count, part;
};

// Chunk c of the plan.
__device__ __forceinline__ Chunk chunk_of(const int* chunks, int c) {
  const int4 q = reinterpret_cast<const int4*>(chunks)[c];
  return {q.x, q.y, q.z, q.w};
}

// (m, l) of a softmax's partial sums folded with (mo, lo): the larger max,
// each denominator rescaled to it.
__device__ __forceinline__ void fold(float& m, float& l, float mo, float lo) {
  const float mn = fmaxf(m, mo);
  l = l * expf(m - mn) + lo * expf(mo - mn);
  m = mn;
}

// B15a. STATS: a = scores, out0 / out1 = row_max / row_denom, part0 /
// part1 their partials. ROWSUM: a = p, b = g, out0 = rs, part0 its
// partials. Partials are [R, n_parts, bm]; counters [R, mb].
template <int VEC, bool ROWSUM>
__global__ void __launch_bounds__(THREADS)
c_softmax_rows_kernel(const int* __restrict__ offs,
                      const int* __restrict__ chunks,
                      const float* __restrict__ a,
                      const float* __restrict__ b,
                      const float* __restrict__ mask,
                      float* __restrict__ out0, float* __restrict__ out1,
                      float* part0, float* part1, int* counters, int mb,
                      int T, int bm, int bk, int chunk, int n_parts) {
  using V = Vec<VEC>;
  using VT = typename V::T;
  const int r = blockIdx.y;
  const Chunk ch = chunk_of(chunks, blockIdx.x);
  const int segs = bk / VEC;
  const int lanes = row_lanes(bm, segs);
  const int rows_a_pass = THREADS / lanes;
  const int lane = threadIdx.x % lanes, grp = threadIdx.x / lanes;
  const size_t tile = (size_t)bm * bk;
  const float* A = a + (size_t)r * T * tile;
  const float* B = ROWSUM ? b + (size_t)r * T * tile : nullptr;
  const size_t out_row0 = ((size_t)r * mb + ch.row) * bm;

  // one pass over the chunk's tiles: each lane folds its elements online
  // (STATS) or sums them (ROWSUM), then the row's lanes combine by
  // shuffles; every lane of a warp runs the same passes (the shuffles)
  for (int base = 0; base < bm; base += rows_a_pass) {
    const int ri = base + grp;
    float m = NEG_LARGE, l = 0.f;
    if (ri < bm) {
#pragma unroll 2
      for (int t = 0; t < ch.count; ++t) {
        const size_t at = (size_t)(ch.first + t) * tile + (size_t)ri * bk;
        const VT* v = reinterpret_cast<const VT*>(A + at);
        const VT* mk = reinterpret_cast<const VT*>(mask + at);
        const VT* g = ROWSUM ? reinterpret_cast<const VT*>(B + at) : nullptr;
#pragma unroll 4
        for (int s = lane; s < segs; s += lanes) {
          const VT vv = v[s], mm = mk[s];
          if (ROWSUM) {
            const VT gg = g[s];
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              if (V::get(mm, k) != 0.f) l += V::get(vv, k) * V::get(gg, k);
          } else {
            float x[VEC], mx = NEG_LARGE;
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
              x[k] = V::get(mm, k) != 0.f ? V::get(vv, k) : NEG_LARGE;
              mx = fmaxf(mx, x[k]);
            }
            const float mn = fmaxf(m, mx);
            float e = 0.f;
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              if (V::get(mm, k) != 0.f) e += expf(x[k] - mn);
            l = l * expf(m - mn) + e;
            m = mn;
          }
        }
      }
    }
    for (int o = lanes / 2; o > 0; o >>= 1) {
      const float lo = __shfl_xor_sync(0xffffffffu, l, o);
      if (ROWSUM) {
        l += lo;
      } else {
        fold(m, l, __shfl_xor_sync(0xffffffffu, m, o), lo);
      }
    }
    if (ri < bm && lane == 0) {
      if (ch.part < 0) {
        if (ROWSUM) {
          out0[out_row0 + ri] = l;
        } else {
          out0[out_row0 + ri] = m;
          out1[out_row0 + ri] = l;
        }
      } else {
        const size_t at = ((size_t)r * n_parts + ch.part) * bm + ri;
        part0[at] = ROWSUM ? l : m;
        if (!ROWSUM) part1[at] = l;
      }
    }
  }
  if (ch.part < 0) return;  // the row block's only chunk: written

  // a cut row block: the last of its blocks merges the partials
  __shared__ int last;
  __shared__ float sm[THREADS], sl[THREADS];
  __threadfence();
  __syncthreads();
  const int n = (offs[ch.row + 1] - offs[ch.row] + chunk - 1) / chunk;
  if (threadIdx.x == 0) {
    int* cnt = counters + (size_t)r * mb + ch.row;
    last = atomicAdd(cnt, 1) == n - 1;
    if (last) *cnt = 0;  // every chunk has counted: ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // `ways` threads a row each fold every ways-th partial (coalesced along
  // the rows, reads past L1), then the first folds the ways results in
  // order: a fixed order, so the same bits every call
  const int ways = bm < THREADS ? THREADS / bm : 1;
  const int rows = THREADS / ways;
  const int w = threadIdx.x / rows;
  const size_t p0 =
      (size_t)r * n_parts + ch.part - (ch.first - offs[ch.row]) / chunk;
  for (int base = 0; base < bm; base += rows) {
    const int ri = base + threadIdx.x % rows;
    float m = NEG_LARGE, l = 0.f;
    if (ri < bm && w < ways) {
#pragma unroll 4
      for (int j = w; j < n; j += ways) {
        const size_t at = (p0 + j) * bm + ri;
        if (ROWSUM) l += __ldcg(part0 + at);
        else fold(m, l, __ldcg(part0 + at), __ldcg(part1 + at));
      }
    }
    sm[threadIdx.x] = m;
    sl[threadIdx.x] = l;
    __syncthreads();
    if (ri < bm && w == 0) {
      for (int u = 1; u < ways; ++u) {
        const int at = u * rows + threadIdx.x;
        if (ROWSUM) l += sl[at];
        else fold(m, l, sm[at], sl[at]);
      }
      out0[out_row0 + ri] = ROWSUM ? l : m;
      if (!ROWSUM) out1[out_row0 + ri] = l;
    }
    __syncthreads();
  }
}

// B15b. APPLY: a = scores, s0 / s1 = row_max / row_denom. GRAD: a = p,
// b = g, s0 = rs. s0 / s1 are [R, M].
template <int VEC, bool GRAD>
__global__ void __launch_bounds__(THREADS)
c_softmax_tiles_kernel(const int* __restrict__ block_rows,
                       const float* __restrict__ a,
                       const float* __restrict__ b,
                       const float* __restrict__ mask,
                       const float* __restrict__ s0,
                       const float* __restrict__ s1,
                       float* __restrict__ out, int T, int bm, int bk,
                       int M) {
  using V = Vec<VEC>;
  using VT = typename V::T;
  __shared__ float st0[MAX_BM], st1[MAX_BM];
  const int g = blockIdx.x, r = blockIdx.y;
  const size_t tile = (size_t)bm * bk;
  const size_t at = ((size_t)r * T + g) * tile;
  const int segs = bk / VEC;
  const int n_vec = bm * segs;
  VT* o = reinterpret_cast<VT*>(out + at);
  if (g == T - 1) {  // the dump tile: zeros, nothing read
    VT z;
#pragma unroll
    for (int k = 0; k < VEC; ++k) V::set(z, k, 0.f);
    for (int e = threadIdx.x; e < n_vec; e += THREADS) o[e] = z;
    return;
  }
  const int row0 = block_rows[g] * bm;
  for (int ri = threadIdx.x; ri < bm; ri += THREADS) {
    const int row = row0 + ri;
    const bool ok = row < M;  // rows past M: 0
    const size_t sr = (size_t)r * M + row;
    st0[ri] = ok ? s0[sr] : 0.f;
    if (!GRAD) st1[ri] = ok ? fmaxf(s1[sr], MIN_DENOM) : 1.f;
  }
  __syncthreads();
  const VT* v = reinterpret_cast<const VT*>(a + at);
  const VT* gr = GRAD ? reinterpret_cast<const VT*>(b + at) : nullptr;
  const VT* mk = reinterpret_cast<const VT*>(mask + (size_t)g * tile);
  for (int e = threadIdx.x; e < n_vec; e += THREADS) {
    const int ri = e / segs;
    const bool ok = row0 + ri < M;
    const float x0 = st0[ri], x1 = GRAD ? 0.f : st1[ri];
    const VT vv = v[e], mm = mk[e];
    VT gg;
    if (GRAD) gg = gr[e];
    VT y;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float out_k = 0.f;
      if (ok && V::get(mm, k) != 0.f)
        out_k = GRAD ? V::get(vv, k) * (V::get(gg, k) - x0)
                     : expf(V::get(vv, k) - x0) / x1;
      V::set(y, k, out_k);
    }
    o[e] = y;
  }
}

template <bool ROWSUM>
int launch_rows(const void* offs, const void* chunks, const void* a,
                const void* b, const void* mask, void* out0, void* out1,
                void* part0, void* part1, void* counters, int R, int mb,
                int n_chunks, int chunk, int n_parts, int T, int bm, int bk,
                int vec, void* stream) {
  if (R <= 0 || n_chunks <= 0 || bm <= 0) return 0;
  if (chunks == nullptr || (n_parts > 0 && counters == nullptr))
    return (int)cudaErrorInvalidValue;
  if (R > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(n_chunks, R);
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(
        (const int*)offs, (const int*)chunks, (const float*)a,
        (const float*)b, (const float*)mask, (float*)out0, (float*)out1,
        (float*)part0, (float*)part1, (int*)counters, mb, T, bm, bk, chunk,
        n_parts);
  };
  if (vec == 4) go(c_softmax_rows_kernel<4, ROWSUM>);
  else go(c_softmax_rows_kernel<1, ROWSUM>);
  return (int)cudaGetLastError();
}

template <bool GRAD>
int launch_tiles(const void* block_rows, const void* a, const void* b,
                 const void* mask, const void* s0, const void* s1, void* out,
                 int R, int T, int bm, int bk, int M, int vec, void* stream) {
  if (T <= 0 || R <= 0) return 0;
  if (R > 65535 || bm > MAX_BM) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(T, R);
  cudaStream_t s = (cudaStream_t)stream;
  auto go = [&](auto kernel) {
    kernel<<<grid, THREADS, 0, s>>>(
        (const int*)block_rows, (const float*)a, (const float*)b,
        (const float*)mask, (const float*)s0, (const float*)s1, (float*)out,
        T, bm, bk, M);
  };
  if (vec == 4) go(c_softmax_tiles_kernel<4, GRAD>);
  else go(c_softmax_tiles_kernel<1, GRAD>);
  return (int)cudaGetLastError();
}

}  // namespace stt_csoftmax

// B15a: block_offsets i32[mb + 1], chunks i32[n_chunks, 4] (row block,
// first tile, tile count, partial slot or -1; the split plan),
// panel f32[R, T, bm, bk], mask f32[T, bm, bk] -> row_max, row_denom f32[R,
// mb * bm]. part_m / part_l f32[R, n_parts, bm] and counters i32[R, mb]
// (zero before the call, zero after it) serve the cut row blocks. vec: 4
// where bk % 4 == 0 and the panels are 16-byte aligned, else 1.
extern "C" int c_softmax_stats_f32(const void* block_offsets,
                                   const void* chunks, const void* panel,
                                   const void* mask, void* row_max,
                                   void* row_denom, void* part_m,
                                   void* part_l, void* counters, int R,
                                   int mb, int n_chunks, int chunk,
                                   int n_parts, int T, int bm, int bk,
                                   int vec, void* stream) {
  return stt_csoftmax::launch_rows<false>(
      block_offsets, chunks, panel, nullptr, mask, row_max, row_denom,
      part_m, part_l, counters, R, mb, n_chunks, chunk, n_parts, T, bm, bk,
      vec, stream);
}

// B15a's backward mode: p, g f32[R, T, bm, bk] -> rs f32[R, mb * bm], the
// sum of p * g over each row's nonzeros; part f32[R, n_parts, bm].
extern "C" int c_softmax_rowsum_f32(const void* block_offsets,
                                    const void* chunks, const void* p,
                                    const void* g, const void* mask,
                                    void* rs, void* part, void* counters,
                                    int R, int mb, int n_chunks, int chunk,
                                    int n_parts, int T, int bm, int bk,
                                    int vec, void* stream) {
  return stt_csoftmax::launch_rows<true>(
      block_offsets, chunks, p, g, mask, rs, nullptr, part, nullptr,
      counters, R, mb, n_chunks, chunk, n_parts, T, bm, bk, vec, stream);
}

// B15b: block_rows i32[T], panel f32[R, T, bm, bk], mask f32[T, bm, bk],
// row_max / row_denom f32[R, M] -> out f32[R, T, bm, bk].
extern "C" int c_softmax_apply_f32(const void* block_rows, const void* panel,
                                   const void* mask, const void* row_max,
                                   const void* row_denom, void* out, int R,
                                   int T, int bm, int bk, int M, int vec,
                                   void* stream) {
  return stt_csoftmax::launch_tiles<false>(block_rows, panel, nullptr, mask,
                                           row_max, row_denom, out, R, T, bm,
                                           bk, M, vec, stream);
}

// B15b's backward mode: p, g f32[R, T, bm, bk], rs f32[R, M] -> out f32[R,
// T, bm, bk] = p * (g - rs[row]) at the nonzeros, 0 elsewhere.
extern "C" int c_softmax_grad_f32(const void* block_rows, const void* p,
                                  const void* g, const void* mask,
                                  const void* rs, void* out, int R, int T,
                                  int bm, int bk, int M, int vec,
                                  void* stream) {
  return stt_csoftmax::launch_tiles<true>(block_rows, p, g, mask, rs,
                                          nullptr, out, R, T, bm, bk, M, vec,
                                          stream);
}
