// The compressed panel's sparse softmax, in two kernels: the row statistics
// (B15a) and the normalisation (B15b).
//
// Replaces the TPU kernels sputnik_tpu/ops/pallas/bsr_compressed.py:
// c_softmax_stats and c_softmax_apply. The panel is the true-BSR layout
// values[R, T, bm, bk] (blocking.CompressedView, T = num_blocks + 1, the
// last tile a dump): row block i owns tiles block_offsets[i] ..
// block_offsets[i + 1], so a row's nonzeros are ragged across back-to-back
// tiles and the softmax is a segment reduction over the tile -> row-block
// map. mask[T, bm, bk] is 1 at the nonzeros (0 everywhere in the dump).
//
// Semantics, as the TPU kernels run them: B15a folds each of the row
// block's tiles into a running max and denominator per row, masked
// elements scoring -1e30: m_new = max(m, tile max), l = l * exp(m - m_new)
// + sum over the tile's nonzeros of exp(v - m_new). A row without nonzeros
// ends at (-1e30, 0). It writes row_max and row_denom [R, mb * bm] (the
// TPU's 128-lane broadcast is a TPU layout and is not carried over). B15b
// writes exp(v - m[row]) / max(l[row], 1e-30) at the nonzeros and an exact
// 0 at every other slot, the dump tile included, so no slot of the output
// is undefined. expf and a true divide (no __expf), so the kernels and
// their plain versions agree slot by slot.
//
// What bounds them on an H100: bytes. B15a reads the scores and the mask
// once, B15b reads them again and writes the probabilities, for a handful
// of operations a slot (max, exp, sum; exp, divide).
//
// The simple design: B15a runs one warp per (replica, row), eight warps a
// block; the warp reads its row's bk-wide segment of each tile of the row
// block (coalesced), reduces the tile max and the tile sum with shuffles
// and keeps m and l in registers; the second read of a segment hits L1.
// B15b runs one block of 256 threads per (tile, replica), each thread a
// strided run of the tile's bm * bk slots.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace stt_csoftmax {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_LARGE = -1e30f;  // the TPU kernel's masked score
constexpr float MIN_DENOM = 1e-30f;  // the TPU kernel's denominator floor

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
c_softmax_stats_kernel(const int* __restrict__ block_offsets,
                       const float* __restrict__ panel,
                       const float* __restrict__ mask,
                       float* __restrict__ row_max,
                       float* __restrict__ row_denom, int mb, int T, int bm,
                       int bk, long long n_warps) {
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= n_warps) return;
  const long long rows = (long long)mb * bm;
  const int r = (int)(w / rows);
  const int row = (int)(w % rows);
  const int i = row / bm, ri = row % bm;
  const float* pan = panel + (size_t)r * T * bm * bk;

  float m = NEG_LARGE, l = 0.f;
  const int end = block_offsets[i + 1];
  for (int g = block_offsets[i]; g < end; ++g) {
    const size_t at = ((size_t)g * bm + ri) * bk;
    const float* v = pan + at;
    const float* mk = mask + at;
    float tmax = NEG_LARGE;
    for (int e = lane; e < bk; e += 32)
      tmax = fmaxf(tmax, mk[e] != 0.f ? v[e] : NEG_LARGE);
    const float m_new = fmaxf(m, warp_max(tmax));
    float p = 0.f;
    for (int e = lane; e < bk; e += 32)
      if (mk[e] != 0.f) p += expf(v[e] - m_new);
    l = l * expf(m - m_new) + warp_sum(p);
    m = m_new;
  }
  if (lane == 0) {
    row_max[w] = m;
    row_denom[w] = l;
  }
}

__global__ void __launch_bounds__(THREADS)
c_softmax_apply_kernel(const int* __restrict__ block_rows,
                       const float* __restrict__ panel,
                       const float* __restrict__ mask,
                       const float* __restrict__ row_max,
                       const float* __restrict__ row_denom,
                       float* __restrict__ out, int T, int bm, int bk,
                       int M) {
  const int g = blockIdx.x, r = blockIdx.y;
  const size_t tile = (size_t)bm * bk;
  const size_t at = ((size_t)r * T + g) * tile;
  const float* v = panel + at;
  const float* mk = mask + (size_t)g * tile;
  float* o = out + at;
  const bool live = g < T - 1;  // the last tile is the dump
  const int row0 = live ? block_rows[g] * bm : 0;
  const float* mr = row_max + (size_t)r * M;
  const float* lr = row_denom + (size_t)r * M;
  for (size_t e = threadIdx.x; e < tile; e += THREADS) {
    const int row = row0 + (int)(e / bk);
    float y = 0.f;
    if (live && mk[e] != 0.f && row < M)
      y = expf(v[e] - mr[row]) / fmaxf(lr[row], MIN_DENOM);
    o[e] = y;
  }
}

}  // namespace stt_csoftmax

// B15a: block_offsets i32 [mb + 1], panel f32 [R, T, bm, bk], mask f32
// [T, bm, bk] -> row_max, row_denom f32 [R, mb * bm].
extern "C" int c_softmax_stats_f32(const void* block_offsets,
                                   const void* panel, const void* mask,
                                   void* row_max, void* row_denom, int R,
                                   int mb, int T, int bm, int bk,
                                   void* stream) {
  using namespace stt_csoftmax;
  const long long n_warps = (long long)R * mb * bm;
  const long long blocks = (n_warps + WARPS - 1) / WARPS;
  if (blocks <= 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  c_softmax_stats_kernel<<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const int*)block_offsets, (const float*)panel, (const float*)mask,
      (float*)row_max, (float*)row_denom, mb, T, bm, bk, n_warps);
  return (int)cudaGetLastError();
}

// B15b: block_rows i32 [T], panel f32 [R, T, bm, bk], mask f32 [T, bm, bk],
// row_max / row_denom f32 [R, M] -> out f32 [R, T, bm, bk].
extern "C" int c_softmax_apply_f32(const void* block_rows, const void* panel,
                                   const void* mask, const void* row_max,
                                   const void* row_denom, void* out, int R,
                                   int T, int bm, int bk, int M,
                                   void* stream) {
  using namespace stt_csoftmax;
  if (T <= 0 || R <= 0) return 0;
  dim3 grid(T, R);
  c_softmax_apply_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)block_rows, (const float*)panel, (const float*)mask,
      (const float*)row_max, (const float*)row_denom, (float*)out, T, bm, bk,
      M);
  return (int)cudaGetLastError();
}
