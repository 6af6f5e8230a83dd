// Panel SDDMM: out[r, i, s] = (lhs[r] @ rhs[r]^T)[tile (i, block_cols[i, s])]
// times the tile's element mask, written into the block panel.
//
// Replaces the TPU kernel sputnik_tpu/ops/pallas/bsr_sddmm.py:bsr_sddmm_panel.
// lhs is [R, M, D], rhs [R, Nr, D] (stored row-major, the transpose is fused
// in the contraction), mask [mb, max_bpr, bm, bk] shared by all replicas.
//
// What bounds it on an H100: each occupied 64 x 64 tile reads 2 x 64 x D
// operand floats and writes 64 x 64 results, 2 x 64^2 x D FLOPs. At the
// attention shapes (D = 64) that is 8 FLOP per byte moved through L2 and
// the panel write dominates device-memory traffic: memory-bound.
//
// The simple design: one block of 256 threads per (64 x 64 slice of a tile,
// slot (i, s), replica). Slots s >= nblocks[i] and masked elements are
// written as EXACT zeros - the panel convention every consumer relies on (a
// consumer multiplies whole tiles). Otherwise the block stages 32-deep
// slices of the lhs rows and of the rhs rows of block column
// block_cols[i, s] in shared memory and accumulates 4 x 4 outputs per
// thread (common.cuh), then applies the mask once and writes the slice.
#include "common.cuh"

namespace stt {

__global__ void __launch_bounds__(THREADS)
sddmm_panel_kernel(const int* __restrict__ block_cols,
                   const int* __restrict__ nblocks,
                   const float* __restrict__ lhs,
                   const float* __restrict__ rhs,
                   const float* __restrict__ mask, float* __restrict__ out,
                   int mb, int max_bpr, int bm, int bk, int M, int Nr,
                   int D) {
  __shared__ __align__(16) float As[TK][TILE_LD];
  __shared__ __align__(16) float Bs[TK][TILE_LD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int col_slices = (bk + TILE - 1) / TILE;
  const int r0 = (blockIdx.x / col_slices) * TILE;
  const int c0 = (blockIdx.x % col_slices) * TILE;
  const int slot = blockIdx.y;  // i * max_bpr + s
  const int i = slot / max_bpr, s = slot % max_bpr;
  const int r = blockIdx.z;
  const size_t tile_elems = (size_t)bm * bk;
  float* o = out + ((size_t)r * mb * max_bpr + slot) * tile_elems;

  if (s >= nblocks[i]) {  // padded slot: exact zeros
    for (int e = tid; e < TILE * TILE; e += THREADS) {
      const int row = r0 + e / TILE, col = c0 + e % TILE;
      if (row < bm && col < bk) o[(size_t)row * bk + col] = 0.f;
    }
    return;
  }
  const int c = block_cols[slot];
  const float* L = lhs + (size_t)r * M * D;
  const float* Rh = rhs + (size_t)r * Nr * D;

  float acc[4][4] = {};
  for (int d0 = 0; d0 < D; d0 += TK) {
    for (int e = tid; e < TILE * TK; e += THREADS) {
      const int row = e / TK, k = e % TK;  // coalesced along d
      const int tr = r0 + row, gr = i * bm + tr, gd = d0 + k;
      As[k][row] = (tr < bm && gr < M && gd < D) ? L[(size_t)gr * D + gd]
                                                 : 0.f;
      const int tc = c0 + row, gc = c * bk + tc;
      Bs[k][row] = (tc < bk && gc < Nr && gd < D) ? Rh[(size_t)gc * D + gd]
                                                  : 0.f;
    }
    __syncthreads();
    tile_fma<TK>(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  const float* mk = mask + (size_t)slot * tile_elems;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = r0 + ty * 4 + ii;
    if (row >= bm) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = c0 + tx * 4 + jj;
      if (col >= bk) continue;
      const size_t e = (size_t)row * bk + col;
      const float m = mk[e];
      o[e] = m != 0.f ? acc[ii][jj] * m : 0.f;
    }
  }
}

}  // namespace stt

// lhs [R, M, D], rhs [R, Nr, D], mask [mb, max_bpr, bm, bk],
// out [R, mb, max_bpr, bm, bk].
extern "C" int sddmm_panel_f32(const void* block_cols, const void* nblocks,
                               const void* lhs, const void* rhs,
                               const void* mask, void* out, int R, int mb,
                               int max_bpr, int bm, int bk, int M, int Nr,
                               int D, void* stream) {
  const int slices = ((bm + stt::TILE - 1) / stt::TILE) *
                     ((bk + stt::TILE - 1) / stt::TILE);
  dim3 grid(slices, mb * max_bpr, R);
  stt::sddmm_panel_kernel<<<grid, stt::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)block_cols, (const int*)nblocks, (const float*)lhs,
      (const float*)rhs, (const float*)mask, (float*)out, mb, max_bpr, bm,
      bk, M, Nr, D);
  return (int)cudaGetLastError();
}
