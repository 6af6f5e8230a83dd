// Transposed panel SpMM: out[r] = A_panel[r]^T @ G[r], straight off the
// ORIGINAL panel (no transposed panel is ever built).
//
// Replaces the TPU kernel
// sputnik_tpu/ops/pallas/bsr_spmm_t.py:bsr_spmm_t_panel. The panel is
// values[R, mb, max_bpr, bm, bk] (blocking.BlockView); the transposed
// topology is block metadata only (BlockView.transpose_meta): block column
// j holds t_nblocks[j] tiles, the u-th being panel tile
// (t_src_i[j * max_bpc + u], t_src_s[j * max_bpc + u]). Padded slots
// (u >= t_nblocks[j]) repeat the last valid source and are never visited,
// or that tile would be added twice. G is [R, M, Q] (M <= mb * bm), the
// output [R, rows, Q] with rows <= kb * bk. It is the d_dense of spmm and
// the d_rhs of sddmm, so it runs in every backward of the panel ops.
//
// What bounds it on an H100: the same work as the forward SpMM (B1) with
// the tile transposed: 2 * bm * bk * Q FLOPs per occupied tile against one
// tile read and bm rows of G. At the SpMM headline (4096^2, d = 0.1, every
// 64 x 64 tile occupied, Q = 4096) that is a dense 137 GFLOP product:
// compute-bound at the FP32 FMA peak (67 TFLOP/s), so >= 2 ms.
//
// The simple design: one block of 256 threads per (64-row slice of block
// column j's bk output rows, 64-column tile of Q, replica). It walks
// u < t_nblocks[j], stages a 32-deep slice of the source tile - its row
// index is the contraction index, its column index the output row, so the
// transpose is free: the slice is stored k-major exactly as common.cuh
// wants it - and the matching 32 rows of G, and accumulates 4 x 4 outputs
// per thread in registers. A block column without tiles writes exactly 0
// (the output is torch.empty). Any bm, bk works; edges are bound-checked.
#include "common.cuh"

namespace stt {

__global__ void __launch_bounds__(THREADS)
spmm_t_panel_kernel(const int* __restrict__ t_src_i,
                    const int* __restrict__ t_src_s,
                    const int* __restrict__ t_nblocks,
                    const float* __restrict__ panel,
                    const float* __restrict__ g, float* __restrict__ out,
                    int mb, int max_bpr, int max_bpc, int bm, int bk, int M,
                    int Q, int rows) {
  __shared__ __align__(16) float As[TK][TILE_LD];
  __shared__ __align__(16) float Bs[TK][TILE_LD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TILE;
  const int slices = (bk + TILE - 1) / TILE;
  const int j = blockIdx.y / slices;
  const int c0 = (blockIdx.y % slices) * TILE;  // first tile column here
  const int r = blockIdx.z;
  const size_t tile_elems = (size_t)bm * bk;
  const float* pan = panel + (size_t)r * mb * max_bpr * tile_elems;
  const float* G = g + (size_t)r * M * Q;

  float acc[4][4] = {};
  const int nb = t_nblocks[j];
  for (int u = 0; u < nb; ++u) {
    const int i = t_src_i[j * max_bpc + u];
    const int s = t_src_s[j * max_bpc + u];
    const float* a_tile = pan + ((size_t)i * max_bpr + s) * tile_elems;
    for (int k0 = 0; k0 < bm; k0 += TK) {
      for (int e = tid; e < TILE * TK; e += THREADS) {
        const int k = e / TILE, col = e % TILE;  // coalesced along the tile row
        const int gk = k0 + k, gc = c0 + col;
        As[k][col] = (gk < bm && gc < bk) ? a_tile[(size_t)gk * bk + gc] : 0.f;
      }
      for (int e = tid; e < TILE * TK; e += THREADS) {
        const int k = e / TILE, col = e % TILE;  // coalesced along Q
        const int gk = k0 + k, grow = i * bm + gk, gq = n0 + col;
        Bs[k][col] = (gk < bm && grow < M && gq < Q)
                         ? G[(size_t)grow * Q + gq] : 0.f;
      }
      __syncthreads();
      tile_fma<TK>(As, Bs, ty, tx, acc);
      __syncthreads();
    }
  }

  float* o = out + (size_t)r * rows * Q;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int col = c0 + ty * 4 + ii, grow = j * bk + col;
    if (col >= bk || grow >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gq = n0 + tx * 4 + jj;
      if (gq < Q) o[(size_t)grow * Q + gq] = acc[ii][jj];
    }
  }
}

}  // namespace stt

// panel [R, mb, max_bpr, bm, bk], g [R, M, Q], out [R, rows, Q];
// t_src_i / t_src_s [kb * max_bpc], t_nblocks [kb]; rows <= kb * bk.
extern "C" int spmm_t_panel_f32(const void* t_src_i, const void* t_src_s,
                                const void* t_nblocks, const void* panel,
                                const void* g, void* out, int R, int mb,
                                int max_bpr, int kb, int max_bpc, int bm,
                                int bk, int M, int Q, int rows, void* stream) {
  const int slices = (bk + stt::TILE - 1) / stt::TILE;
  dim3 grid((Q + stt::TILE - 1) / stt::TILE, kb * slices, R);
  stt::spmm_t_panel_kernel<<<grid, stt::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)t_src_i, (const int*)t_src_s, (const int*)t_nblocks,
      (const float*)panel, (const float*)g, (float*)out, mb, max_bpr, max_bpc,
      bm, bk, M, Q, rows);
  return (int)cudaGetLastError();
}
