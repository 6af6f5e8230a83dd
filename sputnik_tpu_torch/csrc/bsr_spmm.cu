// Panel SpMM: out[r] = epilogue(A_panel[r] @ dense[r] (+ bias)).
//
// Replaces two TPU kernels: sputnik_tpu/ops/pallas/bsr_spmm.py:
// bsr_spmm_panel (B1, one topology for every replica) and
// sputnik_tpu/ops/batched_panel.py:_k_spmm_bh (B6, the many-mask batch).
// The sparse operand is the block panel values[R, mb, max_bpr, bm, bk]
// (blocking.BlockView); row-block i holds nblocks[i] occupied tiles whose
// block columns are block_cols[i * max_bpr + s]. Replica r reads the block
// metadata of mask r / heads (metadata stacked per mask: block_cols
// [B, mb * max_bpr], nblocks [B, mb]); B1 is the case heads = R, one mask
// for all replicas (SparseAttention's b*heads; R = 1 for SparseLinear). B6
// runs the MoE expert bank (B = 1, heads = experts) and the panel
// attention layout's P @ V (B = batch, one mask per batch element).
//
// What bounds it on an H100: at the repo's headline (4096^2, d = 0.1,
// element-random) every 64 x 64 tile is occupied, so the work is a dense
// 4096^3 product: 137 GFLOP against 64 MB of panel and a 64 MB dense
// operand that each output column tile re-reads once per row block. That
// is compute-bound: FP32 FMA peaks at 67 TFLOP/s, so >= 2 ms.
//
// The simple design: one block of 256 threads per (64-row slice of a row
// block, 64-column output tile, replica). It walks the row block's occupied
// slots s < nblocks[i] (padded slots are never visited), stages a 64 x 32
// slice of the value tile and the 32 x 64 slice of the dense rows the tile's
// block column names in shared memory, and accumulates 4 x 4 outputs per
// thread in registers (common.cuh). The output is written once, with the
// bias / bias+ReLU epilogue applied in registers; a row block without
// occupied tiles writes exactly 0 (+ bias). Any bm, bk works: partial
// slices are zero-filled. wgmma/TMA pipelining is later work.
#include "common.cuh"

namespace stt {

__global__ void __launch_bounds__(THREADS)
spmm_panel_kernel(const int* __restrict__ block_cols,
                  const int* __restrict__ nblocks,
                  const float* __restrict__ panel,
                  const float* __restrict__ dense,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int heads, int mb, int max_bpr, int bm, int bk, int K, int N,
                  int M, int epilogue) {
  __shared__ __align__(16) float As[TK][TILE_LD];
  __shared__ __align__(16) float Bs[TK][TILE_LD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TILE;
  const int slices = (bm + TILE - 1) / TILE;
  const int i = blockIdx.y / slices;
  const int r0 = (blockIdx.y % slices) * TILE;
  const int r = blockIdx.z;
  const int mask_id = r / heads;  // this replica's mask
  block_cols += (size_t)mask_id * mb * max_bpr;
  nblocks += (size_t)mask_id * mb;
  const size_t tile_elems = (size_t)bm * bk;
  const float* pan = panel + (size_t)r * mb * max_bpr * tile_elems;
  const float* den = dense + (size_t)r * K * N;

  float acc[4][4] = {};
  const int nb = nblocks[i];
  for (int s = 0; s < nb; ++s) {
    const int c = block_cols[i * max_bpr + s];
    const float* a_tile = pan + ((size_t)i * max_bpr + s) * tile_elems;
    for (int k0 = 0; k0 < bk; k0 += TK) {
      for (int e = tid; e < TILE * TK; e += THREADS) {
        const int row = e / TK, k = e % TK;  // coalesced along k
        const int gr = r0 + row, gk = k0 + k;
        As[k][row] = (gr < bm && gk < bk) ? a_tile[(size_t)gr * bk + gk] : 0.f;
      }
      for (int e = tid; e < TILE * TK; e += THREADS) {
        const int k = e / TILE, col = e % TILE;  // coalesced along n
        const int gk = k0 + k, grow = c * bk + gk, gc = n0 + col;
        Bs[k][col] = (gk < bk && grow < K && gc < N)
                         ? den[(size_t)grow * N + gc] : 0.f;
      }
      __syncthreads();
      tile_fma<TK>(As, Bs, ty, tx, acc);
      __syncthreads();
    }
  }

  float* o = out + (size_t)r * M * N;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = r0 + ty * 4 + ii, grow = i * bm + row;
    if (row >= bm || grow >= M) continue;
    const float b = epilogue ? bias[grow] : 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gc = n0 + tx * 4 + jj;
      if (gc >= N) continue;
      float v = acc[ii][jj] + b;
      if (epilogue == 2) v = fmaxf(v, 0.f);
      o[(size_t)grow * N + gc] = v;
    }
  }
}

}  // namespace stt

// epilogue: 0 none, 1 bias, 2 bias + ReLU. panel [R, mb, max_bpr, bm, bk],
// dense [R, K, N], bias [M], out [R, M, N]; M <= mb * bm rows are written.
extern "C" int spmm_panel_f32(const void* block_cols, const void* nblocks,
                              const void* panel, const void* dense,
                              const void* bias, void* out, int R, int mb,
                              int max_bpr, int bm, int bk, int K, int N,
                              int M, int epilogue, void* stream) {
  const int slices = (bm + stt::TILE - 1) / stt::TILE;
  dim3 grid((N + stt::TILE - 1) / stt::TILE, mb * slices, R);
  stt::spmm_panel_kernel<<<grid, stt::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)block_cols, (const int*)nblocks, (const float*)panel,
      (const float*)dense, (const float*)bias, (float*)out, R, mb, max_bpr,
      bm, bk, K, N, M, epilogue);
  return (int)cudaGetLastError();
}

// The many-mask batch (B6): block_cols [B, mb * max_bpr], nblocks [B, mb],
// replica r reads mask r / heads (R = B * heads); no epilogue.
extern "C" int spmm_bh_f32(const void* block_cols, const void* nblocks,
                           const void* panel, const void* dense, void* out,
                           int R, int heads, int mb, int max_bpr, int bm,
                           int bk, int K, int N, int M, void* stream) {
  const int slices = (bm + stt::TILE - 1) / stt::TILE;
  dim3 grid((N + stt::TILE - 1) / stt::TILE, mb * slices, R);
  stt::spmm_panel_kernel<<<grid, stt::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)block_cols, (const int*)nblocks, (const float*)panel,
      (const float*)dense, nullptr, (float*)out, heads, mb, max_bpr, bm, bk,
      K, N, M, 0);
  return (int)cudaGetLastError();
}
