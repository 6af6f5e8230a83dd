// Transposed panel SpMM: out[r] = A_panel[r]^T @ G[r], straight off the
// ORIGINAL panel (no transposed panel is ever built).
//
// Replaces two TPU kernels: sputnik_tpu/ops/pallas/bsr_spmm_t.py:
// bsr_spmm_t_panel (B3, one topology for every replica) and
// sputnik_tpu/ops/batched_panel.py:_k_spmm_t_bh (B8, the many-mask batch).
// The panel is values[R, mb, max_bpr, bm, bk] (blocking.BlockView); the
// transposed topology is block metadata only (BlockView.transpose_meta):
// block column j holds t_nblocks[j] tiles, the u-th being panel tile
// (t_src_i[j * max_bpc + u], t_src_s[j * max_bpc + u]). Replica r reads the
// metadata of mask r / heads (stacked per mask: t_src_i / t_src_s
// [B, kb * max_bpc], t_nblocks [B, kb]); B3 is the case heads = R. Padded
// slots (u >= t_nblocks[j]) repeat the last valid source and are never
// visited, or that tile would be added twice. G is [R, M, Q] (M <= mb * bm),
// the output [R, rows, Q] with rows <= kb * bk. It is the d_dense of spmm
// and the d_rhs of sddmm, so it runs in every backward of the panel ops
// (B8: the MoE bank's input gradient, the panel attention's dv and dk).
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
//
// Compressed (B13b): also replaces sputnik_tpu/ops/pallas/bsr_compressed.py:
// bsr_spmm_t_panel_c. The panel is the true-BSR layout values[R, T, bm, bk]
// (blocking.CompressedView); CompressedView.transpose_meta names block
// column j's tiles by global tile id, t_gblk[j * max_bpc + u], and their
// row blocks, t_rows[j * max_bpc + u]. Padded slots (u >= t_nblocks[j])
// repeat the last pair or name the dump tile, and are never visited. The
// body is the same; only the address policy (EllCols, CompressedCols
// below) differs, so B3 and B8 compile to what they were.
#include "common.cuh"

namespace stt {

// Block column j of replica r holds count(r, j) tiles; the u-th is panel
// tile `tile` (counted from the replica's panel) of row block `row_block`.
struct ColSrc {
  int tile;
  int row_block;
};

struct EllCols {  // B3 / B8: (row block, slot) pairs of the ELL panel
  const int* t_src_i;    // [B, kb * max_bpc]
  const int* t_src_s;    // [B, kb * max_bpc]
  const int* t_nblocks;  // [B, kb]
  int heads, kb, max_bpc, max_bpr, mb;
  __device__ size_t tiles() const { return (size_t)mb * max_bpr; }
  __device__ int count(int r, int j) const {
    return t_nblocks[(size_t)(r / heads) * kb + j];
  }
  __device__ ColSrc src(int r, int j, int u) const {
    const size_t at = (size_t)(r / heads) * kb * max_bpc + j * max_bpc + u;
    const int i = t_src_i[at];
    return {i * max_bpr + t_src_s[at], i};
  }
};

struct CompressedCols {  // B13b: global tile ids of the compressed panel
  const int* t_gblk;     // [kb * max_bpc]
  const int* t_rows;     // [kb * max_bpc]
  const int* t_nblocks;  // [kb]
  int max_bpc, n_tiles;
  __device__ size_t tiles() const { return (size_t)n_tiles; }
  __device__ int count(int, int j) const { return t_nblocks[j]; }
  __device__ ColSrc src(int, int j, int u) const {
    return {t_gblk[j * max_bpc + u], t_rows[j * max_bpc + u]};
  }
};

template <typename Cols>
__global__ void __launch_bounds__(THREADS)
spmm_t_panel_kernel(Cols cols, const float* __restrict__ panel,
                    const float* __restrict__ g, float* __restrict__ out,
                    int bm, int bk, int M, int Q, int rows) {
  __shared__ __align__(16) float As[TK][TILE_LD];
  __shared__ __align__(16) float Bs[TK][TILE_LD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TILE;
  const int slices = (bk + TILE - 1) / TILE;
  const int j = blockIdx.y / slices;
  const int c0 = (blockIdx.y % slices) * TILE;  // first tile column here
  const int r = blockIdx.z;
  const size_t tile_elems = (size_t)bm * bk;
  const float* pan = panel + (size_t)r * cols.tiles() * tile_elems;
  const float* G = g + (size_t)r * M * Q;

  float acc[4][4] = {};
  const int nb = cols.count(r, j);
  for (int u = 0; u < nb; ++u) {
    const ColSrc src = cols.src(r, j, u);
    const int i = src.row_block;
    const float* a_tile = pan + (size_t)src.tile * tile_elems;
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

template <typename Cols>
int launch_spmm_t(Cols cols, const void* panel, const void* g, void* out,
                  int R, int kb, int bm, int bk, int M, int Q, int rows,
                  void* stream) {
  const int slices = (bk + TILE - 1) / TILE;
  dim3 grid((Q + TILE - 1) / TILE, kb * slices, R);
  spmm_t_panel_kernel<Cols><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      cols, (const float*)panel, (const float*)g, (float*)out, bm, bk, M, Q,
      rows);
  return (int)cudaGetLastError();
}

}  // namespace stt

// panel [R, mb, max_bpr, bm, bk], g [R, M, Q], out [R, rows, Q];
// t_src_i / t_src_s [kb * max_bpc], t_nblocks [kb]; rows <= kb * bk.
extern "C" int spmm_t_panel_f32(const void* t_src_i, const void* t_src_s,
                                const void* t_nblocks, const void* panel,
                                const void* g, void* out, int R, int mb,
                                int max_bpr, int kb, int max_bpc, int bm,
                                int bk, int M, int Q, int rows, void* stream) {
  return stt::launch_spmm_t(
      stt::EllCols{(const int*)t_src_i, (const int*)t_src_s,
                   (const int*)t_nblocks, R, kb, max_bpc, max_bpr, mb},
      panel, g, out, R, kb, bm, bk, M, Q, rows, stream);
}

// The many-mask batch (B8): t_src_i / t_src_s [B, kb * max_bpc], t_nblocks
// [B, kb]; replica r reads mask r / heads.
extern "C" int spmm_t_bh_f32(const void* t_src_i, const void* t_src_s,
                             const void* t_nblocks, const void* panel,
                             const void* g, void* out, int R, int heads,
                             int mb, int max_bpr, int kb, int max_bpc, int bm,
                             int bk, int M, int Q, int rows, void* stream) {
  return stt::launch_spmm_t(
      stt::EllCols{(const int*)t_src_i, (const int*)t_src_s,
                   (const int*)t_nblocks, heads, kb, max_bpc, max_bpr, mb},
      panel, g, out, R, kb, bm, bk, M, Q, rows, stream);
}

// The compressed panel (B13b): t_gblk / t_rows [kb * max_bpc], t_nblocks
// [kb], panel [R, T, bm, bk] (T = num_blocks + 1), g [R, M, Q],
// out [R, rows, Q]; rows <= kb * bk.
extern "C" int spmm_t_panel_c_f32(const void* t_gblk, const void* t_rows,
                                  const void* t_nblocks, const void* panel,
                                  const void* g, void* out, int R, int T,
                                  int kb, int max_bpc, int bm, int bk, int M,
                                  int Q, int rows, void* stream) {
  return stt::launch_spmm_t(
      stt::CompressedCols{(const int*)t_gblk, (const int*)t_rows,
                          (const int*)t_nblocks, max_bpc, T},
      panel, g, out, R, kb, bm, bk, M, Q, rows, stream);
}
