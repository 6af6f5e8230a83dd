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
// 64 x 64 tile occupied, Q = 4096) that is a dense 137.4 GFLOP product:
// >= 2.05 ms at the FP32 FMA peak. On the tensor cores in split TF32
// (bsr_spmm.cu's note: one TF32 rounding misses 1e-4 * max|out|, three
// products hi.hi + hi.lo + lo.hi meet it) it is 412 G TF32 operations,
// 0.83 ms at 495 TFLOP/s (on the nonzeros alone 0.083 ms), beside G's
// rows passing L2 once per block column.
//
// The design (spmm_t_tc_kernel): B1's tensor-core walk (common.cuh:
// tc_walk) with the tile's split pass transposing. One block of 256
// threads per (64-row slice of block column j's bk output rows, 128
// columns of Q (64 where Q <= 64), replica). It walks u < t_nblocks[j] in
// 32-deep units through a 3-stage cp.async ring: 32 rows of the source
// tile, columns c0 .. c0 + 63 as they lie in memory (the tile row is the
// contraction index), and the matching 32 rows of G. The split pass writes
// the slice hi and lo K-major (each tile column's 32 values contiguous),
// as wgmma's B operand; G's rows are wgmma's A, loaded into registers and
// split there; the products are G^T . tile. An entry's sums are added into
// f32 sums after its last unit. A block column without tiles writes
// exactly 0 (the output is torch.empty). Any bm, bk works; edges are
// zero-filled. No atomics.
//
// Compressed (B13b): also replaces sputnik_tpu/ops/pallas/bsr_compressed.py:
// bsr_spmm_t_panel_c. The panel is the true-BSR layout values[R, T, bm, bk]
// (blocking.CompressedView); CompressedView.transpose_meta names block
// column j's tiles by global tile id, t_gblk[j * max_bpc + u], and their
// row blocks, t_rows[j * max_bpc + u]. Padded slots (u >= t_nblocks[j])
// repeat the last pair or name the dump tile, and are never visited. The
// body is the same; only the address policy (EllCols, CompressedCols
// below) differs, so B3, B8 and B13b are one template.
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

// out rows c0 .. c0 + 63 (blockIdx.y % slices) of block column j =
// blockIdx.y / slices x BN = 64 * WG columns of Q (blockIdx.x), replica
// blockIdx.z, in split TF32 on the tensor cores (common.cuh: tc_walk, its
// split pass transposing). The column's walk entries pass in TC_BK-deep
// units (ceil(bm / TC_BK) an entry): TC_BK rows of the source tile, its
// columns c0 .. c0 + 63 as they lie ([k][m]: the tile row is the
// contraction index), and the matching TC_BK rows of G ([k][n]). a_vec /
// b_vec: the tile / G rows can be staged in 16-byte pieces.
template <typename Cols, int WG>
__global__ void __launch_bounds__(128 * WG, 2)
spmm_t_tc_kernel(Cols cols, const float* __restrict__ panel,
                 const float* __restrict__ g, float* __restrict__ out, int bm,
                 int bk, int M, int Q, int rows, int a_vec, int b_vec) {
  constexpr int NTHREADS = 128 * WG, BN = 64 * WG, LDB = tc_ldb(WG);
  constexpr int BG = BN / 4;
  extern __shared__ __align__(1024) float smem[];
  float* const As = smem + 4 * TC_SB;            // [TC_STAGES][TC_A]
  float* const Bs = As + TC_STAGES * TC_A;       // [TC_STAGES][TC_BK * LDB]
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * BN;
  const int slices = (bk + TILE - 1) / TILE;
  const int j = blockIdx.y / slices;
  const int c0 = (blockIdx.y % slices) * TILE;  // first tile column here
  const int r = blockIdx.z;
  const size_t tile_elems = (size_t)bm * bk;
  const float* pan = panel + (size_t)r * cols.tiles() * tile_elems;
  const float* G = g + (size_t)r * M * Q;
  const int chunks = (bm + TC_BK - 1) / TC_BK;
  const int nb = cols.count(r, j);
  const int units = nb * chunks;

  // stage unit (entry lu, piece ld) into the next raw stage; one commit a
  // call
  int lu = 0, ld = 0, lst = 0;
  auto load_next = [&]() {
    if (lu < nb) {
      const ColSrc src = cols.src(r, j, lu);
      const int k0 = ld * TC_BK;
      const float* a_tile = pan + (size_t)src.tile * tile_elems;
      float* as = As + lst * TC_A;
      float* bs = Bs + lst * (TC_BK * LDB);
#pragma unroll
      for (int q = 0; q < TILE * TC_BK / 4 / NTHREADS; ++q) {
        const int e = tid + q * NTHREADS, k = e >> 4, mg = (e & 15) * 4;
        const int gk = k0 + k;
        tc_stage4(as + k * TC_LDAT + mg, a_tile + (size_t)gk * bk + c0 + mg,
                  panel, gk < bm, c0 + mg, bk, a_vec);
      }
#pragma unroll
      for (int q = 0; q < TC_BK * BG / NTHREADS; ++q) {
        const int e = tid + q * NTHREADS, k = e / BG, ng = (e % BG) * 4;
        const int gk = k0 + k, grow = src.row_block * bm + gk;
        tc_stage4(bs + k * LDB + ng, G + (size_t)grow * Q + n0 + ng, g,
                  gk < bm && grow < M, n0 + ng, Q, b_vec);
      }
      lst = lst + 1 == TC_STAGES ? 0 : lst + 1;
      if (++ld == chunks) {
        ld = 0;
        ++lu;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float facc[32];
  tc_walk<true, WG>(units, chunks, load_next, smem, facc);

  // acc[4i + e]: tile column c0 + 8i + 2t + (e & 1), column
  // n0 + 64 wg + 16w + gq + 8 (e >> 1) of Q
  const int lane = tid & 31, w = (tid >> 5) & 3, gq = lane >> 2, t = lane & 3;
  float* const o = out + (size_t)r * rows * Q;
  const int q0 = n0 + wg * 64 + w * 16 + gq;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = c0 + 8 * i + 2 * t + h, grow = j * bk + col;
      if (col >= bk || grow >= rows) continue;
      float* orow = o + (size_t)grow * Q;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = q0 + 8 * c;
        if (q < Q) orow[q] = facc[4 * i + 2 * c + h];
      }
    }
}

// kb block columns, each cut into 64-row slices of its bk output rows; 128
// columns of Q a block, 64 where Q <= 64.
template <typename Cols, int WG>
int launch_spmm_t_wg(Cols cols, const void* panel, const void* g, void* out,
                     int R, int kb, int bm, int bk, int M, int Q, int rows,
                     void* stream) {
  const int slices = (bk + TILE - 1) / TILE;
  dim3 grid((Q + 64 * WG - 1) / (64 * WG), kb * slices, R);
  const size_t smem = tc_smem(WG);
  const int err = set_smem(spmm_t_tc_kernel<Cols, WG>, smem);
  if (err) return err;
  const int a_vec = bk % 4 == 0 && (uintptr_t)panel % 16 == 0;
  const int b_vec = Q % 4 == 0 && (uintptr_t)g % 16 == 0;
  spmm_t_tc_kernel<Cols, WG><<<grid, 128 * WG, smem, (cudaStream_t)stream>>>(
      cols, (const float*)panel, (const float*)g, (float*)out, bm, bk, M, Q,
      rows, a_vec, b_vec);
  return (int)cudaGetLastError();
}

template <typename Cols>
int launch_spmm_t(Cols cols, const void* panel, const void* g, void* out,
                  int R, int kb, int bm, int bk, int M, int Q, int rows,
                  void* stream) {
  return Q > 64 ? launch_spmm_t_wg<Cols, 2>(cols, panel, g, out, R, kb, bm,
                                            bk, M, Q, rows, stream)
                : launch_spmm_t_wg<Cols, 1>(cols, panel, g, out, R, kb, bm,
                                            bk, M, Q, rows, stream);
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
