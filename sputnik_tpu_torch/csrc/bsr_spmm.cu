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
//
// Compressed (B13a): also replaces sputnik_tpu/ops/pallas/bsr_compressed.py:
// bsr_spmm_panel_c. The panel is the true-BSR layout values[R, T, bm, bk]
// (blocking.CompressedView, T = num_blocks + 1 with a dump tile last):
// row block i walks s < block_offsets[i + 1] - block_offsets[i], its tile
// is values[block_offsets[i] + s] and its block column
// block_cols[block_offsets[i] + s]. The body is the same; only the address
// policy (EllRows, CompressedRows below) differs, so B1 and B6 compile to
// what they were. The compressed softmax backward also runs it for its
// ragged row sums (dense = a ones column). Its bound is B1's on the tiles
// it stores: no padded tiles exist to skip.
//
// Slot-selected (B2): also replaces sputnik_tpu/ops/pallas/bsr_spmm.py:
// bsr_spmm_panel_sel, B1 over a SUBSET of each row block's tiles. The panel
// keeps B1's layout values[mb, max_bpr_full, bm, bk]; row block i walks
// s < nblocks[i] entries of a sub-walk of max_bpr slots, the s-th being
// panel slot slot_sel[i * max_bpr + s] in block column
// block_cols[i * max_bpr + s] (SelRows below). The result holds only the
// subset's share. Its one caller is the interior / halo split of the
// sequence-parallel halo SpMM (parallel/sharded_ops.py), which runs it
// twice a shard, on the local dense shard and on the halo rows, and sums
// the two. Its bound is B1's on the selected tiles.
#include "common.cuh"

namespace stt {

// The tiles of row block i of replica r: `count` of them, the s-th being
// panel tile `first + s` (or `first + slots[s]` where a sub-walk selects
// the slots), counted from the replica's panel, in block column cols[s].
struct RowWalk {
  const int* cols;
  int first;
  int count;
  const int* slots;  // null: the walk visits the row block's tiles in order
  __device__ int tile(int s) const { return first + (slots ? slots[s] : s); }
};

struct EllRows {  // B1 / B6: row block i owns slots i * max_bpr + s
  const int* block_cols;  // [B, mb * max_bpr]
  const int* nblocks;     // [B, mb]
  int heads, mb, max_bpr;
  __device__ size_t tiles() const { return (size_t)mb * max_bpr; }
  __device__ RowWalk row(int r, int i) const {
    const int mask_id = r / heads;  // this replica's mask
    const int first = i * max_bpr;
    return {block_cols + (size_t)mask_id * mb * max_bpr + first, first,
            nblocks[(size_t)mask_id * mb + i], nullptr};
  }
};

struct CompressedRows {  // B13a: row block i owns tiles offs[i] .. offs[i+1]
  const int* block_offsets;  // [mb + 1]
  const int* block_cols;     // [T]
  int n_tiles;               // T = num_blocks + 1
  __device__ size_t tiles() const { return (size_t)n_tiles; }
  __device__ RowWalk row(int, int i) const {
    const int first = block_offsets[i];
    return {block_cols + first, first, block_offsets[i + 1] - first, nullptr};
  }
};

struct SelRows {  // B2: row block i walks slot_sel[i * max_bpr + s]
  const int* block_cols;  // [mb * max_bpr] (the sub-walk's)
  const int* nblocks;     // [mb]
  const int* slot_sel;    // [mb * max_bpr] panel slot of each entry
  int mb, max_bpr, max_bpr_full;
  __device__ size_t tiles() const { return (size_t)mb * max_bpr_full; }
  __device__ RowWalk row(int, int i) const {
    const size_t at = (size_t)i * max_bpr;
    return {block_cols + at, i * max_bpr_full, nblocks[i], slot_sel + at};
  }
};

template <typename Rows>
__global__ void __launch_bounds__(THREADS)
spmm_panel_kernel(Rows rows, const float* __restrict__ panel,
                  const float* __restrict__ dense,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int bm, int bk, int K, int N, int M, int epilogue) {
  __shared__ __align__(16) float As[TK][TILE_LD];
  __shared__ __align__(16) float Bs[TK][TILE_LD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TILE;
  const int slices = (bm + TILE - 1) / TILE;
  const int i = blockIdx.y / slices;
  const int r0 = (blockIdx.y % slices) * TILE;
  const int r = blockIdx.z;
  const RowWalk walk = rows.row(r, i);
  const size_t tile_elems = (size_t)bm * bk;
  const float* pan = panel + (size_t)r * rows.tiles() * tile_elems;
  const float* den = dense + (size_t)r * K * N;

  float acc[4][4] = {};
  for (int s = 0; s < walk.count; ++s) {
    const int c = walk.cols[s];
    const float* a_tile = pan + (size_t)walk.tile(s) * tile_elems;
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

template <typename Rows>
int launch_spmm(Rows rows, const void* panel, const void* dense,
                const void* bias, void* out, int R, int mb, int bm, int bk,
                int K, int N, int M, int epilogue, void* stream) {
  const int slices = (bm + TILE - 1) / TILE;
  dim3 grid((N + TILE - 1) / TILE, mb * slices, R);
  spmm_panel_kernel<Rows><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      rows, (const float*)panel, (const float*)dense, (const float*)bias,
      (float*)out, bm, bk, K, N, M, epilogue);
  return (int)cudaGetLastError();
}

}  // namespace stt

// epilogue: 0 none, 1 bias, 2 bias + ReLU. panel [R, mb, max_bpr, bm, bk],
// dense [R, K, N], bias [M], out [R, M, N]; M <= mb * bm rows are written.
extern "C" int spmm_panel_f32(const void* block_cols, const void* nblocks,
                              const void* panel, const void* dense,
                              const void* bias, void* out, int R, int mb,
                              int max_bpr, int bm, int bk, int K, int N,
                              int M, int epilogue, void* stream) {
  return stt::launch_spmm(
      stt::EllRows{(const int*)block_cols, (const int*)nblocks, R, mb,
                   max_bpr},
      panel, dense, bias, out, R, mb, bm, bk, K, N, M, epilogue, stream);
}

// The many-mask batch (B6): block_cols [B, mb * max_bpr], nblocks [B, mb],
// replica r reads mask r / heads (R = B * heads); no epilogue.
extern "C" int spmm_bh_f32(const void* block_cols, const void* nblocks,
                           const void* panel, const void* dense, void* out,
                           int R, int heads, int mb, int max_bpr, int bm,
                           int bk, int K, int N, int M, void* stream) {
  return stt::launch_spmm(
      stt::EllRows{(const int*)block_cols, (const int*)nblocks, heads, mb,
                   max_bpr},
      panel, dense, nullptr, out, R, mb, bm, bk, K, N, M, 0, stream);
}

// The compressed panel (B13a): block_offsets [mb + 1], block_cols [T],
// panel [R, T, bm, bk] (T = num_blocks + 1), dense [R, K, N], bias [M],
// out [R, M, N]; epilogue as spmm_panel_f32.
extern "C" int spmm_panel_c_f32(const void* block_offsets,
                                const void* block_cols, const void* panel,
                                const void* dense, const void* bias,
                                void* out, int R, int mb, int T, int bm,
                                int bk, int K, int N, int M, int epilogue,
                                void* stream) {
  return stt::launch_spmm(
      stt::CompressedRows{(const int*)block_offsets, (const int*)block_cols,
                          T},
      panel, dense, bias, out, R, mb, bm, bk, K, N, M, epilogue, stream);
}

// The slot-selected sub-walk (B2): block_cols / slot_sel [mb * max_bpr],
// nblocks [mb], panel [mb, max_bpr_full, bm, bk], dense [K, N],
// out [M, N]; one replica, no epilogue.
extern "C" int spmm_panel_sel_f32(const void* block_cols,
                                  const void* nblocks, const void* slot_sel,
                                  const void* panel, const void* dense,
                                  void* out, int mb, int max_bpr,
                                  int max_bpr_full, int bm, int bk, int K,
                                  int N, int M, void* stream) {
  return stt::launch_spmm(
      stt::SelRows{(const int*)block_cols, (const int*)nblocks,
                   (const int*)slot_sel, mb, max_bpr, max_bpr_full},
      panel, dense, nullptr, out, 1, mb, bm, bk, K, N, M, 0, stream);
}
