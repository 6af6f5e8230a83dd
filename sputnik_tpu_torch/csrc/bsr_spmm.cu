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
// row block i owns tiles block_offsets[i] .. block_offsets[i + 1] - 1, the
// s-th in block column block_cols[block_offsets[i] + s]. The body is B1's
// on another address policy (CompressedChunks below), so B1 and B6 compile
// to what they were. The compressed softmax backward also runs it for its
// ragged row sums (dense = a ones column). Its bound is B1's on the tiles
// it stores: no padded tiles exist to skip.
//
// Split walk. A skewed pattern (a band plus a few dense rows) gives a few
// row blocks all the tiles, and at a narrow width one block per row block
// is fewer blocks than the card has SMs: the dense row blocks' serial
// walks then set the time (at width 64 on the 4096^2 skewed pattern, 64
// blocks, three of them walking 64 tiles). So the walk is cut into chunks
// of at most C tiles, chosen on the host (ops/kernels/bsr_compressed.py:
// split_plan, split_chunk) so that the grid reaches a few waves of the
// SMs; where one block per row block already fills the card (width 4096)
// C covers every row block whole, no row block is cut, and the call runs
// the unsplit walk (CompressedRows: one block per row block, one launch).
// Else a block runs the tile loop over its chunk only (CompressedChunks).
// A row block with one chunk (an empty one included: exactly 0 + bias)
// writes its output with the epilogue; a split one writes f32 partials
// [R, parts, bm, N], and a second launch in the same call
// (spmm_merge_kernel) sums each split row block's partials in chunk order
// and applies the epilogue once. No atomics: the result is the same bits
// run to run. No chunk visits the dump tile: chunks lie inside
// [block_offsets[i], block_offsets[i + 1]).

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

// The tiles that one block walks for row block `block` of replica r:
// `count` of them, the s-th being panel tile `first + s` (or
// `first + slots[s]` where a sub-walk selects the slots), counted from the
// replica's panel, in block column cols[s].
struct RowWalk {
  const int* cols;
  int first;
  int count;
  const int* slots;  // null: the walk visits the row block's tiles in order
  int block;         // the row block whose output rows the walk computes
  int part;          // >= 0: one chunk of a split row block, written to
                     // partial slot `part`; -1: written out (epilogue)
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
            nblocks[(size_t)mask_id * mb + i], nullptr, i, -1};
  }
};

struct CompressedRows {  // B13a unsplit: row block i, tiles offs[i] ...
  const int* block_offsets;  // [mb + 1]
  const int* block_cols;     // [T]
  int n_tiles;               // T = num_blocks + 1
  __device__ size_t tiles() const { return (size_t)n_tiles; }
  __device__ RowWalk row(int, int i) const {
    const int first = block_offsets[i];
    return {block_cols + first, first, block_offsets[i + 1] - first, nullptr,
            i, -1};
  }
};

struct CompressedChunks {  // B13a split: walk c is chunk c of the plan
  const int* chunks;      // [n_chunks, 4]: row block, first tile, tile
                          // count, partial slot (-1: the row block's only
                          // chunk)
  const int* block_cols;  // [T]
  int n_tiles;            // T = num_blocks + 1
  __device__ size_t tiles() const { return (size_t)n_tiles; }
  __device__ RowWalk row(int, int c) const {
    const int* ch = chunks + 4 * (size_t)c;
    return {block_cols + ch[1], ch[1], ch[2], nullptr, ch[0], ch[3]};
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
    return {block_cols + at, i * max_bpr_full, nblocks[i], slot_sel + at, i,
            -1};
  }
};

template <typename Rows>
__global__ void __launch_bounds__(THREADS)
spmm_panel_kernel(Rows rows, const float* __restrict__ panel,
                  const float* __restrict__ dense,
                  const float* __restrict__ bias, float* __restrict__ out,
                  float* __restrict__ partials, int n_parts, int bm, int bk,
                  int K, int N, int M, int epilogue) {
  __shared__ __align__(16) float As[TK][TILE_LD];
  __shared__ __align__(16) float Bs[TK][TILE_LD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TILE;
  const int slices = (bm + TILE - 1) / TILE;
  const int r0 = (blockIdx.y % slices) * TILE;
  const int r = blockIdx.z;
  const RowWalk walk = rows.row(r, blockIdx.y / slices);
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

  if (walk.part >= 0) {  // a chunk of a split row block: its partial sum
    float* p = partials + ((size_t)r * n_parts + walk.part) * bm * N;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int row = r0 + ty * 4 + ii;
      if (row >= bm) continue;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int gc = n0 + tx * 4 + jj;
        if (gc < N) p[(size_t)row * N + gc] = acc[ii][jj];
      }
    }
    return;
  }
  float* o = out + (size_t)r * M * N;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = r0 + ty * 4 + ii, grow = walk.block * bm + row;
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

// B13a's second pass: row block split_rows[j]'s output rows are the sum of
// its partial slots split_parts[j] .. split_parts[j + 1] - 1, in chunk
// order, with the epilogue; one thread an output element.
__global__ void __launch_bounds__(THREADS)
spmm_merge_kernel(const int* __restrict__ split_rows,
                  const int* __restrict__ split_parts,
                  const float* __restrict__ partials,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int n_parts, int bm, int N, int M, int epilogue) {
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t tile = (size_t)bm * N;
  if (e >= tile) return;
  const int j = blockIdx.y, r = blockIdx.z;
  const int row = (int)(e / N), col = (int)(e % N);
  const int grow = split_rows[j] * bm + row;
  if (grow >= M) return;
  const float* p = partials + (size_t)r * n_parts * tile + e;
  float v = 0.f;
  for (int c = split_parts[j]; c < split_parts[j + 1]; ++c) v += p[c * tile];
  if (epilogue) v += bias[grow];
  if (epilogue == 2) v = fmaxf(v, 0.f);
  out[((size_t)r * M + grow) * N + col] = v;
}

// `walks` blocks of output rows (row blocks, or B13a's chunks), each cut
// into 64-row slices.
template <typename Rows>
int launch_spmm(Rows rows, const void* panel, const void* dense,
                const void* bias, void* out, int R, int walks, int bm, int bk,
                int K, int N, int M, int epilogue, void* stream,
                void* partials = nullptr, int n_parts = 0) {
  const int slices = (bm + TILE - 1) / TILE;
  dim3 grid((N + TILE - 1) / TILE, walks * slices, R);
  spmm_panel_kernel<Rows><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      rows, (const float*)panel, (const float*)dense, (const float*)bias,
      (float*)out, (float*)partials, n_parts, bm, bk, K, N, M, epilogue);
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
// out [R, M, N]; epilogue as spmm_panel_f32. n_split = 0: the unsplit walk,
// one launch. Else the split plan: chunks [n_chunks, 4] (row block, first
// tile, tile count, partial slot or -1), split_rows [n_split] and
// split_parts [n_split + 1] (the split row blocks and their partial
// slots), partials f32 [R, n_parts, bm, N]; two launches.
extern "C" int spmm_panel_c_f32(const void* block_offsets,
                                const void* block_cols, const void* chunks,
                                const void* split_rows,
                                const void* split_parts, const void* panel,
                                const void* dense, const void* bias,
                                void* out, void* partials, int R, int mb,
                                int n_chunks, int n_split, int n_parts,
                                int T, int bm, int bk, int K, int N, int M,
                                int epilogue, void* stream) {
  if (n_split == 0)
    return stt::launch_spmm(
        stt::CompressedRows{(const int*)block_offsets,
                            (const int*)block_cols, T},
        panel, dense, bias, out, R, mb, bm, bk, K, N, M, epilogue, stream);
  int err = stt::launch_spmm(
      stt::CompressedChunks{(const int*)chunks, (const int*)block_cols, T},
      panel, dense, bias, out, R, n_chunks, bm, bk, K, N, M, epilogue,
      stream, partials, n_parts);
  if (err != 0) return err;
  dim3 grid((unsigned)(((size_t)bm * N + stt::THREADS - 1) / stt::THREADS),
            n_split, R);
  stt::spmm_merge_kernel<<<grid, stt::THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)split_rows, (const int*)split_parts,
      (const float*)partials, (const float*)bias, (float*)out, n_parts, bm,
      N, M, epilogue);
  return (int)cudaGetLastError();
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
