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
// What bounds it on an H100. At the repo's headline (4096^2, d = 0.1,
// element-random) every 64 x 64 tile is occupied, so the stored work is a
// dense 4096^3 product: 137.4 GFLOP (13.7 on the nonzeros alone) against
// 64 MB of panel and a 64 MB dense operand. FP32 FMA (67 TFLOP/s) cannot
// take it below 2.05 ms, slower than cuBLAS's dense SGEMM; the tensor cores
// can. Their fp32 input is TF32 (10 mantissa bits), and one TF32 rounding
// of each operand misses the kernels' 1e-4 * max|out| at this depth (a
// relative 2^-11 an operand: 2.9x the limit on [64, 4096] @ [4096, 64],
// tests/test_torch_tf32_split.py). Split TF32 meets it: x = hi + lo, three
// products hi.hi + hi.lo + lo.hi, an error near fp32's own. So 3 x 137.4 =
// 412 G TF32 operations, 0.83 ms at the 495 TFLOP/s dense TF32 peak (on
// the nonzeros alone 0.083 ms); beside that, the dense slices pass L2 once
// per row block (64 x 67 MB) and the tiles once per 128 columns.
//
// The design (spmm_tc_kernel, common.cuh: tc_walk): one block of 256
// threads, two warpgroups, per (64-row slice of a row block, 128 output
// columns (one warpgroup, 64, where N <= 64), replica). It walks the row
// block's occupied slots s < nblocks[i] (padded slots are never visited)
// in 32-deep units through a 3-stage cp.async ring (16-byte copies where
// the rows allow, zero-filled past bm, bk, K and N). Per unit the block
// splits the tile slice into hi and lo in shared memory (core-matrix
// order, K-major) and each warpgroup loads its 64 dense columns into
// registers, splits them there, and issues wgmma m64n64k8 TF32 hi.hi,
// hi.lo, lo.hi per 8-deep step: dense^T . tile^T, since TF32 wgmma reads
// shared memory K-major only and the dense rows are not. A slot's
// tensor-core sums are added into f32 sums after its last unit (the
// tensor cores' accumulation spans one slot, 24 products deep at bk = 64).
// The output is written once, transposed back from the accumulators, with
// the bias / bias+ReLU epilogue; a row block without occupied tiles writes
// exactly 0 (+ bias). No atomics: the same bits run to run. Any bm, bk
// works (64-row slices, 32-deep units, zero-filled).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md): ~2.0 ms at the
// headline, 2.4x its 3xTF32 tensor time. Knock-out builds put the
// products (~0.83 ms) and the rest (staging through L2 ~0.55, the split
// pass ~0.3) end to end rather than overlapped; mma.sync m16n8k8 in place
// of wgmma took 2.42 ms; a register-double-buffered walk that overlaps a
// warpgroup's products with its next unit's staging needed 16-deep units
// to fit 128 registers and was slower; 256 columns a block and the grid
// order moved it < 5%.
//
// Compressed (B13a): also replaces sputnik_tpu/ops/pallas/bsr_compressed.py:
// bsr_spmm_panel_c. The panel is the true-BSR layout values[R, T, bm, bk]
// (blocking.CompressedView, T = num_blocks + 1 with a dump tile last):
// row block i owns tiles block_offsets[i] .. block_offsets[i + 1] - 1, the
// s-th in block column block_cols[block_offsets[i] + s]. The body is B1's
// on another address policy (CompressedChunks below), so B1, B2, B6 and
// B13a are one template. The compressed softmax backward also runs it for its
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

// out rows of walk blockIdx.y / slices (its 64-row slice blockIdx.y %
// slices) x BN = 64 * WG columns (blockIdx.x) of replica blockIdx.z, in
// split TF32 on the tensor cores (common.cuh: tc_walk). The walk's slots
// pass in TC_BK-deep units (ceil(bk / TC_BK) a slot): the slice's rows of
// the slot's tile ([m][k]) and the TC_BK dense rows its block column names
// ([k][n]). a_vec / b_vec: the tile / dense rows can be staged in 16-byte
// pieces.
template <typename Rows, int WG>
__global__ void __launch_bounds__(128 * WG, 2)
spmm_tc_kernel(Rows rows, const float* __restrict__ panel,
               const float* __restrict__ dense, const float* __restrict__ bias,
               float* __restrict__ out, float* __restrict__ partials,
               int n_parts, int bm, int bk, int K, int N, int M, int epilogue,
               int a_vec, int b_vec) {
  constexpr int NTHREADS = 128 * WG, BN = 64 * WG, LDB = tc_ldb(WG);
  constexpr int BG = BN / 4;
  extern __shared__ __align__(1024) float smem[];
  float* const As = smem + 4 * TC_SB;            // [TC_STAGES][TC_A]
  float* const Bs = As + TC_STAGES * TC_A;       // [TC_STAGES][TC_BK * LDB]
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.x * BN;
  const int slices = (bm + TILE - 1) / TILE;
  const int r0 = (blockIdx.y % slices) * TILE;
  const int r = blockIdx.z;
  const RowWalk walk = rows.row(r, blockIdx.y / slices);
  const size_t tile_elems = (size_t)bm * bk;
  const float* pan = panel + (size_t)r * rows.tiles() * tile_elems;
  const float* den = dense + (size_t)r * K * N;
  const int chunks = (bk + TC_BK - 1) / TC_BK;
  const int units = walk.count * chunks;

  // stage unit (slot ls, piece ld) into the next raw stage; one commit a
  // call
  int ls = 0, ld = 0, lst = 0;
  auto load_next = [&]() {
    if (ls < walk.count) {
      const int c = walk.cols[ls], k0 = ld * TC_BK;
      const float* a_tile = pan + (size_t)walk.tile(ls) * tile_elems;
      float* as = As + lst * TC_A;
      float* bs = Bs + lst * (TC_BK * LDB);
#pragma unroll
      for (int q = 0; q < TILE * TC_BK / 4 / NTHREADS; ++q) {
        const int e = tid + q * NTHREADS, row = e / (TC_BK / 4);
        const int kg = e % (TC_BK / 4) * 4;
        const int gr = r0 + row;
        tc_stage4(as + row * TC_LDA + kg,
                  a_tile + (size_t)gr * bk + k0 + kg, panel, gr < bm,
                  k0 + kg, bk, a_vec);
      }
#pragma unroll
      for (int q = 0; q < TC_BK * BG / NTHREADS; ++q) {
        const int e = tid + q * NTHREADS, k = e / BG, ng = (e % BG) * 4;
        const int gk = k0 + k, grow = c * bk + gk;
        tc_stage4(bs + k * LDB + ng, den + (size_t)grow * N + n0 + ng, dense,
                  gk < bk && grow < K, n0 + ng, N, b_vec);
      }
      lst = lst + 1 == TC_STAGES ? 0 : lst + 1;
      if (++ld == chunks) {
        ld = 0;
        ++ls;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float facc[32];
  tc_walk<false, WG>(units, chunks, load_next, smem, facc);

  // acc[4j + e]: output row 8j + 2t + (e & 1) of the slice, column
  // n0 + 64 wg + 16w + g + 8 (e >> 1). A chunk of a split row block writes
  // its partial sums, rows counted from the row block's first; the rest
  // write the output with the epilogue.
  const int lane = tid & 31, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const bool part = walk.part >= 0;
  float* const o =
      part ? partials + ((size_t)r * n_parts + walk.part) * bm * N
           : out + (size_t)r * M * N;
  const int row_base = part ? 0 : walk.block * bm;
  const int row_end = part ? bm : M;
  const int epi = part ? 0 : epilogue;
  const int col0 = n0 + wg * 64 + w * 16 + g;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * j + 2 * t + h, grow = row_base + row;
      if (row >= bm || grow >= row_end) continue;
      const float b = epi ? bias[grow] : 0.f;
      float* orow = o + (size_t)grow * N;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = col0 + 8 * c;
        float v = facc[4 * j + 2 * c + h] + b;
        if (epi == 2) v = fmaxf(v, 0.f);
        if (col < N) orow[col] = v;
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
// into 64-row slices; 128 columns a block, 64 where N <= 64.
template <typename Rows, int WG>
int launch_spmm_wg(Rows rows, const void* panel, const void* dense,
                   const void* bias, void* out, int R, int walks, int bm,
                   int bk, int K, int N, int M, int epilogue, void* stream,
                   void* partials, int n_parts) {
  const int slices = (bm + TILE - 1) / TILE;
  dim3 grid((N + 64 * WG - 1) / (64 * WG), walks * slices, R);
  const size_t smem = tc_smem(WG);
  const int err = set_smem(spmm_tc_kernel<Rows, WG>, smem);
  if (err) return err;
  const int a_vec = bk % 4 == 0 && (uintptr_t)panel % 16 == 0;
  const int b_vec = N % 4 == 0 && (uintptr_t)dense % 16 == 0;
  spmm_tc_kernel<Rows, WG><<<grid, 128 * WG, smem, (cudaStream_t)stream>>>(
      rows, (const float*)panel, (const float*)dense, (const float*)bias,
      (float*)out, (float*)partials, n_parts, bm, bk, K, N, M, epilogue,
      a_vec, b_vec);
  return (int)cudaGetLastError();
}

template <typename Rows>
int launch_spmm(Rows rows, const void* panel, const void* dense,
                const void* bias, void* out, int R, int walks, int bm, int bk,
                int K, int N, int M, int epilogue, void* stream,
                void* partials = nullptr, int n_parts = 0) {
  return N > 64 ? launch_spmm_wg<Rows, 2>(rows, panel, dense, bias, out, R,
                                          walks, bm, bk, K, N, M, epilogue,
                                          stream, partials, n_parts)
                : launch_spmm_wg<Rows, 1>(rows, panel, dense, bias, out, R,
                                          walks, bm, bk, K, N, M, epilogue,
                                          stream, partials, n_parts);
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
