// Panel SDDMM: out[r, i, s] = (lhs[r] @ rhs[r]^T)[tile (i, block_cols[i, s])]
// times the tile's element mask, written into the block panel.
//
// Replaces two TPU kernels: sputnik_tpu/ops/pallas/bsr_sddmm.py:
// bsr_sddmm_panel (B4, one topology for every replica) and
// sputnik_tpu/ops/batched_panel.py:_k_sddmm_bh (B7, the many-mask batch).
// lhs is [R, M, D], rhs [R, Nr, D] (stored row-major, the transpose is fused
// in the contraction). Replica r reads the metadata and element mask of mask
// r / heads (stacked per mask: block_cols [B, mb * max_bpr], nblocks
// [B, mb], mask [B, mb, max_bpr, bm, bk]); B4 is the case heads = R. B7
// computes the panel attention's scores (D = head dim) and the MoE expert
// bank's values gradient, where D is the capacity C (640 at the MoE
// example's full config): the walk stages any depth 32 at a time.
//
// What bounds it on an H100: each occupied 64 x 64 tile is 2 x 64^2 x D
// FLOPs on 2 x 64 x D operand floats read through L2 and 64^2 results
// written. At the MoE bank's values gradient (8 experts, [2048, 512] at
// d = 0.3: every tile occupied, D = C = 640) the stored work is 10.7 G,
// 0.16 ms at the fp32 FMA peak: operations-bound, so the product runs on
// the tensor cores in split TF32 (x = hi + lo, hi.hi + hi.lo + lo.hi at
// fp32 accuracy; common.cuh), 0.065 ms of tensor time at 495 / 3 TFLOP/s.
// At the attention shapes (D = 64) the mask read and the panel write are
// most of the bytes: memory-bound.
//
// The design (sddmm_tc_kernel): one block of 256 threads, two warpgroups,
// per (64 x 64 slice of a tile, PAIR of slots of one row block, replica).
// The two tiles of a pair share their lhs rows (the row block's 64-row
// slice), so the block stages and splits them once: they are wgmma's B
// operand, K-major in shared memory as they lie in memory (the contraction
// is the last axis of both operands, so neither needs a transpose). Each
// warpgroup's A operand is its own tile's 64 rhs rows, staged as rows and
// split into registers (tc_frags' AROWS layout). The depth streams in
// 32-deep units through B1's cp.async ring and walk (common.cuh: tc_walk),
// zero-filled past D; the tensor cores' sums are added into f32 sums every
// 64 of depth (over the whole depth where ceil(D / 32) is odd). The
// accumulator holds each tile transposed; the epilogue turns four columns
// into one lane (quad_transpose), applies the mask once and writes 16
// bytes a lane.
// Slots s >= nblocks[i], the second of a pair that has none, masked
// elements and the dump tile are EXACT zeros - the panel convention every
// consumer relies on (a consumer multiplies whole tiles); a pair with no
// live tile writes its zeros without touching the tensor cores. No
// atomics: the same bits run to run. Any bm, bk and D (64-row slices of
// the lhs, 64-column slices of the tile).
//
// Compressed (B14): also replaces sputnik_tpu/ops/pallas/bsr_compressed.py:
// bsr_sddmm_panel_c. The output is the true-BSR panel out[R, T, bm, bk]
// (blocking.CompressedView, T = num_blocks + 1): one block per (slice of
// a tile, tile g), over the real tiles and the dump. Tile g < num_blocks
// samples the lhs rows of its row block block_rows[g] and the rhs rows of
// its block column block_cols[g]; the dump tile g = num_blocks is written
// as exact zeros, so no output slot is left undefined and no grid step is
// padded (JAX's grid walks (row block, slot) and routes padded steps to
// the dump; it writes acc * mask and then zeroes the dump). The body is the
// same; only the address policy (EllSlots, CompressedSlots below) differs.
// A compressed pair is two neighbouring tiles of one row block (the tiles
// lie in row-block order): the block of tile g leads a pair where g is an
// even offset into its row block (a binary search of block_rows), and the
// others return at once; the dump is a pair of its own.
#include "common.cuh"

namespace stt {

// Output tile `slot` of replica r: whether it is a live tile (else exact
// zeros), the lhs row block i and rhs block column c it samples, and its
// element mask's tile (counted from the mask array).
struct SlotSrc {
  bool live;
  int i;
  int c;
  size_t mask_tile;
};

// The two output tiles of one block (slot -1: none), both in row block
// src[0].i; lead: this block computes them (else another block does).
struct SlotPair {
  bool lead;
  int slot[2];
  SlotSrc src[2];
};

struct EllSlots {  // B4 / B7: slot = i * max_bpr + s of the ELL panel
  const int* block_cols;  // [B, mb * max_bpr]
  const int* nblocks;     // [B, mb]
  int heads, mb, max_bpr;
  __device__ size_t tiles() const { return (size_t)mb * max_bpr; }
  __device__ int pairs() const { return (max_bpr + 1) / 2; }
  __device__ SlotSrc slot(int r, int slot) const {
    const int mask_id = r / heads;  // this replica's mask
    const int i = slot / max_bpr, s = slot % max_bpr;
    const size_t base = (size_t)mask_id * mb * max_bpr;
    const bool live = s < nblocks[(size_t)mask_id * mb + i];
    return {live, i, live ? block_cols[base + slot] : 0, base + slot};
  }
  // y = i * pairs() + p: slots 2p and 2p + 1 of row block i
  __device__ SlotPair pair(int r, int y) const {
    const int i = y / pairs(), s = 2 * (y % pairs());
    const int a = i * max_bpr + s, b = s + 1 < max_bpr ? a + 1 : -1;
    const SlotSrc none{false, i, 0, 0};
    return {true, {a, b}, {slot(r, a), b >= 0 ? slot(r, b) : none}};
  }
};

struct CompressedSlots {  // B14: tile g of the compressed panel
  const int* block_rows;  // [T], non-decreasing over the real tiles
  const int* block_cols;  // [T]
  int n_tiles;            // T = num_blocks + 1; the last is the dump
  __device__ size_t tiles() const { return (size_t)n_tiles; }
  __device__ SlotSrc slot(int, int g) const {
    const bool live = g < n_tiles - 1;
    return {live, live ? block_rows[g] : 0, live ? block_cols[g] : 0,
            (size_t)g};
  }
  // y = g: tiles g and g + 1 where g is an even offset into its row block
  // and g + 1 lies in the same row block; the dump alone
  __device__ SlotPair pair(int r, int g) const {
    const SlotSrc none{false, 0, 0, 0};
    if (g >= n_tiles - 1) return {true, {g, -1}, {slot(r, g), none}};
    const int row = block_rows[g];
    int lo = 0, hi = g;  // the row block's first tile
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (block_rows[mid] < row) lo = mid + 1;
      else hi = mid;
    }
    const bool two = g + 1 < n_tiles - 1 && block_rows[g + 1] == row;
    return {((g - lo) & 1) == 0, {g, two ? g + 1 : -1},
            {slot(r, g), two ? slot(r, g + 1) : none}};
  }
};

// Exact zeros over the 64 x 64 slice (r0, c0) of a bm x bk tile.
__device__ __forceinline__ void zero_slice(float* o, int r0, int c0, int bm,
                                           int bk) {
  for (int e = threadIdx.x; e < TILE * TILE; e += blockDim.x) {
    const int row = r0 + e / TILE, col = c0 + e % TILE;
    if (row < bm && col < bk) o[(size_t)row * bk + col] = 0.f;
  }
}

// The 64 x 64 slice (blockIdx.x: row slice r0, column slice c0) of the
// pair of tiles blockIdx.y of replica blockIdx.z; warpgroup w computes tile
// slot[w]. a_vec: the lhs / rhs rows can be staged in 16-byte pieces;
// o_vec: the mask and output in 16-byte accesses.
template <typename Slots>
__global__ void __launch_bounds__(256, 2)
sddmm_tc_kernel(Slots slots, const float* __restrict__ lhs,
                const float* __restrict__ rhs, const float* __restrict__ mask,
                float* __restrict__ out, int bm, int bk, int M, int Nr,
                int D, int a_vec, int o_vec) {
  constexpr int BST = tc_bstage(2, true);
  extern __shared__ __align__(1024) float smem[];
  float* const As = smem + 4 * TC_SB;            // [TC_STAGES][TC_A]
  float* const Bs = As + TC_STAGES * TC_A;       // [TC_STAGES][BST]
  const int tid = threadIdx.x, wg = tid >> 7;
  const int col_slices = (bk + TILE - 1) / TILE;
  const int r0 = (blockIdx.x / col_slices) * TILE;
  const int c0 = (blockIdx.x % col_slices) * TILE;
  const int r = blockIdx.z;
  const SlotPair pr = slots.pair(r, blockIdx.y);
  if (!pr.lead) return;
  const size_t tile_elems = (size_t)bm * bk;
  float* const o_r = out + (size_t)r * slots.tiles() * tile_elems;
  if (!pr.src[0].live && !pr.src[1].live) {  // padded slots, the dump
#pragma unroll
    for (int w2 = 0; w2 < 2; ++w2)
      if (pr.slot[w2] >= 0)
        zero_slice(o_r + pr.slot[w2] * tile_elems, r0, c0, bm, bk);
    return;
  }
  const int i = pr.src[0].i;
  const float* L = lhs + (size_t)r * M * D;
  const float* Rh = rhs + (size_t)r * Nr * D;
  const int units = (D + TC_BK - 1) / TC_BK;
  const int chunks = units % 2 ? units : 2;  // tensor-core sums 64 deep

  // stage unit lu (depth k0 ..) into the next raw stage: the lhs slice
  // (B, [m][k]) and both warpgroups' rhs rows (A, [n][k], 64 each); one
  // commit a call
  int lu = 0, lst = 0;
  auto load_next = [&]() {
    if (lu < units) {
      const int k0 = lu * TC_BK;
      float* as = As + lst * TC_A;
      float* bs = Bs + lst * BST;
#pragma unroll
      for (int q = 0; q < TILE * TC_BK / 4 / 256; ++q) {
        const int e = tid + q * 256, row = e / (TC_BK / 4);
        const int kg = e % (TC_BK / 4) * 4;
        const int tr = r0 + row, gr = i * bm + tr;
        tc_stage4(as + row * TC_LDA + kg, L + (size_t)gr * D + k0 + kg, lhs,
                  tr < bm && gr < M, k0 + kg, D, a_vec);
      }
#pragma unroll
      for (int q = 0; q < 2 * TILE * TC_BK / 4 / 256; ++q) {
        const int e = tid + q * 256, row = e / (TC_BK / 4);
        const int kg = e % (TC_BK / 4) * 4;
        const SlotSrc& sw = pr.src[q >> 1];  // rows 64 (q >> 1) ..
        const int tc = c0 + (row & 63), gc = sw.c * bk + tc;
        tc_stage4(bs + row * TC_LDA + kg, Rh + (size_t)gc * D + k0 + kg, rhs,
                  sw.live && tc < bk && gc < Nr, k0 + kg, D, a_vec);
      }
      lst = lst + 1 == TC_STAGES ? 0 : lst + 1;
      ++lu;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float facc[32];
  tc_walk<false, 2, decltype(load_next), true>(units, chunks, load_next,
                                                smem, facc);

  // facc[4j + e]: tile column c0 + 16w + g + 8 (e >> 1) (the rhs row), tile
  // row r0 + 8j + 2t + (e & 1) (the lhs row); after quad_transpose, lane
  // b = g & 3 holds columns n .. n + 3 of row m
  const int my_slot = wg ? pr.slot[1] : pr.slot[0];
  if (my_slot < 0) return;
  const SlotSrc me = wg ? pr.src[1] : pr.src[0];
  const int lane = tid & 31, w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int bq = g & 3;
  const int n = c0 + 16 * w + 4 * (g >> 2) + 8 * (bq >> 1);
  float* const o = o_r + my_slot * tile_elems;
  const float* const mk = mask + me.mask_tile * tile_elems;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float x[4] = {facc[4 * j], facc[4 * j + 1], facc[4 * j + 2],
                  facc[4 * j + 3]};
    quad_transpose(x, bq);
    const int m = r0 + 8 * j + 2 * t + (bq & 1);
    if (m >= bm || n >= bk) continue;
    const size_t e = (size_t)m * bk + n;
    if (o_vec) {
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (me.live) {
        const float4 mv = *reinterpret_cast<const float4*>(mk + e);
        y.x = mv.x != 0.f ? x[0] * mv.x : 0.f;
        y.y = mv.y != 0.f ? x[1] * mv.y : 0.f;
        y.z = mv.z != 0.f ? x[2] * mv.z : 0.f;
        y.w = mv.w != 0.f ? x[3] * mv.w : 0.f;
      }
      *reinterpret_cast<float4*>(o + e) = y;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (n + q >= bk) break;
        const float mv = me.live ? mk[e + q] : 0.f;
        o[e + q] = mv != 0.f ? x[q] * mv : 0.f;
      }
    }
  }
}

template <typename Slots>
int launch_sddmm(Slots slots, int n_pairs, const void* lhs, const void* rhs,
                 const void* mask, void* out, int R, int bm, int bk, int M,
                 int Nr, int D, void* stream) {
  const int slices = ((bm + TILE - 1) / TILE) * ((bk + TILE - 1) / TILE);
  dim3 grid(slices, n_pairs, R);
  const size_t smem = tc_smem(2, true);
  const int err = set_smem(sddmm_tc_kernel<Slots>, smem);
  if (err) return err;
  const int a_vec = D % 4 == 0 && (uintptr_t)lhs % 16 == 0 &&
                    (uintptr_t)rhs % 16 == 0;
  const int o_vec = bk % 4 == 0 && (uintptr_t)mask % 16 == 0 &&
                    (uintptr_t)out % 16 == 0;
  sddmm_tc_kernel<Slots><<<grid, 256, smem, (cudaStream_t)stream>>>(
      slots, (const float*)lhs, (const float*)rhs, (const float*)mask,
      (float*)out, bm, bk, M, Nr, D, a_vec, o_vec);
  return (int)cudaGetLastError();
}

}  // namespace stt

// lhs [R, M, D], rhs [R, Nr, D], mask [mb, max_bpr, bm, bk],
// out [R, mb, max_bpr, bm, bk].
extern "C" int sddmm_panel_f32(const void* block_cols, const void* nblocks,
                               const void* lhs, const void* rhs,
                               const void* mask, void* out, int R, int mb,
                               int max_bpr, int bm, int bk, int M, int Nr,
                               int D, void* stream) {
  return stt::launch_sddmm(
      stt::EllSlots{(const int*)block_cols, (const int*)nblocks, R, mb,
                    max_bpr},
      mb * ((max_bpr + 1) / 2), lhs, rhs, mask, out, R, bm, bk, M, Nr, D,
      stream);
}

// The many-mask batch (B7): block_cols [B, mb * max_bpr], nblocks [B, mb],
// mask [B, mb, max_bpr, bm, bk]; replica r reads mask r / heads.
extern "C" int sddmm_bh_f32(const void* block_cols, const void* nblocks,
                            const void* lhs, const void* rhs,
                            const void* mask, void* out, int R, int heads,
                            int mb, int max_bpr, int bm, int bk, int M,
                            int Nr, int D, void* stream) {
  return stt::launch_sddmm(
      stt::EllSlots{(const int*)block_cols, (const int*)nblocks, heads, mb,
                    max_bpr},
      mb * ((max_bpr + 1) / 2), lhs, rhs, mask, out, R, bm, bk, M, Nr, D,
      stream);
}

// The compressed panel (B14): block_rows / block_cols [T], lhs [R, M, D],
// rhs [R, Nr, D], mask [T, bm, bk], out [R, T, bm, bk]; T = num_blocks + 1,
// the dump tile T - 1 written as zeros.
extern "C" int sddmm_panel_c_f32(const void* block_rows,
                                 const void* block_cols, const void* lhs,
                                 const void* rhs, const void* mask, void* out,
                                 int R, int T, int bm, int bk, int M, int Nr,
                                 int D, void* stream) {
  return stt::launch_sddmm(
      stt::CompressedSlots{(const int*)block_rows, (const int*)block_cols,
                           T},
      T, lhs, rhs, mask, out, R, bm, bk, M, Nr, D, stream);
}
