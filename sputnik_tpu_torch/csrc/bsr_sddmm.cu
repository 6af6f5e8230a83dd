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
// example's full config): the D loop below stages any depth 32 at a time.
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
// same; only the address policy (EllSlots, CompressedSlots below) differs,
// so B4 and B7 compile to what they were.
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

struct EllSlots {  // B4 / B7: slot = i * max_bpr + s of the ELL panel
  const int* block_cols;  // [B, mb * max_bpr]
  const int* nblocks;     // [B, mb]
  int heads, mb, max_bpr;
  __device__ size_t tiles() const { return (size_t)mb * max_bpr; }
  __device__ SlotSrc slot(int r, int slot) const {
    const int mask_id = r / heads;  // this replica's mask
    const int i = slot / max_bpr, s = slot % max_bpr;
    const size_t base = (size_t)mask_id * mb * max_bpr;
    const bool live = s < nblocks[(size_t)mask_id * mb + i];
    return {live, i, live ? block_cols[base + slot] : 0, base + slot};
  }
};

struct CompressedSlots {  // B14: tile g of the compressed panel
  const int* block_rows;  // [T]
  const int* block_cols;  // [T]
  int n_tiles;            // T = num_blocks + 1; the last is the dump
  __device__ size_t tiles() const { return (size_t)n_tiles; }
  __device__ SlotSrc slot(int, int g) const {
    const bool live = g < n_tiles - 1;
    return {live, live ? block_rows[g] : 0, live ? block_cols[g] : 0,
            (size_t)g};
  }
};

template <typename Slots>
__global__ void __launch_bounds__(THREADS)
sddmm_panel_kernel(Slots slots, const float* __restrict__ lhs,
                   const float* __restrict__ rhs,
                   const float* __restrict__ mask, float* __restrict__ out,
                   int bm, int bk, int M, int Nr, int D) {
  __shared__ __align__(16) float As[TK][TILE_LD];
  __shared__ __align__(16) float Bs[TK][TILE_LD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int col_slices = (bk + TILE - 1) / TILE;
  const int r0 = (blockIdx.x / col_slices) * TILE;
  const int c0 = (blockIdx.x % col_slices) * TILE;
  const int slot = blockIdx.y;
  const int r = blockIdx.z;
  const SlotSrc src = slots.slot(r, slot);
  const size_t tile_elems = (size_t)bm * bk;
  float* o = out + ((size_t)r * slots.tiles() + slot) * tile_elems;

  if (!src.live) {  // padded slot or the dump tile: exact zeros
    for (int e = tid; e < TILE * TILE; e += THREADS) {
      const int row = r0 + e / TILE, col = c0 + e % TILE;
      if (row < bm && col < bk) o[(size_t)row * bk + col] = 0.f;
    }
    return;
  }
  const int i = src.i, c = src.c;
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

  const float* mk = mask + src.mask_tile * tile_elems;
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

template <typename Slots>
int launch_sddmm(Slots slots, int n_slots, const void* lhs, const void* rhs,
                 const void* mask, void* out, int R, int bm, int bk, int M,
                 int Nr, int D, void* stream) {
  const int slices = ((bm + TILE - 1) / TILE) * ((bk + TILE - 1) / TILE);
  dim3 grid(slices, n_slots, R);
  sddmm_panel_kernel<Slots><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      slots, (const float*)lhs, (const float*)rhs, (const float*)mask,
      (float*)out, bm, bk, M, Nr, D);
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
      mb * max_bpr, lhs, rhs, mask, out, R, bm, bk, M, Nr, D, stream);
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
      mb * max_bpr, lhs, rhs, mask, out, R, bm, bk, M, Nr, D, stream);
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
