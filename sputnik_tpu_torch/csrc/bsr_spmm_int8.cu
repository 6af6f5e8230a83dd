// Int8 (W8A8) panel products: SpMM, transposed SpMM and SDDMM with int8
// operands, exact int32 tile sums and f32 per-tile rescale.
//
// Replaces three TPU kernels of sputnik_tpu/ops/pallas/bsr_spmm_int8.py:
// bsr_spmm_panel_int8 (B16a), bsr_spmm_t_panel_int8 (B16b) and
// bsr_sddmm_panel_int8 (B17). The quantisation grid is part of the result,
// so it is the TPU kernels' grid, whatever tiles the CUDA blocks run:
//   * the weight is an int8 panel values_q[mb, max_bpr, bm, bk] with one f32
//     scale per tile (ops/int8_api.quantize_panel);
//   * B16a quantises the dense operand per [bk, bn] tile (block column c,
//     column tile j), B16b the gradient g per [bm, bq] tile (row block i,
//     column tile q), B17 lhs per [bm, 128] and rhs per [bk, 128] tile, the
//     depth cut into 128-deep chunks that are rescaled and summed in f32;
//   * a dynamic scale is max(absmax / 127, 1e-30) and a code
//     clip(rint(x / scale), -127, 127) (quant_i8 in common.cuh);
//   * each tile product is summed exactly in int32 and rescaled by the
//     product of its two scales before the f32 sum over tiles.
// So the kernels and their plain PyTorch versions agree on every integer
// product and differ only in the rounding of the f32 rescale sums.
//
// Two launches a call, one wrapper call: a pre-pass (quant_tiles_kernel)
// computes the activation scales, which do not depend on the row block, and
// writes an int8 copy of the activation in the layout the product reads;
// then the product kernel. For B16a / B16b the copy packs four consecutive
// contraction rows of one column into a 32-bit word ([row tile][word]
// [column]); for B17, whose contraction runs along the columns, it is the
// row-major int8 matrix, read as words of four columns.
//
// What bounds it on an H100: at the SpMM headline (4096^2, d = 0.1, every
// 64 x 64 tile occupied, bn = 1024) the function moves ~142 MB (1.7 MB of
// int8 nonzeros, 6.7 MB of pattern, the f32 dense operand and output, 67 MB
// each): ~0.04 ms at 3.35 TB/s, against 13.75 G int8 operations of
// nonzeros (0.007 ms at 1979 TOP/s). The stored panel is dense, though, so
// the kernel does 137 G operations on the CUDA cores.
//
// The simple design: B1's (B3's, B4's) structure - one block of 256 threads
// per 64 x 64 output slice, walking only the occupied slots - with 4 x 4
// int32 sums per thread from __dp4a over 32-deep slices staged as words in
// shared memory (tile_dp4a). __dp4a rather than mma.sync m16n8k32: both are
// exact, but __dp4a keeps B1's staging and thread layout unchanged, any bm,
// bk and bn works with zero-filled partial words, and it is what B19
// already uses; the tensor cores (wgmma, TMA) are later work. The rescale
// reads each output column's scale (column / bn), so a 64-wide CUDA tile may
// straddle two quantisation tiles.
#include "common.cuh"

namespace stt {

constexpr int TKW = TK / 4;  // int8 words per 32-deep staged slice

// Per-tile int8 quantisation of x[rows, cols] (f32; entries past rows or
// cols are zero) on tiles [tr, tc]: scale[rt * nct + ct], and the codes into
// out. pack_rows = 1: out is int32 [nrt][ceil(tr / 4)][nct * tc], word p of a
// column holding tile rows 4p..4p+3 in bytes 0..3. pack_rows = 0: out is int8
// [nrt * tr][nct * tc], row-major. One block per tile.
__global__ void __launch_bounds__(THREADS)
quant_tiles_kernel(const float* __restrict__ x, int rows, int cols, int tr,
                   int tc, int nct, int pack_rows, float* __restrict__ scale,
                   void* __restrict__ out) {
  __shared__ float red[THREADS / 32];
  const int ct = blockIdx.x, rt = blockIdx.y;
  const int r0 = rt * tr, c0 = ct * tc;
  const int width = nct * tc;
  float mx = 0.f;
  for (int e = threadIdx.x; e < tr * tc; e += THREADS) {
    const int r = r0 + e / tc, c = c0 + e % tc;
    if (r < rows && c < cols) mx = fmaxf(mx, fabsf(x[(size_t)r * cols + c]));
  }
  const float s = tile_scale(block_max(mx, red));
  if (threadIdx.x == 0) scale[rt * nct + ct] = s;
  if (pack_rows) {
    const int P4 = (tr + 3) / 4;
    int* o = reinterpret_cast<int*>(out) + (size_t)rt * P4 * width;
    for (int e = threadIdx.x; e < P4 * tc; e += THREADS) {
      const int p = e / tc, c = c0 + e % tc;
      unsigned w = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int lr = 4 * p + t, r = r0 + lr;
        const float v = (lr < tr && r < rows && c < cols)
                            ? x[(size_t)r * cols + c] : 0.f;
        w |= quant_i8(v, s) << (8 * t);
      }
      o[(size_t)p * width + c] = (int)w;
    }
  } else {
    signed char* o = reinterpret_cast<signed char*>(out);
    for (int e = threadIdx.x; e < tr * tc; e += THREADS) {
      const int r = r0 + e / tc, c = c0 + e % tc;
      const float v = (r < rows && c < cols) ? x[(size_t)r * cols + c] : 0.f;
      o[(size_t)r * width + c] = (signed char)quant_i8(v, s);
    }
  }
}

// B16a: out[M, N] = sum over occupied slots of (A_q tile . D_q tile) *
// (w_scale * d_scale). dq is the row-packed copy [kb][P4][Nq] (Nq = nct * bn),
// dscale [kb][nct]. A block column c >= kb lies past the dense rows: its tile
// is zero and is skipped.
__global__ void __launch_bounds__(THREADS)
spmm_int8_kernel(const int* __restrict__ block_cols,
                 const int* __restrict__ nblocks,
                 const signed char* __restrict__ vq,
                 const float* __restrict__ wscale, const int* __restrict__ dq,
                 const float* __restrict__ dscale, float* __restrict__ out,
                 int max_bpr, int bm, int bk, int kb, int N, int Nq, int bn,
                 int nct, int M) {
  __shared__ __align__(16) int As[TKW][TILE_LD];
  __shared__ __align__(16) int Bs[TKW][TILE_LD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TILE;
  const int slices = (bm + TILE - 1) / TILE;
  const int i = blockIdx.y / slices;
  const int r0 = (blockIdx.y % slices) * TILE;
  const int P4 = (bk + 3) / 4;

  float acc[4][4] = {};
  const int nb = nblocks[i];
  for (int s = 0; s < nb; ++s) {
    const int c = block_cols[i * max_bpr + s];
    if (c >= kb) continue;
    const signed char* a_tile = vq + ((size_t)i * max_bpr + s) * bm * bk;
    const int* d_blk = dq + (size_t)c * P4 * Nq;
    int iacc[4][4] = {};
    for (int p0 = 0; p0 < P4; p0 += TKW) {
      for (int e = tid; e < TILE * TKW; e += THREADS) {
        const int row = e / TKW, w = e % TKW;  // 4 bytes along the tile row
        const int gr = r0 + row, k = 4 * (p0 + w);
        unsigned word = 0;
        if (gr < bm) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (k + t < bk)
              word |= (unsigned)(unsigned char)a_tile[(size_t)gr * bk + k + t]
                      << (8 * t);
        }
        As[w][row] = (int)word;
      }
      for (int e = tid; e < TILE * TKW; e += THREADS) {
        const int w = e / TILE, col = e % TILE;  // coalesced along n
        const int gc = n0 + col;
        Bs[w][col] = (p0 + w < P4 && gc < Nq)
                         ? d_blk[(size_t)(p0 + w) * Nq + gc] : 0;
      }
      __syncthreads();
      tile_dp4a<TKW>(As, Bs, ty, tx, iacc);
      __syncthreads();
    }
    const float ws = wscale[i * max_bpr + s];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gc = n0 + tx * 4 + jj;
      const float sc = gc < Nq ? ws * dscale[c * nct + gc / bn] : 0.f;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) acc[ii][jj] += (float)iacc[ii][jj] * sc;
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = r0 + ty * 4 + ii, grow = i * bm + row;
    if (row >= bm || grow >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gc = n0 + tx * 4 + jj;
      if (gc < N) out[(size_t)grow * N + gc] = acc[ii][jj];
    }
  }
}

// B16b: out[rows, Q] = A^T @ G off the ORIGINAL int8 panel through the
// transposed walk (t_src_i, t_src_s, t_nblocks), G quantised per [bm, bq]
// tile: gq is the row-packed copy [mb][P4][Qq] (Qq = nqt * bq), gscale
// [mb][nqt]. The contraction runs over the tile rows, so the staged A word
// packs four tile rows of one tile column.
__global__ void __launch_bounds__(THREADS)
spmm_t_int8_kernel(const int* __restrict__ t_src_i,
                   const int* __restrict__ t_src_s,
                   const int* __restrict__ t_nblocks,
                   const signed char* __restrict__ vq,
                   const float* __restrict__ wscale,
                   const int* __restrict__ gq,
                   const float* __restrict__ gscale, float* __restrict__ out,
                   int max_bpr, int max_bpc, int bm, int bk, int Q, int Qq,
                   int bq, int nqt, int rows) {
  __shared__ __align__(16) int As[TKW][TILE_LD];
  __shared__ __align__(16) int Bs[TKW][TILE_LD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * TILE;
  const int slices = (bk + TILE - 1) / TILE;
  const int j = blockIdx.y / slices;
  const int c0 = (blockIdx.y % slices) * TILE;  // first tile column here
  const int P4 = (bm + 3) / 4;

  float acc[4][4] = {};
  const int nb = t_nblocks[j];
  for (int u = 0; u < nb; ++u) {
    const int i = t_src_i[j * max_bpc + u];
    const int s = t_src_s[j * max_bpc + u];
    const signed char* a_tile = vq + ((size_t)i * max_bpr + s) * bm * bk;
    const int* g_blk = gq + (size_t)i * P4 * Qq;
    int iacc[4][4] = {};
    for (int p0 = 0; p0 < P4; p0 += TKW) {
      for (int e = tid; e < TILE * TKW; e += THREADS) {
        const int w = e / TILE, col = e % TILE;  // coalesced along the row
        const int gc = c0 + col, k = 4 * (p0 + w);
        unsigned word = 0;
        if (gc < bk) {
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (k + t < bm)
              word |= (unsigned)(unsigned char)a_tile[(size_t)(k + t) * bk + gc]
                      << (8 * t);
        }
        As[w][col] = (int)word;
      }
      for (int e = tid; e < TILE * TKW; e += THREADS) {
        const int w = e / TILE, col = e % TILE;  // coalesced along Q
        const int gq_col = n0 + col;
        Bs[w][col] = (p0 + w < P4 && gq_col < Qq)
                         ? g_blk[(size_t)(p0 + w) * Qq + gq_col] : 0;
      }
      __syncthreads();
      tile_dp4a<TKW>(As, Bs, ty, tx, iacc);
      __syncthreads();
    }
    const float ws = wscale[i * max_bpr + s];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gc = n0 + tx * 4 + jj;
      const float sc = gc < Qq ? ws * gscale[i * nqt + gc / bq] : 0.f;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) acc[ii][jj] += (float)iacc[ii][jj] * sc;
    }
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int col = c0 + ty * 4 + ii, grow = j * bk + col;
    if (col >= bk || grow >= rows) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int gq_col = n0 + tx * 4 + jj;
      if (gq_col < Q) out[(size_t)grow * Q + gq_col] = acc[ii][jj];
    }
  }
}

// B17: out[i, s] = sum over 128-deep chunks t of (L_q . R_q^T) *
// (l_scale[i, t] * r_scale[c, t]), masked; lq [mb * bm][Dp] and rq
// [kb * bk][Dp] are the row-major int8 copies (Dp = dt * 128), lscale
// [mb][dt], rscale [kb][dt]. Padded slots, masked elements and block columns
// past the rhs rows (c >= kb: zero tiles) are written as exact zeros.
__global__ void __launch_bounds__(THREADS)
sddmm_int8_kernel(const int* __restrict__ block_cols,
                  const int* __restrict__ nblocks,
                  const signed char* __restrict__ lq,
                  const float* __restrict__ lscale,
                  const signed char* __restrict__ rq,
                  const float* __restrict__ rscale,
                  const float* __restrict__ mask, float* __restrict__ out,
                  int max_bpr, int bm, int bk, int kb, int dt) {
  __shared__ __align__(16) int As[TKW][TILE_LD];
  __shared__ __align__(16) int Bs[TKW][TILE_LD];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int col_slices = (bk + TILE - 1) / TILE;
  const int r0 = (blockIdx.x / col_slices) * TILE;
  const int c0 = (blockIdx.x % col_slices) * TILE;
  const int slot = blockIdx.y;  // i * max_bpr + s
  const int i = slot / max_bpr, s = slot % max_bpr;
  const size_t tile_elems = (size_t)bm * bk;
  float* o = out + (size_t)slot * tile_elems;
  const int c = block_cols[slot];

  if (s >= nblocks[i] || c >= kb) {  // padded slot or zero tile: exact zeros
    for (int e = tid; e < TILE * TILE; e += THREADS) {
      const int row = r0 + e / TILE, col = c0 + e % TILE;
      if (row < bm && col < bk) o[(size_t)row * bk + col] = 0.f;
    }
    return;
  }
  const int Dw = dt * 32;  // words per row
  const int* L = reinterpret_cast<const int*>(lq);
  const int* Rh = reinterpret_cast<const int*>(rq);

  float acc[4][4] = {};
  for (int t = 0; t < dt; ++t) {
    int iacc[4][4] = {};
    for (int w0 = t * 32; w0 < (t + 1) * 32; w0 += TKW) {
      for (int e = tid; e < TILE * TKW; e += THREADS) {
        const int row = e / TKW, w = e % TKW;  // along the row's words
        const int tr = r0 + row, tc = c0 + row;
        As[w][row] = tr < bm ? L[((size_t)i * bm + tr) * Dw + w0 + w] : 0;
        Bs[w][row] = tc < bk ? Rh[((size_t)c * bk + tc) * Dw + w0 + w] : 0;
      }
      __syncthreads();
      tile_dp4a<TKW>(As, Bs, ty, tx, iacc);
      __syncthreads();
    }
    const float sc = lscale[i * dt + t] * rscale[c * dt + t];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] += (float)iacc[ii][jj] * sc;
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

// Quantises nrt row tiles of x (those past `rows` are zero: scale 1e-30,
// codes 0).
int launch_quant(const float* x, int rows, int cols, int tr, int tc, int nrt,
                 int pack_rows, float* scale, void* out, cudaStream_t stream) {
  const int nct = (cols + tc - 1) / tc;
  if (nrt > 65535) return (int)cudaErrorInvalidValue;
  quant_tiles_kernel<<<dim3(nct, nrt), THREADS, 0, stream>>>(
      x, rows, cols, tr, tc, nct, pack_rows, scale, out);
  return (int)cudaGetLastError();
}

}  // namespace stt

// B16a. values_q [mb, max_bpr, bm, bk] int8, wscale [mb, max_bpr], dense
// [K, N] f32 (kb = ceil(K / bk) block columns), scratch dq int32
// [kb, ceil(bk / 4), nct * bn] and dscale [kb, nct] (nct = ceil(N / bn)),
// out [M, N] with M <= mb * bm.
extern "C" int spmm_panel_int8(const void* block_cols, const void* nblocks,
                               const void* values_q, const void* wscale,
                               const void* dense, void* dq, void* dscale,
                               void* out, int mb, int max_bpr, int bm, int bk,
                               int K, int N, int bn, int M, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int kb = (K + bk - 1) / bk, nct = (N + bn - 1) / bn;
  int err = stt::launch_quant((const float*)dense, K, N, bk, bn, kb, 1,
                              (float*)dscale, dq, st);
  if (err) return err;
  const int slices = (bm + stt::TILE - 1) / stt::TILE;
  dim3 grid((N + stt::TILE - 1) / stt::TILE, mb * slices);
  stt::spmm_int8_kernel<<<grid, stt::THREADS, 0, st>>>(
      (const int*)block_cols, (const int*)nblocks,
      (const signed char*)values_q, (const float*)wscale, (const int*)dq,
      (const float*)dscale, (float*)out, max_bpr, bm, bk, kb, N, nct * bn, bn,
      nct, M);
  return (int)cudaGetLastError();
}

// B16b. g [M, Q] f32 with M <= mb * bm, scratch gq int32
// [mb, ceil(bm / 4), nqt * bq] and gscale [mb, nqt] (nqt = ceil(Q / bq)),
// out [rows, Q] with rows <= kb * bk; t_src_i / t_src_s [kb * max_bpc].
extern "C" int spmm_t_panel_int8(const void* t_src_i, const void* t_src_s,
                                 const void* t_nblocks, const void* values_q,
                                 const void* wscale, const void* g, void* gq,
                                 void* gscale, void* out, int mb, int max_bpr,
                                 int kb, int max_bpc, int bm, int bk, int M,
                                 int Q, int bq, int rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // rows M..mb*bm of G are zero: mb full row tiles
  int err = stt::launch_quant((const float*)g, M, Q, bm, bq, mb, 1,
                              (float*)gscale, gq, st);
  if (err) return err;
  const int nqt = (Q + bq - 1) / bq;
  const int slices = (bk + stt::TILE - 1) / stt::TILE;
  dim3 grid((Q + stt::TILE - 1) / stt::TILE, kb * slices);
  stt::spmm_t_int8_kernel<<<grid, stt::THREADS, 0, st>>>(
      (const int*)t_src_i, (const int*)t_src_s, (const int*)t_nblocks,
      (const signed char*)values_q, (const float*)wscale, (const int*)gq,
      (const float*)gscale, (float*)out, max_bpr, max_bpc, bm, bk, Q,
      nqt * bq, bq, nqt, rows);
  return (int)cudaGetLastError();
}

// B17. lhs [M, D], rhs [Nr, D] f32 (M <= mb * bm), scratch lq int8
// [mb * bm, dt * 128], rq int8 [ceil(Nr / bk) * bk, dt * 128], lscale
// [mb, dt], rscale [ceil(Nr / bk), dt] (dt = ceil(D / 128)), mask and out
// [mb, max_bpr, bm, bk].
extern "C" int sddmm_panel_int8(const void* block_cols, const void* nblocks,
                                const void* lhs, const void* rhs,
                                const void* mask, void* lq, void* rq,
                                void* lscale, void* rscale, void* out, int mb,
                                int max_bpr, int bm, int bk, int M, int Nr,
                                int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int dt = (D + 127) / 128;
  int err = stt::launch_quant((const float*)lhs, M, D, bm, 128, mb, 0,
                              (float*)lscale, lq, st);
  if (err) return err;
  const int kb = (Nr + bk - 1) / bk;
  err = stt::launch_quant((const float*)rhs, Nr, D, bk, 128, kb, 0,
                          (float*)rscale, rq, st);
  if (err) return err;
  const int slices = ((bm + stt::TILE - 1) / stt::TILE) *
                     ((bk + stt::TILE - 1) / stt::TILE);
  dim3 grid(slices, mb * max_bpr);
  stt::sddmm_int8_kernel<<<grid, stt::THREADS, 0, st>>>(
      (const int*)block_cols, (const int*)nblocks, (const signed char*)lq,
      (const float*)lscale, (const signed char*)rq, (const float*)rscale,
      (const float*)mask, (float*)out, max_bpr, bm, bk, kb, dt);
  return (int)cudaGetLastError();
}
