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
//     product of its two scales before the f32 sum over tiles, slot by slot
//     in the walk's order.
// So the kernels and their plain PyTorch versions agree on every integer
// product and differ only in the rounding of the f32 rescale sums.
//
// B16a / B16b: what bounds them on an H100. At the SpMM headline (4096^2,
// d = 0.1, 64 x 64 tiles, bn = 1024) the element-random pattern occupies
// every tile, so the stored panel is dense: 137.4 G int8 operations, 0.069
// ms at the tensor cores' 1979 TOP/s, against a byte bound of 0.0426 ms on
// what the function needs (142.6 MB: the int8 nonzeros, the pattern, the
// f32 activation and output). Two more costs come with the function:
//   * every slot ends with a rescale of its int32 tile sums into the f32
//     sums (the scale changes with the slot): a convert and an FMA per
//     output and slot, 1.07 G of each at the headline's 64-deep slots;
//   * a block of output rows reads every code of the activation its slots
//     name: at 64-row blocks 64 x 16.8 MB of codes through L2, plus the
//     weight tiles once per 128 output columns (0.54 GB).
//
// The design:
//   * a pre-pass at memory speed (tile_absmax_kernel, pack_kmajor_kernel):
//     lanes read 32 neighbouring columns, 16 rows each (coalesced), take
//     the tile maxima with a segmented warp max and an integer atomicMax
//     (exact and order-free on non-negative floats), then a second read
//     quantises and writes the codes K-major, [row tile][column][kp] with
//     kp the tile depth rounded up to 64 (zero-padded), in wgmma's
//     core-matrix order (8 columns x 16 bytes of depth), one 16-byte store
//     a thread: a product block's piece of it is one contiguous run a group
//     of 8 columns;
//   * one product body for both (spmm_int8_wgmma_kernel) on the int8
//     tensor cores, wgmma.mma_async m64n64k32 s8 x s8 -> s32 with both
//     operands K-major in shared memory (no swizzle): a block owns 64 rows
//     x 128 columns of one row block (B16a) or column block (B16b), two
//     warpgroups of 64 x 64, and walks its slots; a 5-stage cp.async ring
//     keeps 3 64-deep pieces of the weight tile (A) and of the codes (B) in
//     flight, with the slot's column scales and the next slot's metadata
//     read ahead; after a slot's last piece its sums are rescaled (cvt.rn
//     + FMA) while the other warpgroup and the SM's other block keep the
//     tensor cores busy;
//   * B16b contracts over the tile rows, so its A operand (A^T) is not
//     K-major: transpose_tiles_kernel first writes each tile of the
//     transposed walk transposed, in the core-matrix order and walk order
//     (two bytes moved a code), and the product runs B16a's body on it;
//     transposing in shared memory instead would put byte permutes into the
//     product's loop.
// Measured (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py phase 2h) the
// product takes ~0.65 ms of a ~0.72 ms call at the headline, some 9x its
// tensor-core time. Exploratory builds that knocked out the staging, the
// products or the rescale one at a time put each of the three near half
// of it, none dominant, and mma.sync in place of wgmma, more stages, 256
// columns a block, three blocks an SM or a magic-number int32 -> f32
// conversion did not move it by more than 15%: the block per 64-row slice,
// with one barrier per 64-deep piece, is what holds it back.
// No float atomics: the bits are the same from run to run.
//
// B17 keeps its own design: a row-major int8 copy of each operand
// (quant_tiles_kernel, one block per tile) and B4's 64 x 64 output tile
// with __dp4a over 32-deep word slices (tile_dp4a).
#include "common.cuh"

namespace stt {

constexpr int TKW = TK / 4;  // int8 words per 32-deep staged slice

// Per-tile int8 quantisation of x[rows, cols] (f32; entries past rows or
// cols are zero) on tiles [tr, tc]: scale[rt * nct + ct], and the codes
// into out, int8 [nrt * tr][nct * tc], row-major. One block per tile (B17).
__global__ void __launch_bounds__(THREADS)
quant_tiles_kernel(const float* __restrict__ x, int rows, int cols, int tr,
                   int tc, int nct, float* __restrict__ scale,
                   signed char* __restrict__ out) {
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
  for (int e = threadIdx.x; e < tr * tc; e += THREADS) {
    const int r = r0 + e / tc, c = c0 + e % tc;
    const float v = (r < rows && c < cols) ? x[(size_t)r * cols + c] : 0.f;
    out[(size_t)r * width + c] = (signed char)quant_i8(v, s);
  }
}

// --- B16a / B16b: the activation pre-pass -----------------------------------

constexpr int KSTEP = 64;      // code bytes a product stage holds; kp: a multiple
constexpr int BCOLS = 128;     // output columns a product block owns
constexpr int BROWS = 64;      // output rows a product block owns (wgmma's M)
constexpr int PRE_COLS = 64;   // columns of a pre-pass block (2 warps wide)
constexpr int PRE_DEPTH = 64;  // tile rows of a pre-pass block (4 x 16)
constexpr unsigned FULL = 0xffffffffu;

// A pre-pass thread's column and first tile row: lanes along 32 columns,
// warps 2 column halves x 4 groups of 16 rows; blockIdx (column block,
// depth block, row tile).
struct PreIdx {
  int col, d0;
};
__device__ __forceinline__ PreIdx pre_idx() {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return {(int)blockIdx.x * PRE_COLS + (warp & 1) * 32 + lane,
          (int)blockIdx.y * PRE_DEPTH + (warp >> 1) * 16};
}

// tmax[rt * nct + ct] = max |x| over tile (rt, ct) as float bits (zeroed
// first; non-negative floats order as their bits do, so the integer
// atomicMax is exact and its order does not matter).
__global__ void __launch_bounds__(THREADS)
tile_absmax_kernel(const float* __restrict__ x, int rows, int cols, int tr,
                   int tc, int nct, int* __restrict__ tmax) {
  const PreIdx p = pre_idx();
  const int rt = blockIdx.z, lane = threadIdx.x & 31;
  float m = 0.f;
  if (p.col < cols) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = p.d0 + j, r = rt * tr + k;
      if (k < tr && r < rows) m = fmaxf(m, fabsf(x[(size_t)r * cols + p.col]));
    }
  }
  // segmented max over the lanes of one column tile (ct never falls with
  // the lane): the tile's first lane ends with the tile's maximum
  const int ct = p.col < cols ? p.col / tc : 0x7fffffff;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float mo = __shfl_down_sync(FULL, m, off);
    const int co = __shfl_down_sync(FULL, ct, off);
    if (lane + off < 32 && co == ct) m = fmaxf(m, mo);
  }
  const int prev = __shfl_up_sync(FULL, ct, 1);
  if ((lane == 0 || prev != ct) && ct != 0x7fffffff && m > 0.f)
    atomicMax(tmax + rt * nct + ct, __float_as_int(m));
}

// The codes of x in the core-matrix layout: row tile rt is an [ncols, kp]
// block (column n, depth k: the code of x[rt * tr + k, n]; 0 past the
// tile's tr rows, past rows and past cols) at rt * ncols * kp; scale[rt *
// nct + ct] = the tile's scale. A thread's 16 rows are one 16-byte store.
__global__ void __launch_bounds__(THREADS)
pack_kmajor_kernel(const float* __restrict__ x, int rows, int cols, int tr,
                   int tc, int nct, int kp, int ncols,
                   const int* __restrict__ tmax, float* __restrict__ scale,
                   signed char* __restrict__ out) {
  const PreIdx p = pre_idx();
  const int rt = blockIdx.z;
  const int ct = min(p.col / tc, nct - 1);
  const float s = tile_scale(__int_as_float(tmax[rt * nct + ct]));
  unsigned w[4] = {0u, 0u, 0u, 0u};
  if (p.col < cols) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = p.d0 + j, r = rt * tr + k;
      const float v = (k < tr && r < rows) ? x[(size_t)r * cols + p.col] : 0.f;
      w[j >> 2] |= quant_i8(v, s) << (8 * (j & 3));
    }
  }
  *reinterpret_cast<uint4*>(out + (size_t)rt * ncols * kp +
                            core_off(p.col, p.d0 >> 4, kp)) =
      make_uint4(w[0], w[1], w[2], w[3]);
  if (p.d0 == 0 && p.col < cols && p.col % tc == 0) scale[rt * nct + ct] = s;
}

// Scales and core-layout codes of x[rows, cols] on tiles [tr, tc], nrt row
// tiles; tmax int32 [nrt * nct] is scratch.
int launch_quant_kmajor(const float* x, int rows, int cols, int tr, int tc,
                        int nrt, int kp, int ncols, int* tmax, float* scale,
                        signed char* out, cudaStream_t st) {
  const int nct = (cols + tc - 1) / tc;
  if (nrt > 65535 || kp % KSTEP || ncols % BCOLS || kp < tr || ncols < cols)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaMemsetAsync(tmax, 0, sizeof(int) * (size_t)nrt * nct, st);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(ncols / PRE_COLS, kp / PRE_DEPTH, nrt);
  tile_absmax_kernel<<<grid, THREADS, 0, st>>>(x, rows, cols, tr, tc, nct,
                                               tmax);
  pack_kmajor_kernel<<<grid, THREADS, 0, st>>>(x, rows, cols, tr, tc, nct, kp,
                                               ncols, tmax, scale, out);
  return (int)cudaGetLastError();
}

// --- B16b: the transposed tiles ----------------------------------------------

// vqt[j * max_bpc + u] = tile (t_src_i, t_src_s)[j, u] of vq transposed, in
// the core-matrix layout of bk8 x kp codes (bk8 = bk rounded up to 8, kp >=
// bm; zero past bm). blockIdx: (walk slot, 64 tile columns, 64 tile rows).
__global__ void __launch_bounds__(THREADS)
transpose_tiles_kernel(const int* __restrict__ t_src_i,
                       const int* __restrict__ t_src_s,
                       const int* __restrict__ t_nblocks,
                       const signed char* __restrict__ vq,
                       signed char* __restrict__ vqt, int max_bpr,
                       int max_bpc, int bm, int bk, int kp) {
  __shared__ unsigned char S[64][64 + 4];
  const int slot = blockIdx.x, j = slot / max_bpc, u = slot % max_bpc;
  if (u >= t_nblocks[j]) return;
  const int i = t_src_i[slot], s = t_src_s[slot];
  const signed char* src = vq + ((size_t)i * max_bpr + s) * bm * bk;
  const int c0 = blockIdx.y * 64, k0 = blockIdx.z * 64;
  for (int e = threadIdx.x; e < 64 * 64; e += THREADS) {
    const int rr = e >> 6, cc = e & 63, r = k0 + rr, c = c0 + cc;
    S[rr][cc] = (r < bm && c < bk) ? (unsigned char)src[(size_t)r * bk + c] : 0;
  }
  __syncthreads();
  const int orow = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int c = c0 + orow;
  if (c >= bk) return;
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      w[q] |= (unsigned)S[part * 16 + q * 4 + b][orow] << (8 * b);
  }
  const size_t bk8 = (bk + 7) / 8 * 8;
  *reinterpret_cast<uint4*>(vqt + slot * bk8 * kp +
                            core_off(c, (k0 >> 4) + part, kp)) =
      make_uint4(w[0], w[1], w[2], w[3]);
}

// --- B16a / B16b: the tensor-core product ---------------------------------

constexpr int STAGES = 5;
constexpr int AHEAD = STAGES - 2;  // units in flight ahead of the one consumed
constexpr int SC_RING = AHEAD + 1;  // slots of column scales held
constexpr int A_STAGE = BROWS * KSTEP;  // bytes of a staged weight piece
constexpr int B_STAGE = BCOLS * KSTEP;  // bytes of a staged code piece
constexpr int GROUP = KSTEP / 16 * CORE;  // an 8-row group of a stage

// One slot of a walk: the block of codes (and scales) it reads, its weight
// scale, and whether it contributes (B16a skips block columns past K).
struct SlotInfo {
  int src;
  float ws;
  int live;
};

// B16a's walk: row block i's slots s; A = values_q[i, s] ([bm][bk],
// row-major), B = the codes of block column block_cols[i, s].
struct RowWalk {
  const int* block_cols;
  const int* nblocks;
  const signed char* vq;
  const float* wscale;
  int max_bpr, kb;
  int rows, depth, aligned16;  // A tile rows, contraction bytes
  __device__ int count(int i) const { return nblocks[i]; }
  __device__ SlotInfo info(int i, int s) const {
    const int c = block_cols[i * max_bpr + s];
    return {c, wscale[i * max_bpr + s], c < kb};
  }
  __device__ const signed char* tile(int i, int s) const {
    return vq + ((size_t)i * max_bpr + s) * rows * depth;
  }
  __device__ size_t at(int r, int k) const { return (size_t)r * depth + k; }
};

// B16b's walk: column block j's entries u of the transposed walk; A = the
// transposed tile vqt[j * max_bpc + u] (core layout, bk8 x kp), B = the
// codes of g's row block t_src_i[j, u].
struct ColWalk {
  const int* t_src_i;
  const int* t_src_s;
  const int* t_nblocks;
  const signed char* vqt;
  const float* wscale;
  int max_bpr, max_bpc, kp;
  int rows, depth, aligned16;
  __device__ int count(int j) const { return t_nblocks[j]; }
  __device__ SlotInfo info(int j, int u) const {
    const int i = t_src_i[j * max_bpc + u];
    return {i, wscale[i * max_bpr + t_src_s[j * max_bpc + u]], 1};
  }
  __device__ const signed char* tile(int j, int u) const {
    return vqt + ((size_t)j * max_bpc + u) * ((rows + 7) / 8 * 8) * kp;
  }
  __device__ size_t at(int r, int k) const {
    return core_off(r, k >> 4, kp) + (k & 15);
  }
};

// out[blk * rows + r, n] = sum over the walk's slots of (A tile . B codes)
// * (ws * bscale[src, n / bn]), in slot order. Block: BROWS rows (r0) of
// walk block blk x BCOLS columns (n0), two warpgroups of 64 x 64 (wgmma
// m64n64k32, into 32 int32 sums a thread). A slot's kp bytes pass in
// KSTEP-deep units through a STAGES-deep cp.async ring, AHEAD units in
// flight (one stage of slack, so that a unit's products run on while the
// next unit is staged); a slot's column scales are gathered into a ring of
// SC_RING slots with its first unit, and its metadata is read a unit
// ahead. After a slot's last unit its exact sums are rescaled into the f32
// sums (cvt.rn + FMA); the other warpgroup and the SM's other block keep
// the tensor cores busy meanwhile.
template <class Walk>
__global__ void __launch_bounds__(THREADS, 2)
spmm_int8_wgmma_kernel(Walk walk, const signed char* __restrict__ bq,
                       const float* __restrict__ bscale,
                       float* __restrict__ out, int out_rows, int N,
                       int ncols, int kp, int bn, int nct) {
  extern __shared__ __align__(1024) signed char smem[];
  signed char* const As = smem;                    // [STAGES][A_STAGE]
  signed char* const Bs = smem + STAGES * A_STAGE;  // [STAGES][B_STAGE]
  float* const scr = reinterpret_cast<float*>(
      smem + STAGES * (A_STAGE + B_STAGE));          // [SC_RING][BCOLS]
  SlotInfo* const sinfo = reinterpret_cast<SlotInfo*>(scr + SC_RING * BCOLS);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, wr = (tid >> 5) & 3;
  const int slices = (walk.rows + BROWS - 1) / BROWS;
  const int blk = blockIdx.y / slices, r0 = (blockIdx.y % slices) * BROWS;
  const int n0 = blockIdx.x * BCOLS;
  const int chunks = kp / KSTEP;
  const int nslots = walk.count(blk);
  // the column tile of column n0 + tid (the scale gather's column)
  const int my_ct = min((n0 + (tid & (BCOLS - 1))) / bn, nct - 1);

  // Stage the next unit (slot iu, KSTEP-deep piece id) into stage ist; every
  // thread commits one group a call, empty or not.
  int iu = 0, id = 0, ist = 0;
  SlotInfo nxt = nslots > 0 ? walk.info(blk, 0) : SlotInfo{0, 0.f, 0};
  auto stage_next = [&]() {
    if (iu < nslots) {
      const SlotInfo in = nxt;
      if (tid == 0) sinfo[ist] = in;
      if (in.live) {
        // A: 64 rows x 4 granules, two lanes on a row's 32 bytes
        const int kg = (tid & 1) + 2 * (tid >> 7), row = (tid >> 1) & 63;
        const int k = id * KSTEP + kg * 16, gr = r0 + row;
        signed char* dst = As + ist * A_STAGE + core_off(row, kg, KSTEP);
        const signed char* a = walk.tile(blk, iu);
        const int valid = gr < walk.rows ? max(0, min(16, walk.depth - k)) : 0;
        if (walk.aligned16) {
          cp_async16(dst, valid ? a + walk.at(gr, k) : a, valid);
        } else {
#pragma unroll
          for (int b = 0; b < 16; ++b)
            dst[b] = b < valid ? a[walk.at(gr, k + b)] : 0;
        }
        // B: 16 8-column groups of GROUP bytes, one run in the codes each
        const signed char* b = bq +
                               ((size_t)in.src * ncols + n0) * kp +
                               (size_t)id * GROUP;
        signed char* bdst = Bs + ist * B_STAGE;
#pragma unroll
        for (int q = 0; q < B_STAGE / 16 / THREADS; ++q) {
          const int e = tid + q * THREADS, grp = e >> 5, w = e & 31;
          cp_async16(bdst + grp * GROUP + w * 16,
                     b + (size_t)grp * 8 * kp + w * 16, 16);
        }
        if (id == 0 && tid < BCOLS)
          cp_async4(scr + (iu % SC_RING) * BCOLS + tid,
                    bscale + (size_t)in.src * nct + my_ct);
      }
      ist = ist + 1 == STAGES ? 0 : ist + 1;
      if (++id == chunks) {
        id = 0;
        if (++iu < nslots) nxt = walk.info(blk, iu);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  int acc[32];
  float facc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    acc[q] = 0;
    facc[q] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < AHEAD; ++p) stage_next();
  int st = 0;
  for (int s = 0; s < nslots; ++s) {
    SlotInfo in{0, 0.f, 0};
    for (int d = 0; d < chunks; ++d) {
      // the products of the unit two back are done (its stage is free);
      // this unit has landed for every thread and is visible to wgmma
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      asm volatile("cp.async.wait_group %0;\n" ::"n"(AHEAD - 1));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      stage_next();
      in = sinfo[st];
      const signed char* A = As + st * A_STAGE;
      const signed char* B = Bs + st * B_STAGE + wg * (B_STAGE / 2);
      st = st + 1 == STAGES ? 0 : st + 1;
      if (in.live) {
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        wgmma_s8_n64(acc, core_desc(A, CORE, GROUP),
                     core_desc(B, CORE, GROUP), d > 0);
        wgmma_s8_n64(acc, core_desc(A + 2 * CORE, CORE, GROUP),
                     core_desc(B + 2 * CORE, CORE, GROUP), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    }
    if (!in.live) continue;
    // the slot's exact sums: rescale them into the f32 sums
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int q = 0; q < 32; ++q) asm volatile("" : "+r"(acc[q])::"memory");
    const float* sc = scr + (s % SC_RING) * BCOLS + wg * 64 + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 c = *reinterpret_cast<const float2*>(sc + j * 8);
      const float c0 = in.ws * c.x, c1 = in.ws * c.y;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        facc[4 * j + e] = fmaf(__int2float_rn(acc[4 * j + e]),
                               e & 1 ? c1 : c0, facc[4 * j + e]);
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + wr * 16 + g + h * 8;
    const size_t grow = (size_t)blk * walk.rows + r;
    if (r >= walk.rows || grow >= (size_t)out_rows) continue;
    float* o = out + grow * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + wg * 64 + j * 8 + 2 * t;
      const float v0 = facc[4 * j + 2 * h], v1 = facc[4 * j + 2 * h + 1];
      if (pairs && col + 1 < N) {
        *reinterpret_cast<float2*>(o + col) = make_float2(v0, v1);
      } else {
        if (col < N) o[col] = v0;
        if (col + 1 < N) o[col + 1] = v1;
      }
    }
  }
}

template <class Walk>
int launch_product(const Walk& w, dim3 grid, const void* bq,
                   const void* bscale, void* out, int out_rows, int N,
                   int ncols, int kp, int bn, int nct, cudaStream_t st) {
  if (grid.y > 65535 || kp % KSTEP || ncols % BCOLS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = STAGES * (A_STAGE + B_STAGE + sizeof(SlotInfo)) +
                      SC_RING * BCOLS * sizeof(float);
  const int err = set_smem(spmm_int8_wgmma_kernel<Walk>, smem);
  if (err) return err;
  spmm_int8_wgmma_kernel<Walk><<<grid, THREADS, smem, st>>>(
      w, (const signed char*)bq, (const float*)bscale, (float*)out, out_rows,
      N, ncols, kp, bn, nct);
  return (int)cudaGetLastError();
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

// Quantises nrt row tiles of x row-major (B17; those past `rows` are zero:
// scale 1e-30, codes 0).
int launch_quant(const float* x, int rows, int cols, int tr, int tc, int nrt,
                 float* scale, signed char* out, cudaStream_t stream) {
  const int nct = (cols + tc - 1) / tc;
  if (nrt > 65535) return (int)cudaErrorInvalidValue;
  quant_tiles_kernel<<<dim3(nct, nrt), THREADS, 0, stream>>>(
      x, rows, cols, tr, tc, nct, scale, out);
  return (int)cudaGetLastError();
}

}  // namespace stt

// The pre-pass of B16a (x = dense, tiles [bk, bn], nrt = kb) and B16b (x =
// g, tiles [bm, bq], nrt = mb): x [rows, cols] f32 -> scale [nrt, nct] and
// codes int8 [nrt, ncols, kp] (kp a multiple of 64 >= tr, ncols a multiple
// of 128 >= cols); tmax int32 [nrt * nct] is scratch.
extern "C" int quant_kmajor(const void* x, void* tmax, void* scale, void* out,
                            int rows, int cols, int tr, int tc, int nrt,
                            int kp, int ncols, void* stream) {
  return stt::launch_quant_kmajor((const float*)x, rows, cols, tr, tc, nrt,
                                  kp, ncols, (int*)tmax, (float*)scale,
                                  (signed char*)out, (cudaStream_t)stream);
}

// B16a. values_q [mb, max_bpr, bm, bk] int8, wscale [mb, max_bpr], the
// dense operand's pre-pass dq (kb row tiles of [ncols, kp] codes, core
// layout) / dscale [kb, nct] (kb = ceil(K / bk), nct = ceil(N / bn)), out
// [M, N] with M <= mb * bm.
extern "C" int spmm_panel_int8(const void* block_cols, const void* nblocks,
                               const void* values_q, const void* wscale,
                               const void* dq, const void* dscale, void* out,
                               int mb, int max_bpr, int bm, int bk, int kb,
                               int N, int bn, int M, void* stream) {
  const int kp = (bk + stt::KSTEP - 1) / stt::KSTEP * stt::KSTEP;
  const int ncols = (N + stt::BCOLS - 1) / stt::BCOLS * stt::BCOLS;
  const int aligned = bk % 16 == 0 && (uintptr_t)values_q % 16 == 0;
  stt::RowWalk w{(const int*)block_cols, (const int*)nblocks,
                 (const signed char*)values_q, (const float*)wscale,
                 max_bpr, kb, bm, bk, aligned};
  const dim3 grid(ncols / stt::BCOLS,
                  mb * ((bm + stt::BROWS - 1) / stt::BROWS));
  return stt::launch_product(w, grid, dq, dscale, out, M, N, ncols, kp, bn,
                             (N + bn - 1) / bn, (cudaStream_t)stream);
}

// B16b. g's pre-pass gq (mb row tiles of [ncols, kp] codes, tiles [bm, bq],
// kp = bm rounded up to 64) / gscale [mb, nqt], scratch vqt int8 [kb *
// max_bpc, bk8, kp] (the walk's tiles transposed, core layout; bk8 = bk
// rounded up to 8), out [rows, Q] with rows <= kb * bk; t_src_i / t_src_s
// [kb * max_bpc].
extern "C" int spmm_t_panel_int8(const void* t_src_i, const void* t_src_s,
                                 const void* t_nblocks, const void* values_q,
                                 const void* wscale, const void* gq,
                                 const void* gscale, void* vqt, void* out,
                                 int max_bpr, int kb, int max_bpc, int bm,
                                 int bk, int Q, int bq, int rows,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int kp = (bm + stt::KSTEP - 1) / stt::KSTEP * stt::KSTEP;
  const int ncols = (Q + stt::BCOLS - 1) / stt::BCOLS * stt::BCOLS;
  if (kb * max_bpc > 0) {
    const dim3 tgrid(kb * max_bpc, (bk + 63) / 64, kp / 64);
    stt::transpose_tiles_kernel<<<tgrid, stt::THREADS, 0, st>>>(
        (const int*)t_src_i, (const int*)t_src_s, (const int*)t_nblocks,
        (const signed char*)values_q, (signed char*)vqt, max_bpr, max_bpc, bm,
        bk, kp);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  stt::ColWalk w{(const int*)t_src_i, (const int*)t_src_s,
                 (const int*)t_nblocks, (const signed char*)vqt,
                 (const float*)wscale, max_bpr, max_bpc, kp, bk, bm, 1};
  const dim3 grid(ncols / stt::BCOLS,
                  kb * ((bk + stt::BROWS - 1) / stt::BROWS));
  return stt::launch_product(w, grid, gq, gscale, out, rows, Q, ncols, kp, bq,
                             (Q + bq - 1) / bq, st);
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
  int err = stt::launch_quant((const float*)lhs, M, D, bm, 128, mb,
                              (float*)lscale, (signed char*)lq, st);
  if (err) return err;
  const int kb = (Nr + bk - 1) / bk;
  err = stt::launch_quant((const float*)rhs, Nr, D, bk, 128, kb,
                          (float*)rscale, (signed char*)rq, st);
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
