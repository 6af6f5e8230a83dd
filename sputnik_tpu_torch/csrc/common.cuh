// Shared pieces of the panel kernels.
//
// The SIMT tile (tile_dp4a): a 64 x 64 output tile that one block of 256
// threads computes in int8 __dp4a, 4 x 4 outputs per thread. Operands are
// staged in shared memory "k-major": A as [k][row], B as [k][col], so that
// every thread reads its four rows and four columns of one k-slice as two
// 16-byte loads. Rows of the staging buffers are padded by 4 words
// (TILE_LD) to spread the transposing stores over more banks while keeping
// the 16-byte reads aligned. tile_dp4a serves the int8 SDDMM (B17) and the
// int8 flash backward's dq (B18b); every fp32 kernel runs on the tensor
// cores (the split-TF32 pieces below).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stt {

constexpr int TILE = 64;          // output tile edge (rows and columns)
constexpr int TILE_LD = TILE + 4; // padded row length of a staging buffer
constexpr int TK = 32;            // contraction depth staged per step
constexpr int THREADS = 256;      // 16 x 16 threads

// --- int8 (W8A8) pieces: the same 64 x 64 tile, 4 x 4 outputs per thread,
// with operands staged as 32-bit words of four int8 values along the
// contraction and multiplied with __dp4a (exact int32 sums).

// acc[i][j] += sum_w dp4a(A[w][ty*4 + i], B[w][tx*4 + j]) over `WORDS` words.
template <int WORDS>
__device__ __forceinline__ void tile_dp4a(const int (*A)[TILE_LD],
                                          const int (*B)[TILE_LD], int ty,
                                          int tx, int acc[4][4]) {
#pragma unroll 8
  for (int w = 0; w < WORDS; ++w) {
    const int4 a = *reinterpret_cast<const int4*>(&A[w][ty * 4]);
    const int4 b = *reinterpret_cast<const int4*>(&B[w][tx * 4]);
    const int av[4] = {a.x, a.y, a.z, a.w};
    const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
  }
}

// The symmetric int8 code of x at a tile's scale: clip(rint(x / scale),
// -127, 127), a true IEEE divide and round-half-to-even, as the TPU
// kernels' jnp.round(x / scale).
__device__ __forceinline__ unsigned quant_i8(float x, float scale) {
  const float q = fminf(fmaxf(rintf(x / scale), -127.f), 127.f);
  return (unsigned)(unsigned char)(signed char)(int)q;
}

// A tile's dynamic scale from its absolute maximum: max(absmax / 127, 1e-30).
__device__ __forceinline__ float tile_scale(float absmax) {
  return fmaxf(absmax / 127.f, 1e-30f);
}

// Maximum of v over the block (every thread gets it); `red` holds one float
// per warp. It syncs before writing `red`, so calls may follow each other.
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

// --- the flash backward kernels' pieces (fp32 and int8).

// Row statistics of query row block i of replica r: m, max(l, 1e-30) and
// D = rowsum(g * out) (0 past s_q), one row per thread of the first 64.
__device__ __forceinline__ void stage_stats(float* Ms, float* Ls, float* Dr,
                                            const float* m, const float* l,
                                            const float* D, int r, int i,
                                            int mb, int s_q) {
  const int t = threadIdx.x;
  if (t < TILE) {
    const int gr = i * TILE + t;
    const size_t at = (size_t)r * mb * TILE + gr;
    Ms[t] = m[at];
    Ls[t] = fmaxf(l[at], 1e-30f);
    Dr[t] = gr < s_q ? D[(size_t)r * s_q + gr] : 0.f;
  }
}

// --- Hopper plumbing: cp.async and wgmma's shared-memory descriptor
// (the int8 products, bsr_spmm_int8.cu; cp.async also the fp32 SpMMs).

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared (L2 only), the last 16 - bytes of them
// zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes global -> shared (L1-cached); zero-filled where bytes is 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// wgmma's shared-memory descriptor of a K-major operand in core-matrix
// order, no swizzle: the core matrices of one k step lbo bytes apart,
// 8-row groups sbo bytes apart.
__device__ __forceinline__ uint64_t core_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

// --- the int8 tensor-core pieces (B16a, B16b: bsr_spmm_int8.cu; B18a:
// flash_sparse_int8.cu): codes K-major in wgmma's core-matrix order, no
// swizzle.

constexpr int CORE = 128;  // a core matrix: 8 rows x 16 code bytes

// Byte offset of (row, 16-byte granule kg) in the core-matrix layout of
// rows x kp codes: 8-row groups of kp / 16 core matrices, each 8 rows x 16
// bytes (wgmma's K-major layout without swizzle).
__device__ __forceinline__ size_t core_off(int row, int kg, int kp) {
  return ((size_t)(row >> 3) * (kp >> 4) + kg) * CORE + (row & 7) * 16;
}

// d (64 x 64 int32 over the warpgroup, 32 a thread) = a . b (+ d if acc):
// a 64 x 32 and b 64 x 32 int8 codes, both K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// The same, 64 x 32: b 32 x 32 codes (B18a's half tiles).
__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t da,
                                             uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x N int32) = a . b (+ d if acc) at N = 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da,
                                         uint64_t db, int acc) {
  if constexpr (N == 32) wgmma_s8_n32(d, da, db, acc);
  else wgmma_s8_n64(d, da, db, acc);
}

// Quantise the 64-row tile x[row0 + row][d] * mul (0 for rows >= nrows or
// d >= hd) at max(absmax / 127, 1e-30), which it returns to every thread,
// and write its codes in wgmma's core-matrix order: K-major [row][d] into
// kmaj (rows 64, kp HD) and transposed [d][row] into trans (rows HD, kp
// 64), each where not null. THREADS threads; the tile is read once
// (every load of a thread in flight together), staged in S, and written
// 16 bytes a thread. B18a's K / V^T codes (quant_kv_kernel) and B18c's
// row-block codes (quant_rows_kernel).
template <int HD>
__device__ __forceinline__ float quant_codes_tile(
    const float* __restrict__ x, int row0, int nrows, int hd, float mul,
    signed char* kmaj, signed char* trans, unsigned char (*S)[HD + 16],
    float* red) {
  constexpr int PER = TILE * HD / THREADS;
  const int tid = threadIdx.x;
  float f[PER];
  float mx = 0.f;
#pragma unroll
  for (int n = 0; n < PER; ++n) {
    const int e = tid + n * THREADS, row = e / HD, d = e % HD;
    const int gr = row0 + row;
    f[n] = gr < nrows && d < hd ? x[(size_t)gr * hd + d] * mul : 0.f;
    mx = fmaxf(mx, fabsf(f[n]));
  }
  const float sc = tile_scale(block_max(mx, red));
#pragma unroll
  for (int n = 0; n < PER; ++n) {
    const int e = tid + n * THREADS;
    S[e / HD][e % HD] = (unsigned char)quant_i8(f[n], sc);
  }
  __syncthreads();
  if (kmaj != nullptr) {
    for (int e = tid; e < TILE * HD / 16; e += THREADS) {
      const int row = e / (HD / 16), kg = e % (HD / 16);
      *reinterpret_cast<uint4*>(kmaj + core_off(row, kg, HD)) =
          *reinterpret_cast<const uint4*>(&S[row][kg * 16]);
    }
  }
  if (trans != nullptr) {
    for (int e = tid; e < HD * TILE / 16; e += THREADS) {
      const int d = e % HD, kg = e / HD;
      unsigned wd[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        wd[q] = 0u;
#pragma unroll
        for (int y = 0; y < 4; ++y)
          wd[q] |= (unsigned)S[kg * 16 + q * 4 + y][d] << (8 * y);
      }
      *reinterpret_cast<uint4*>(trans + core_off(d, kg, TILE)) =
          make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
  return sc;
}

// --- split TF32 ("3xTF32"): fp32 products on the tensor cores (B1, B3 and
// the bodies they share). One TF32 rounding (10 mantissa bits, a relative
// 2^-11) misses the kernels' 1e-4 * max|out| at a 4096-deep contraction;
// x = hi + lo and the three products hi.hi + hi.lo + lo.hi leave an error
// near fp32's own (lo.lo, below 2^-21 relative, is dropped).

// hi = x rounded to TF32, to nearest with ties away (cvt.rna.tf32.f32's
// result for finite x, by two integer operations at full rate: cvt runs
// on the conversion pipe at an eighth of it); lo = x - hi, exact in f32,
// which the tensor core reads as TF32 by dropping its low 13 bits.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// The tensor-core SpMM block (spmm_tc_kernel: B1 and the bodies on its
// address policies; spmm_t_tc_kernel: B3 and its): WG warpgroups of 128
// threads, each computing 64 output columns (dense columns for B1, columns
// of G for B3) x the 64 output rows of one slice, so BN = 64 * WG columns a
// block, with wgmma.mma_async m64n64k8 TF32. wgmma reads a TF32 operand
// from shared memory K-major only, and neither direction's dense operand
// ([k][n], n contiguous) is; so the roles swap: wgmma's A (64 x 8, from
// registers, any layout) is the dense rows, loaded from their staged copy
// into registers and split there (tc_frags), and its B (8 x 64, shared
// memory) is the panel tile, split into hi and lo once a unit by the block
// (tc_split_tile) and written K-major in core-matrix order (8 rows x 16
// bytes, 8-row groups TC_GROUP bytes apart, no swizzle). The accumulator
// holds the output transposed: thread (warp w, lane 4g + t) holds, for n8
// chunk j and e < 4, dense column 16w + g + 8(e >> 1) of output row 8j +
// 2t + (e & 1). A unit is TC_BK of contraction; units pass through a
// TC_STAGES-deep cp.async ring as they lie in global memory: the tile's
// slice ([m][k] for B1, TC_LDA floats a row; [k][m] for B3, TC_LDAT) and
// the dense rows ([k][n], tc_ldb floats a row). The pads keep the fragment
// loads and the split pass on distinct banks and the rows 16-byte aligned.
constexpr int TC_BK = 32;
constexpr int TC_STAGES = 3;        // the raw ring
constexpr int TC_LDA = TC_BK + 4;   // B1's tile slice [m][k]
constexpr int TC_LDAT = TILE + 8;   // B3's tile slice [k][m]
constexpr int TC_A = TILE * TC_LDA > TC_BK * TC_LDAT ? TILE * TC_LDA
                                                     : TC_BK * TC_LDAT;
constexpr int TC_SB = TILE * TC_BK;  // floats of a split tile, hi or lo
constexpr int TC_KS = TC_BK / 8;     // wgmma k steps a unit
constexpr unsigned TC_CORE = 128;    // bytes of a core matrix: 8 rows x 16
constexpr unsigned TC_GROUP = TC_BK / 4 * TC_CORE;  // an 8-row group

__host__ __device__ constexpr int tc_ldb(int wg) { return 64 * wg + 8; }
__host__ __device__ constexpr int tc_b(int wg) { return TC_BK * tc_ldb(wg); }
// floats of one stage of the A operand's raw ring: [k][n] (B1, B3) or, with
// rows, [n][k] (the SDDMM: 64 rows a warpgroup)
__host__ __device__ constexpr int tc_bstage(int wg, bool rows) {
  return rows ? 64 * wg * TC_LDA : tc_b(wg);
}
// two split tiles (hi, lo each) and the raw ring
__host__ __device__ constexpr size_t tc_smem(int wg, bool rows = false) {
  return ((size_t)4 * TC_SB + TC_STAGES * (TC_A + tc_bstage(wg, rows))) *
         sizeof(float);
}

// d (64 x 64 f32 over the warpgroup, 32 a thread) = a . b (+ d if acc):
// a 64 x 8 TF32 in registers (a0: row g, k t; a1: row g + 8, k t; a2, a3:
// k t + 4, per warp's 16 rows), b 8 x 64 TF32 K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const unsigned (&a)[4],
                                               uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// The same, 64 x 128: b 8 x 128 (the flash forward's PV at a head dim of
// 128).
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const unsigned (&a)[4],
                                                uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x N f32) = a . b (+ d if acc), a from registers, at N = 64 or 128.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const unsigned (&a)[4],
                                              uint64_t db, int acc) {
  if constexpr (N == 64) wgmma_tf32_n64(d, a, db, acc);
  else wgmma_tf32_n128(d, a, db, acc);
}

// d (64 x 64 f32) = a . b (+ d if acc) with both operands TF32 K-major in
// shared memory (the flash forward's QK^T: a the query rows, b the keys).
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da,
                                                  uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// One unit's tile slice (raw, as staged) split into hi and lo, each 64 rows
// (B1: output rows m; B3 (AT): tile columns) x TC_BK in core-matrix order;
// one 16-byte piece (a row's 4 contraction values) a step, 8 threads on
// one 128-byte run.
template <bool AT, int NTHREADS>
__device__ __forceinline__ void tc_split_tile(const float* __restrict__ raw,
                                              float* __restrict__ hi,
                                              float* __restrict__ lo) {
#pragma unroll
  for (int e = threadIdx.x; e < TILE * TC_BK / 4; e += NTHREADS) {
    const int kg = e >> 6, row = e & 63;
    float v[4];
    if (AT) {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = raw[(kg * 4 + i) * TC_LDAT + row];
    } else {
      const float4 x =
          *reinterpret_cast<const float4*>(raw + row * TC_LDA + kg * 4);
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    }
    unsigned h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(v[i], h[i], l[i]);
    const int off = ((row >> 3) * (TC_BK / 4) + kg) * 32 + (row & 7) * 4;
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// A warpgroup's A fragments of one unit, split: hi and lo of each k step.
struct TcFrag {
  unsigned h[TC_KS][4], l[TC_KS][4];
};

// The fragments of this warpgroup's 64 A rows n0w.. (B1, B3: dense
// columns) from their staged unit bs: [k][n], LDB floats a row, or with
// AROWS [n][k], TC_LDA floats a row (the SDDMM's rhs rows, K-major as they
// lie in memory; TC_LDA = 36 keeps the lanes' reads on distinct banks).
template <int LDB, bool AROWS = false>
__device__ __forceinline__ void tc_frags(const float* __restrict__ bs,
                                         int n0w, TcFrag& f) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int s = 0; s < TC_KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = s * 8 + t + (i >> 1) * 4;
      const int n = n0w + w * 16 + g + (i & 1) * 8;
      split_tf32(AROWS ? bs[n * TC_LDA + k] : bs[k * LDB + n], f.h[s][i],
                 f.l[s][i]);
    }
}

// acc += dense^T . tile over one unit (the first of a slot overwrites acc)
// in split TF32: each k step issues hi.hi, then hi.lo, then lo.hi into the
// same accumulators. Waits for them; the accumulators and the fragments
// they read stay in their registers until then.
__device__ __forceinline__ void tc_mma(const float* hi, const float* lo,
                                       TcFrag& f, float (&acc)[32],
                                       bool first) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < TC_KS; ++s) {
    // the step's two core matrices along k, 2 x TC_CORE bytes a step
    const uint64_t dh = core_desc(hi + s * 64, TC_CORE, TC_GROUP);
    const uint64_t dl = core_desc(lo + s * 64, TC_CORE, TC_GROUP);
    wgmma_tf32_n64(acc, f.h[s], dh, !(first && s == 0));
    wgmma_tf32_n64(acc, f.h[s], dl, 1);
    wgmma_tf32_n64(acc, f.l[s], dh, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int q = 0; q < 32; ++q) asm volatile("" : "+f"(acc[q])::"memory");
#pragma unroll
  for (int s = 0; s < TC_KS; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("" : "+r"(f.h[s][i]), "+r"(f.l[s][i])::"memory");
}

// One output block's walk of `units` TC_BK-deep units (`chunks` a slot),
// staged by load_next() (one cp.async group a call, unit by unit into the
// ring's next stage): facc = the f32 sum of the slots' tensor-core sums.
// At unit u, after one barrier, the block stages unit u + TC_STAGES - 1
// and splits unit u + 1's tile into the other split buffer; each
// warpgroup loads unit u's fragments, issues its products (on the tile
// split at unit u - 1) and waits for them, while the SM's other block and
// warpgroups keep the tensor cores busy. A slot's sums are added into facc
// after its last unit. No branch encloses a product, a wait or a register
// a product reads (ptxas would serialize the products otherwise): a
// warpgroup whose columns lie past the output multiplies zeros. AROWS: the
// A operand is staged as rows ([n][k], tc_bstage's layout; the SDDMM).
template <bool AT, int WG, typename Load, bool AROWS = false>
__device__ __forceinline__ void tc_walk(int units, int chunks,
                                        Load& load_next, float* smem,
                                        float (&facc)[32]) {
  constexpr int NTHREADS = 128 * WG, LDB = tc_ldb(WG);
  constexpr int BST = tc_bstage(WG, AROWS);
  float* const Sb = smem;                        // [2][hi, lo][TC_SB]
  const float* const As = smem + 4 * TC_SB;      // [TC_STAGES][TC_A]
  const float* const Bs = As + TC_STAGES * TC_A; // [TC_STAGES][BST]
  const int n0w = (threadIdx.x >> 7) * 64;
  float acc[32];
#pragma unroll
  for (int q = 0; q < 32; ++q) acc[q] = facc[q] = 0.f;
#pragma unroll
  for (int p = 0; p < TC_STAGES - 1; ++p) load_next();
  if (units == 0) return;
  asm volatile("cp.async.wait_group %0;\n" ::"n"(TC_STAGES - 2));
  __syncthreads();
  tc_split_tile<AT, NTHREADS>(As, Sb, Sb + TC_SB);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  int st = 0;
  for (int u = 0; u < units; ++u) {
    // unit u + 1 has landed; every warpgroup's products of unit u - 1 are
    // done, so its raw stage and split buffer are free
    asm volatile("cp.async.wait_group %0;\n" ::"n"(TC_STAGES - 3));
    __syncthreads();
    load_next();
    const int nst = st + 1 == TC_STAGES ? 0 : st + 1;
    if (u + 1 < units) {
      float* nb = Sb + ((u + 1) & 1) * 2 * TC_SB;
      tc_split_tile<AT, NTHREADS>(As + nst * TC_A, nb, nb + TC_SB);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    TcFrag f;
    tc_frags<LDB, AROWS>(Bs + st * BST, n0w, f);
    const float* sb = Sb + (u & 1) * 2 * TC_SB;
    tc_mma(sb, sb + TC_SB, f, acc, u % chunks == 0);
    const bool last = (u + 1) % chunks == 0;
#pragma unroll
    for (int q = 0; q < 32; ++q) facc[q] += last ? acc[q] : 0.f;
    st = nst;
  }
}

// A thread's 4-float piece of a staged row: columns col .. col + 3 of the
// row at src (src points at column col), zero past `limit` columns or where
// the row is out of range (row_ok false); `safe` is any valid address, read
// for nothing. `vec`: one 16-byte copy (src 16-byte aligned, limit a
// multiple of 4), else four 4-byte copies.
__device__ __forceinline__ void tc_stage4(float* dst, const float* src,
                                          const float* safe, bool row_ok,
                                          int col, int limit, bool vec) {
  if (vec) {
    const bool ok = row_ok && col < limit;
    cp_async16(dst, ok ? src : safe, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool ok = row_ok && col + q < limit;
      cp_async4(dst + q, ok ? src + q : safe, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void swap2(float& a, float& b) {
  const float c = a;
  a = b;
  b = c;
}

// Inside each quad of lanes g = 4a .. 4a + 3 (same t; b = g & 3, lanes 4
// apart): lane b's x[c] becomes lane c's x[b]. Applied to x = acc[4j ..
// 4j + 3] of a wgmma accumulator (A rows 16w + g (+ 8) x B rows 8j + 2t
// (+ 1)), lane b then holds A rows 16w + 4 (g >> 2) + 8 (b >> 1) .. + 3 of
// B row 8j + 2t + (b & 1): four neighbours for one 16-byte access.
__device__ __forceinline__ void quad_transpose(float (&x)[4], int b) {
  if (b & 1) {
    swap2(x[0], x[1]);
    swap2(x[2], x[3]);
  }
  x[1] = __shfl_xor_sync(0xffffffffu, x[1], 4);
  x[3] = __shfl_xor_sync(0xffffffffu, x[3], 4);
  if (b & 1) {
    swap2(x[0], x[1]);
    swap2(x[2], x[3]);
  }
  if (b & 2) {
    swap2(x[0], x[2]);
    swap2(x[1], x[3]);
  }
  x[2] = __shfl_xor_sync(0xffffffffu, x[2], 8);
  x[3] = __shfl_xor_sync(0xffffffffu, x[3], 8);
  if (b & 2) {
    swap2(x[0], x[2]);
    swap2(x[1], x[3]);
  }
}

// Allow `kernel` `bytes` of dynamic shared memory (above 48 KB).
template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace stt
