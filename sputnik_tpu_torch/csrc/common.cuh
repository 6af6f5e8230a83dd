// Shared pieces of the panel kernels: the 64 x 64 output tile that one
// block of 256 threads computes in FP32 FMA (or int8 __dp4a, below), 4 x 4
// outputs per thread.
//
// Operands are staged in shared memory "k-major": A as [k][row], B as
// [k][col], so that every thread reads its four rows and four columns of
// one k-slice as two float4 loads and issues 16 FMAs. Rows of the staging
// buffers are padded by 4 floats (TILE_LD) to spread the transposing stores
// over more banks while keeping the float4 reads 16-byte aligned.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace stt {

constexpr int TILE = 64;          // output tile edge (rows and columns)
constexpr int TILE_LD = TILE + 4; // padded row length of a staging buffer
constexpr int TK = 32;            // contraction depth staged per step
constexpr int THREADS = 256;      // 16 x 16 threads

// acc[i][j] += sum_k A[k][ty*4 + i] * B[k][tx*4 + j] over `depth` slices.
template <int DEPTH>
__device__ __forceinline__ void tile_fma(const float (*A)[TILE_LD],
                                         const float (*B)[TILE_LD],
                                         int ty, int tx, float acc[4][4]) {
#pragma unroll 8
  for (int k = 0; k < DEPTH; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&A[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&B[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

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

// Allow `kernel` `bytes` of dynamic shared memory (above 48 KB).
template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace stt
