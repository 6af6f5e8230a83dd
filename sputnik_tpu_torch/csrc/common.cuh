// Shared pieces of the panel kernels: the 64 x 64 output tile that one
// block of 256 threads computes in FP32 FMA, 4 x 4 outputs per thread.
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

}  // namespace stt
