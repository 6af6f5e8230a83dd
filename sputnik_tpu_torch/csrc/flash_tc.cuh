// Shared pieces of the split-TF32 flash kernels: the forward (B9, B11a:
// flash_sparse_fwd.cu) and the backward's row and column walks (B10a,
// B10b, B11b; B10c: flash_sparse_bwd.cu). The row walks read K and V, the
// column walk q * scale and dO, as split tiles that a pre-pass writes once
// a call in wgmma's core-matrix order (no swizzle), since a tile is
// visited by every walk that names it (32 times at the ring's full band):
// split once, not per visit.
#pragma once

#include "common.cuh"

namespace stt {

// Float offset of X[row][d] in a split operand with rows `row` and kp HD
// (16-byte granules of 4 columns): K as QK^T's B, V as dO V^T's B, and a
// 64 x 64 score tile stored [key][row] as the backward's dK / dV B.
template <int HD>
__device__ __forceinline__ int kcore(int key, int d) {
  return ((key >> 3) * (HD / 4) + (d >> 2)) * 32 + (key & 7) * 4 + (d & 3);
}

// Float offset of X[key][d] in a transposed half: rows d, kp 64 keys,
// where the k8 step j holds keys 8j + {0, 2, 4, 6} at positions 0-3 and
// 8j + {1, 3, 5, 7} at 4-7: the order of a score row in the accumulator,
// so p (forward, PV) or ds (backward, dS K) goes from the accumulator
// straight into the A fragments and the sum over keys is unchanged.
__device__ __forceinline__ int vcore(int d, int key) {
  const int kk = key & 7;
  const int pos = (key & ~7) + ((kk & 1) ? 4 + (kk >> 1) : (kk >> 1));
  return ((d >> 3) * 16 + (pos >> 2)) * 32 + (d & 7) * 4 + (pos & 3);
}

// floats of one split half (hi, then lo, 64 x HD each)
template <int HD>
__host__ __device__ constexpr int split_half() { return 2 * TILE * HD; }

// One 64-row tile of x ([nrows][hd] row-major, rows row0 ..; zero past
// nrows and hd), times mul, into S: read once, coalesced along the head
// dim (16 bytes a load where hd = HD and x is 16-byte aligned), every load
// of a thread in flight together. THREADS threads; S is visible to all of
// them on return.
template <int HD>
__device__ __forceinline__ void stage_tile(const float* __restrict__ x,
                                           int row0, int nrows, int hd,
                                           float mul, float (*S)[HD + 4]) {
  constexpr int PER = TILE * HD / THREADS;
  if (hd == HD && ((uintptr_t)x & 15) == 0) {  // whole rows: 16-byte loads
    float4 f[PER / 4];
#pragma unroll
    for (int n = 0; n < PER / 4; ++n) {
      const int e = threadIdx.x + n * THREADS, key = e / (HD / 4);
      const int gk = row0 + key;
      f[n] = gk < nrows ? *reinterpret_cast<const float4*>(
                              x + (size_t)gk * HD + (e % (HD / 4)) * 4)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int n = 0; n < PER / 4; ++n) {
      const int e = threadIdx.x + n * THREADS, d = (e % (HD / 4)) * 4;
      float* const at = &S[e / (HD / 4)][d];
      at[0] = f[n].x * mul;
      at[1] = f[n].y * mul;
      at[2] = f[n].z * mul;
      at[3] = f[n].w * mul;
    }
  } else {
    float f[PER];
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int e = threadIdx.x + n * THREADS, key = e / HD, d = e % HD;
      const int gk = row0 + key;
      f[n] = gk < nrows && d < hd ? x[(size_t)gk * hd + d] * mul : 0.f;
    }
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int e = threadIdx.x + n * THREADS;
      S[e / HD][e % HD] = f[n];
    }
  }
  __syncthreads();
}

// The staged tile S split into the half T: hi, then lo, each 64 x HD
// floats, [row][d] (kcore<HD>) or, with trans, [d][row] (vcore's row
// order); 16 bytes a thread, neighbouring threads on neighbouring 16-byte
// pieces. THREADS threads.
template <int HD>
__device__ __forceinline__ void write_split(const float (*S)[HD + 4],
                                            bool trans,
                                            float* __restrict__ T) {
  constexpr int PER = TILE * HD / THREADS;
  // piece g: row g & 7 of one 16-byte granule of one 8-row group
#pragma unroll
  for (int n = 0; n < PER / 4; ++n) {
    const int g = threadIdx.x + n * THREADS;
    float y[4];
    if (!trans) {  // row key, head dims 4 * kg ..
      const int kg = (g >> 3) % (HD / 4);
      const int key = (g >> 3) / (HD / 4) * 8 + (g & 7);
#pragma unroll
      for (int x4 = 0; x4 < 4; ++x4) y[x4] = S[key][4 * kg + x4];
    } else {  // row d, positions 4 * pg .. (vcore's key order)
      const int pg = (g >> 3) & 15, d = (g >> 7) * 8 + (g & 7);
#pragma unroll
      for (int x4 = 0; x4 < 4; ++x4) {
        const int pos = 4 * pg + x4, q = pos & 7;
        y[x4] = S[(pos & ~7) + (q < 4 ? 2 * q : 2 * (q - 4) + 1)][d];
      }
    }
    unsigned h[4], l[4];
#pragma unroll
    for (int x4 = 0; x4 < 4; ++x4) split_tf32(y[x4], h[x4], l[x4]);
    *reinterpret_cast<uint4*>(T + 4 * g) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(T + TILE * HD + 4 * g) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The pre-pass: key block c of KV replica rk, split into the halves
// h = blockIdx.z < gridDim.z of its tile kv[((rk * kb + c) * gridDim.z + h)
// * split_half] (zero past s_kv and hd). Bit h of v_mask: half h reads v
// (else k); bit h of t_mask: half h is written transposed ([d][key],
// vcore's key order), else [key][d] (kcore). The forward's tile is K, V^T
// (v_mask 0b10, t_mask 0b10); the backward's K, V, K^T (0b010, 0b100).
template <int HD>
__global__ void __launch_bounds__(THREADS)
split_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ kv, int s_kv, int hd, int kb, int v_mask,
                int t_mask) {
  __shared__ float S[TILE][HD + 4];
  const int c = blockIdx.x, rk = blockIdx.y, half = blockIdx.z;
  const bool from_v = (v_mask >> half) & 1, trans = (t_mask >> half) & 1;
  const float* const x = (from_v ? v : k) + (size_t)rk * s_kv * hd;
  stage_tile<HD>(x, c * TILE, s_kv, hd, 1.f, S);
  write_split<HD>(S, trans,
                  kv + (((size_t)rk * kb + c) * gridDim.z + half) *
                           split_half<HD>());
}

// One split half (split_half<HD> floats) global -> shared by cp.async, one
// commit group; NT threads.
template <int HD, int NT>
__device__ __forceinline__ void load_half(float* dst, const float* src) {
#pragma unroll 4
  for (int e = threadIdx.x; e < split_half<HD>() / 4; e += NT)
    cp_async16(dst + 4 * e, src + 4 * e, 16);
  asm volatile("cp.async.commit_group;\n" ::);
}

}  // namespace stt
