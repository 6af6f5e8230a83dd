// Sparse softmax (B5): the row-wise softmax over the nonzeros of each CSR
// row, for R replicas of the values that share one topology.
//
// Replaces the TPU kernel
// sputnik_tpu/ops/pallas/ell_softmax.py:ell_softmax_panel. The TPU cannot
// gather, so it scatters the values into a row-padded ELL panel
// [m_pad, l_pad] with a mask, softmaxes the panel's rows and gathers back.
// Here a warp reads its row straight from the CSR order through row_offsets:
// no panel, no mask, no gather passes. The semantics are the TPU kernel's:
// the row max is clamped at -1e30 and the denominator at FLT_MIN, so a row
// with no slot writes nothing and a row of -inf scores gives zeros; the
// padding slots nnz..nnz_pad of every replica are written 0.
//
// values / out: f32 [R, nnz_pad], replica r at offset r * nnz_pad;
// row_offsets: i32 [m + 1] with row_offsets[m] == nnz.
//
// What bounds it on an H100: bytes. One read and one write of every stored
// score (8 bytes a nonzero and replica) plus row_offsets, and a handful of
// operations per score (max, exp, sum, divide).
//
// The simple design: one warp per (replica, row), eight warps a block. A row
// of up to 32 * REG slots (512) stays in registers: one read, one write. A
// longer row takes three strided passes over its slots (max, sum, write),
// the re-reads served by L2. Warp shuffles reduce the max and the sum. Warp
// m of each replica (one past the last row) zeroes the padding slots.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace stt_softmax {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int REG = 16;              // slots a lane holds: rows up to 512
constexpr float NEG_LARGE = -1e30f;  // the TPU kernel's masked score

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// max(s, FLT_MIN) that keeps a NaN sum NaN, as jnp.maximum does.
__device__ __forceinline__ float clamp_denom(float s) {
  return s < FLT_MIN ? FLT_MIN : s;
}

__global__ void __launch_bounds__(THREADS)
ell_softmax_kernel(const int* __restrict__ row_offsets,
                   const float* __restrict__ values, float* __restrict__ out,
                   int m, int nnz, int nnz_pad, long long n_warps) {
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (w >= n_warps) return;
  const int r = (int)(w / (m + 1));
  const int i = (int)(w % (m + 1));
  const float* v = values + (size_t)r * nnz_pad;
  float* o = out + (size_t)r * nnz_pad;
  if (i == m) {  // the padding slots
    for (int j = nnz + lane; j < nnz_pad; j += 32) o[j] = 0.f;
    return;
  }
  const int start = row_offsets[i];
  const int len = row_offsets[i + 1] - start;
  v += start;
  o += start;

  if (len <= 32 * REG) {
    float x[REG];
    float mx = NEG_LARGE;
#pragma unroll
    for (int t = 0; t < REG; ++t) {
      const int j = lane + 32 * t;
      x[t] = j < len ? v[j] : NEG_LARGE;
      mx = fmaxf(mx, x[t]);
    }
    mx = warp_max(mx);
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < REG; ++t) {
      const int j = lane + 32 * t;
      x[t] = j < len ? expf(x[t] - mx) : 0.f;
      s += x[t];
    }
    s = clamp_denom(warp_sum(s));
#pragma unroll
    for (int t = 0; t < REG; ++t) {
      const int j = lane + 32 * t;
      if (j < len) o[j] = x[t] / s;
    }
    return;
  }

  float mx = NEG_LARGE;
  for (int j = lane; j < len; j += 32) mx = fmaxf(mx, v[j]);
  mx = warp_max(mx);
  float s = 0.f;
  for (int j = lane; j < len; j += 32) s += expf(v[j] - mx);
  s = clamp_denom(warp_sum(s));
  for (int j = lane; j < len; j += 32) o[j] = expf(v[j] - mx) / s;
}

}  // namespace stt_softmax

// row_offsets i32 [m + 1], values / out f32 [R, nnz_pad] (contiguous);
// nnz = row_offsets[m] <= nnz_pad.
extern "C" int ell_softmax_f32(const void* row_offsets, const void* values,
                               void* out, int R, int m, int nnz, int nnz_pad,
                               void* stream) {
  using namespace stt_softmax;
  const long long n_warps = (long long)R * (m + 1);
  const long long blocks = (n_warps + WARPS - 1) / WARPS;
  if (blocks <= 0) return 0;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  ell_softmax_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)row_offsets, (const float*)values, (float*)out, m, nnz,
      nnz_pad, n_warps);
  return (int)cudaGetLastError();
}
