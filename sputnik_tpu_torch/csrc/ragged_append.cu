// Ragged KV append: one token per replica written in place at that
// replica's own position.
//
// Replaces the TPU kernel
// sputnik_tpu/ops/pallas/ragged_append.py:ragged_append_kernel. For each
// replica r: if pos[r] < s_max and ok[r] == 1, row pos[r] of k / v
// [R, s_max, hd] takes tok_k[r] / tok_v[r] ([R, hd], already in the cache's
// dtype) and entry pos[r] of the scales [R, s_max] takes tok_ks[r] /
// tok_vs[r]; otherwise the replica's cache is left bit-identical (a frozen
// continuous-batching slot, or a full one: a clamped write would overwrite
// its last real token). kv_len advances outside the kernel.
//
// What bounds it on an H100: nothing but the launch. It moves
// R * 2 * hd * itemsize bytes (64 KiB at R = 32, hd = 128, bf16). A row is
// copied as bytes, so one kernel serves the f32, bf16 and int8 caches.
//
// The simple design: one block of 128 threads per replica; the threads
// stride over the row's bytes, four at a time where the row and both
// pointers allow it; thread 0 writes the two scales.
#include <cuda_runtime.h>
#include <stdint.h>

namespace stt_append {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
ragged_append_kernel(const int* __restrict__ pos, const int* __restrict__ ok,
                     const uint8_t* __restrict__ tok_k,
                     const uint8_t* __restrict__ tok_v,
                     const float* __restrict__ tok_ks,
                     const float* __restrict__ tok_vs,
                     uint8_t* __restrict__ k, uint8_t* __restrict__ v,
                     float* __restrict__ ks, float* __restrict__ vs,
                     int s_max, int row_bytes, int words) {
  const int r = blockIdx.x;
  const int p = pos[r];
  if (p < 0 || p >= s_max || ok[r] != 1) return;
  const size_t src = (size_t)r * row_bytes;
  const size_t dst = ((size_t)r * s_max + p) * row_bytes;
  if (words) {  // row_bytes % 4 == 0 and every base 4-byte aligned
    const int n = row_bytes / 4;
    const uint32_t* sk = reinterpret_cast<const uint32_t*>(tok_k + src);
    const uint32_t* sv = reinterpret_cast<const uint32_t*>(tok_v + src);
    uint32_t* dk = reinterpret_cast<uint32_t*>(k + dst);
    uint32_t* dv = reinterpret_cast<uint32_t*>(v + dst);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      dk[i] = sk[i];
      dv[i] = sv[i];
    }
  } else {
    for (int i = threadIdx.x; i < row_bytes; i += THREADS) {
      k[dst + i] = tok_k[src + i];
      v[dst + i] = tok_v[src + i];
    }
  }
  if (threadIdx.x == 0) {
    ks[(size_t)r * s_max + p] = tok_ks[r];
    vs[(size_t)r * s_max + p] = tok_vs[r];
  }
}

}  // namespace stt_append

// pos / ok i32 [R], tok_k / tok_v [R, hd] and k / v [R, s_max, hd] in one
// dtype of row_bytes = hd * itemsize bytes a row, tok_ks / tok_vs f32 [R],
// ks / vs f32 [R, s_max]. words: row_bytes % 4 == 0 and the four row
// buffers 4-byte aligned.
extern "C" int ragged_append(const void* pos, const void* ok,
                             const void* tok_k, const void* tok_v,
                             const void* tok_ks, const void* tok_vs, void* k,
                             void* v, void* ks, void* vs, int R, int s_max,
                             int row_bytes, int words, void* stream) {
  stt_append::ragged_append_kernel<<<R, stt_append::THREADS, 0,
                                     (cudaStream_t)stream>>>(
      (const int*)pos, (const int*)ok, (const uint8_t*)tok_k,
      (const uint8_t*)tok_v, (const float*)tok_ks, (const float*)tok_vs,
      (uint8_t*)k, (uint8_t*)v, (float*)ks, (float*)vs, s_max, row_bytes,
      words);
  return (int)cudaGetLastError();
}
