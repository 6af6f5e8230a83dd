// KV appends: one token per replica written in place, into a per-replica
// block cache at that replica's own position (B21) or into a shared page
// pool at a (page, offset) slot (B20b).
//
// Replaces the TPU kernels
// sputnik_tpu/ops/pallas/ragged_append.py:ragged_append_kernel and
// sputnik_tpu/ops/pallas/paged_attention.py:paged_append_kernel.
//
// Ragged (B21): for each replica r, if pos[r] < s_max and ok[r] == 1, row
// pos[r] of k / v [R, s_max, hd] takes tok_k[r] / tok_v[r] ([R, hd], already
// in the cache's dtype) and entry pos[r] of the scales [R, s_max] takes
// tok_ks[r] / tok_vs[r]; otherwise the replica's cache is left bit-identical
// (a frozen continuous-batching slot, or a full one: a clamped write would
// overwrite its last real token). kv_len advances outside the kernel.
//
// Paged (B20b): for each replica r with ok[r] == 1, 0 <= page[r] < P_alloc
// and 0 <= off[r] < bk, row page[r] * bk + off[r] of the pool k / v
// [P_alloc, bk, hd] and of its scales [P_alloc, bk] takes the token; any
// other replica writes nothing at all. (The TPU kernel writes the old bytes
// back to a dump page, a rule of its pipelined grid; a one-row store here
// needs none.) Two writing replicas never share a row: the host scheduler
// gives each replica its own pages.
//
// What bounds both on an H100: nothing but the launch. They move
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

// Replica r's token into row `dst` of k / v and entry `dst` of the scales.
__device__ __forceinline__ void copy_token(
    int r, size_t dst, const uint8_t* __restrict__ tok_k,
    const uint8_t* __restrict__ tok_v, const float* __restrict__ tok_ks,
    const float* __restrict__ tok_vs, uint8_t* __restrict__ k,
    uint8_t* __restrict__ v, float* __restrict__ ks, float* __restrict__ vs,
    int row_bytes, int words) {
  const size_t src = (size_t)r * row_bytes;
  const size_t at = dst * row_bytes;
  if (words) {  // row_bytes % 4 == 0 and every base 4-byte aligned
    const int n = row_bytes / 4;
    const uint32_t* sk = reinterpret_cast<const uint32_t*>(tok_k + src);
    const uint32_t* sv = reinterpret_cast<const uint32_t*>(tok_v + src);
    uint32_t* dk = reinterpret_cast<uint32_t*>(k + at);
    uint32_t* dv = reinterpret_cast<uint32_t*>(v + at);
    for (int i = threadIdx.x; i < n; i += THREADS) {
      dk[i] = sk[i];
      dv[i] = sv[i];
    }
  } else {
    for (int i = threadIdx.x; i < row_bytes; i += THREADS) {
      k[at + i] = tok_k[src + i];
      v[at + i] = tok_v[src + i];
    }
  }
  if (threadIdx.x == 0) {
    ks[dst] = tok_ks[r];
    vs[dst] = tok_vs[r];
  }
}

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
  copy_token(r, (size_t)r * s_max + p, tok_k, tok_v, tok_ks, tok_vs, k, v, ks,
             vs, row_bytes, words);
}

__global__ void __launch_bounds__(THREADS)
paged_append_kernel(const int* __restrict__ page, const int* __restrict__ off,
                    const int* __restrict__ ok,
                    const uint8_t* __restrict__ tok_k,
                    const uint8_t* __restrict__ tok_v,
                    const float* __restrict__ tok_ks,
                    const float* __restrict__ tok_vs,
                    uint8_t* __restrict__ k, uint8_t* __restrict__ v,
                    float* __restrict__ ks, float* __restrict__ vs,
                    int n_pages, int bk, int row_bytes, int words) {
  const int r = blockIdx.x;
  const int p = page[r], o = off[r];
  if (ok[r] != 1 || p < 0 || p >= n_pages || o < 0 || o >= bk) return;
  copy_token(r, (size_t)p * bk + o, tok_k, tok_v, tok_ks, tok_vs, k, v, ks,
             vs, row_bytes, words);
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

// page / off / ok i32 [R], tok_k / tok_v [R, hd] and the pool k / v
// [n_pages, bk, hd] in one dtype of row_bytes bytes a row, tok_ks / tok_vs
// f32 [R], ks / vs f32 [n_pages, bk]; words as for ragged_append.
extern "C" int paged_append(const void* page, const void* off, const void* ok,
                            const void* tok_k, const void* tok_v,
                            const void* tok_ks, const void* tok_vs, void* k,
                            void* v, void* ks, void* vs, int R, int n_pages,
                            int bk, int row_bytes, int words, void* stream) {
  stt_append::paged_append_kernel<<<R, stt_append::THREADS, 0,
                                    (cudaStream_t)stream>>>(
      (const int*)page, (const int*)off, (const int*)ok,
      (const uint8_t*)tok_k, (const uint8_t*)tok_v, (const float*)tok_ks,
      (const float*)tok_vs, (uint8_t*)k, (uint8_t*)v, (float*)ks, (float*)vs,
      n_pages, bk, row_bytes, words);
  return (int)cudaGetLastError();
}
