// The KV append: one launch writes a decode step's tokens into a layer's
// cache, whatever the route. It casts or quantises each token by the cache
// write rule, writes the rows and their scales under the route's guard, and
// writes every replica's new length to a fresh int32[R] tensor.
//
// Replaces the TPU kernels
// sputnik_tpu/ops/pallas/ragged_append.py:ragged_append_kernel (B21) and
// sputnik_tpu/ops/pallas/paged_attention.py:paged_append_kernel (B20b),
// together with the composites around them: JAX's pad_quantize_tokens
// (sputnik_tpu/ops/decode.py), the guarded dynamic_update_slice of the
// uniform and speculative appends (append_kv with pos=, append_kv_seq), the
// paged write slot (_resolve_write) and the length updates.
//
// The cache write rule: fp32 and bf16 caches store the fp32 token cast
// round-to-nearest-even, with unit scales; int8 caches store
// clip(rint(x / s), -127, 127) with s = max(max|x|, 1e-30) / 127 over the
// token's row, an IEEE divide (this file is built without fast math).
//
// The address policies (a template argument of the one kernel), for replica
// r at length L = kv_len[r] and a draft of q >= 1 tokens:
//   UniformPos: one shared position p (a device scalar, or a host value),
//     rows clamp(p, 0, s_max - q) + t; written iff p <= s_max - q, or the
//     cache stays bit-identical. New length min(L + 1, s_max) for the
//     one-token append (append_kv), L + q if written else L for a draft
//     (append_kv_seq).
//   RaggedPos: one token at row L, written iff active[r] == 1 (no active:
//     every replica) and 0 <= L < s_max; new length L + active * (L < s_max).
//   PagedPos: token t at pool row page * bk + (L + t) % bk with page =
//     page_table[r, min((L + t) / bk, max_blocks - 1)]; the replica writes
//     its q tokens iff every one has a page (>= 0), L + t < max_blocks * bk
//     and active[r] == 1, else nothing anywhere (all or nothing: a partial
//     draft would desync rollback). New length L + q if written, else L.
//     A table id past the pool (>= P_alloc, which the allocator never hands
//     out) counts as a page, as in JAX's _resolve_write, but its token is
//     not stored: JAX's write clamps into its dump page, this one skips.
//
// What bounds it on an H100: the launch. At the serving shape (R = 32,
// hd = 128, fp32 tokens, bf16 cache) it moves about 48 KB, 1.5e-5 ms at
// 3.35 TB/s. So the design is one launch for the whole append of a layer:
// no pre-pass, no host sync (positions, pages and guards are read on the
// device), tokens read where they lie (strided fp32 or bf16 views of the
// QKV projection, converted in registers), and one block per replica that
// decides its own guard and writes its own length.
//
// The simple design: a block of 256 threads per replica. Thread 0 plans
// the replica (its guard into shared memory, its new length); then warp w
// takes the (token, K|V) rows w, w + 8, ...: for int8 the warp reduces
// max|x| by shuffles first. A lane stores 16 bytes at a time where
// hd, the cache base and the token views allow it, else one element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stt_append {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// plan(): whether replica r writes, and its new length (thread 0 of the
// block); row(): the destination row of its token t (any thread), or -1
// for a token that is not stored.
struct UniformPos {
  const int* pos;  // the shared position on the device, or null: pos_val
  int pos_val, s_max, seq;
  __device__ int p_raw() const { return pos ? *pos : pos_val; }
  __device__ bool plan(int, int L, int q, int* new_len) const {
    const bool fits = p_raw() <= s_max - q;
    *new_len = seq ? (fits ? L + q : L) : min(L + 1, s_max);
    return fits;
  }
  __device__ long long row(int r, int, int q, int t) const {
    return (long long)r * s_max + max(min(p_raw(), s_max - q), 0) + t;
  }
};

struct RaggedPos {
  const int* active;  // i32[R] or null (every replica writes)
  int s_max;
  __device__ bool plan(int r, int L, int, int* new_len) const {
    const int ok = active ? active[r] : 1;
    *new_len = L + ok * (L < s_max ? 1 : 0);
    return ok == 1 && L >= 0 && L < s_max;
  }
  __device__ long long row(int r, int L, int, int) const {
    return (long long)r * s_max + L;
  }
};

struct PagedPos {
  const int* table;   // i32[R, max_blocks]
  const int* active;  // i32[R] or null
  int bk, max_blocks, n_pages;
  __device__ int page(int r, int pos) const {
    return table[(long long)r * max_blocks + min(pos / bk, max_blocks - 1)];
  }
  __device__ bool plan(int r, int L, int q, int* new_len) const {
    bool fits = (active ? active[r] == 1 : true) && L >= 0;
    for (int t = 0; fits && t < q; ++t)
      fits = page(r, L + t) >= 0 && L + t < max_blocks * bk;
    *new_len = fits ? L + q : L;
    return fits;
  }
  __device__ long long row(int r, int L, int, int t) const {
    const int p = page(r, L + t);
    return p < n_pages ? (long long)p * bk + (L + t) % bk : -1;
  }
};

// The tokens [R, q, hd]: element strides of a replica and of a token (the
// last dim is unit-stride).
struct Tokens {
  const void* k;
  const void* v;
  int k_rs, k_ts, v_rs, v_ts;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename CacheT>
__device__ __forceinline__ CacheT encode(float x, float s);
template <>
__device__ __forceinline__ float encode<float>(float x, float) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 encode<__nv_bfloat16>(float x,
                                                               float) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ int8_t encode<int8_t>(float x, float s) {
  return (int8_t)fminf(fmaxf(rintf(x / s), -127.f), 127.f);
}

template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Pack {
  T x[N];
};

// One token row: its scale (int8: the warp's max|x| by shuffles) and its
// hd codes, 16 bytes a lane where `vec` allows.
template <typename TokT, typename CacheT>
__device__ __forceinline__ void write_row(const TokT* __restrict__ src,
                                          CacheT* __restrict__ dst,
                                          float* __restrict__ scale, int hd,
                                          int vec, int lane) {
  constexpr int VEC = 16 / sizeof(CacheT);
  float s = 1.f;
  if constexpr (sizeof(CacheT) == 1) {
    float m = 0.f;
    for (int i = lane; i < hd; i += 32) m = fmaxf(m, fabsf(to_f32(src[i])));
#pragma unroll
    for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(~0u, m, o));
    s = fmaxf(m, 1e-30f) / 127.f;
  }
  if (lane == 0) *scale = s;
  if (vec) {
    for (int c = lane; c < hd / VEC; c += 32) {
      const Pack<TokT, VEC> in =
          reinterpret_cast<const Pack<TokT, VEC>*>(src)[c];
      Pack<CacheT, VEC> out;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        out.x[j] = encode<CacheT>(to_f32(in.x[j]), s);
      reinterpret_cast<Pack<CacheT, VEC>*>(dst)[c] = out;
    }
  } else {
    for (int i = lane; i < hd; i += 32)
      dst[i] = encode<CacheT>(to_f32(src[i]), s);
  }
}

template <class Pos, typename TokT, typename CacheT>
__global__ void __launch_bounds__(THREADS)
kv_append_kernel(Pos pol, const int* __restrict__ kv_len,
                 int* __restrict__ new_len, Tokens tok, CacheT* __restrict__ k,
                 CacheT* __restrict__ v, float* __restrict__ ks,
                 float* __restrict__ vs, int q, int hd, int vec) {
  __shared__ int fits;
  const int r = blockIdx.x;
  const int L = kv_len[r];
  if (threadIdx.x == 0) {
    int len;
    fits = pol.plan(r, L, q, &len);
    new_len[r] = len;
  }
  __syncthreads();
  if (!fits) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < 2 * q; i += WARPS) {
    const int t = i >> 1;
    const bool is_v = i & 1;
    const TokT* src =
        static_cast<const TokT*>(is_v ? tok.v : tok.k) +
        (long long)r * (is_v ? tok.v_rs : tok.k_rs) +
        (long long)t * (is_v ? tok.v_ts : tok.k_ts);
    const long long at = pol.row(r, L, q, t);
    if (at < 0) continue;
    write_row(src, (is_v ? v : k) + at * hd, (is_v ? vs : ks) + at, hd, vec,
              lane);
  }
}

struct Launch {
  const int* kv_len;
  int* new_len;
  Tokens tok;
  void *k, *v;
  float *ks, *vs;
  int R, q, hd, vec;
  cudaStream_t stream;
};

template <class Pos, typename TokT, typename CacheT>
int launch_typed(const Pos& pol, const Launch& a) {
  kv_append_kernel<Pos, TokT, CacheT><<<a.R, THREADS, 0, a.stream>>>(
      pol, a.kv_len, a.new_len, a.tok, static_cast<CacheT*>(a.k),
      static_cast<CacheT*>(a.v), a.ks, a.vs, a.q, a.hd, a.vec);
  return (int)cudaGetLastError();
}

// tok_dtype: 0 f32, 1 bf16; cache_dtype: 0 f32, 1 bf16, 2 int8.
template <class Pos>
int launch(const Pos& pol, const Launch& a, int tok_dtype, int cache_dtype) {
  if (a.R == 0) return 0;
  if (a.q < 1 || tok_dtype < 0 || tok_dtype > 1 ||
      cache_dtype < 0 || cache_dtype > 2)
    return (int)cudaErrorInvalidValue;
  switch (tok_dtype * 3 + cache_dtype) {
    case 0: return launch_typed<Pos, float, float>(pol, a);
    case 1: return launch_typed<Pos, float, __nv_bfloat16>(pol, a);
    case 2: return launch_typed<Pos, float, int8_t>(pol, a);
    case 3: return launch_typed<Pos, __nv_bfloat16, float>(pol, a);
    case 4: return launch_typed<Pos, __nv_bfloat16, __nv_bfloat16>(pol, a);
    default: return launch_typed<Pos, __nv_bfloat16, int8_t>(pol, a);
  }
}

}  // namespace stt_append

// The contiguous routes (B21). k_tok / v_tok [R, q, hd] (f32 or bf16, unit
// last stride, element strides *_rs / *_ts); kv_len, new_len i32[R]; caches
// k / v [R, s_max, hd] (f32, bf16 or int8) and scales ks / vs f32[R, s_max].
// mode 0: ragged (q = 1; active i32[R] or null); 1: uniform one-token
// (append_kv with pos=); 2: uniform draft (append_kv_seq). pos: the shared
// position on the device, or null for pos_val. vec: hd a multiple of
// 16 / cache itemsize, the cache and the token views 16-byte aligned (the
// token views to their pack's size).
extern "C" int ragged_append(const void* k_tok, const void* v_tok,
                             const void* kv_len, const void* pos,
                             const void* active, void* new_len, void* k,
                             void* v, void* ks, void* vs, int k_rs, int k_ts,
                             int v_rs, int v_ts, int tok_dtype,
                             int cache_dtype, int R, int q, int hd, int s_max,
                             int mode, int pos_val, int vec, void* stream) {
  using namespace stt_append;
  const Launch a{(const int*)kv_len, (int*)new_len,
                 Tokens{k_tok, v_tok, k_rs, k_ts, v_rs, v_ts}, k, v,
                 (float*)ks, (float*)vs, R, q, hd, vec,
                 (cudaStream_t)stream};
  if (mode == 0) {
    if (q != 1) return (int)cudaErrorInvalidValue;
    return launch(RaggedPos{(const int*)active, s_max}, a, tok_dtype,
                  cache_dtype);
  }
  if (mode == 1 && q != 1) return (int)cudaErrorInvalidValue;
  return launch(UniformPos{(const int*)pos, pos_val, s_max, mode == 2}, a,
                tok_dtype, cache_dtype);
}

// The paged routes (B20b): tokens as for ragged_append; page_table
// i32[R, max_blocks]; active i32[R] or null; the pool k / v [n_pages, bk,
// hd] (n_pages = P_alloc, the dump page included) and its scales ks / vs
// f32[n_pages, bk].
extern "C" int paged_append(const void* k_tok, const void* v_tok,
                            const void* kv_len, const void* page_table,
                            const void* active, void* new_len, void* k,
                            void* v, void* ks, void* vs, int k_rs, int k_ts,
                            int v_rs, int v_ts, int tok_dtype,
                            int cache_dtype, int R, int q, int hd, int bk,
                            int max_blocks, int n_pages, int vec,
                            void* stream) {
  using namespace stt_append;
  const Launch a{(const int*)kv_len, (int*)new_len,
                 Tokens{k_tok, v_tok, k_rs, k_ts, v_rs, v_ts}, k, v,
                 (float*)ks, (float*)vs, R, q, hd, vec,
                 (cudaStream_t)stream};
  return launch(PagedPos{(const int*)page_table, (const int*)active, bk,
                         max_blocks, n_pages},
                a, tok_dtype, cache_dtype);
}
