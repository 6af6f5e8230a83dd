// Sparse-flash attention backward: dq, dk, dv of
// out = softmax(q k^T * scale, masked) @ v, recomputing each occupied score
// tile from the forward's row statistics (running max m, denominator l);
// scores and probabilities are never written out.
//
// Replaces three TPU kernels of sputnik_tpu/ops/pallas/flash_sparse.py:
//   flash_sparse_bwd_fused -> flash_bwd_rows_kernel<HD, true>  (dq, dk, dv)
//   flash_sparse_bwd_dq    -> flash_bwd_rows_kernel<HD, false> (dq)
//   flash_sparse_bwd_dkv   -> flash_bwd_dkv_kernel<HD>         (dk, dv)
// q and g are [R, s_q, hd], k and v [R / group, s_kv, hd] (GQA: query
// replica r reads KV replica r / group), m and l [R, mb * 64] as the forward
// writes them, D = rowsum(g * out) [R, s_q]. dq is the gradient with
// respect to q * scale (the caller multiplies by scale, as JAX does); dk and
// dv are summed straight into their KV replica, [R / group, s_kv, hd].
// Per occupied 64 x 64 tile, with sc = (q * scale) k^T masked to -1e30:
//   p  = exp(sc - m) / max(l, 1e-30), forced to 0 where sc <= -5e29
//   ds = p * (g v^T - D)
//   dq += ds k,  dk += ds^T (q * scale),  dv += p^T g.
// The forced 0 is load-bearing: a fully-masked row has m = -1e30 and l = 0,
// so exp(sc - m) / 1e-30 would be 1e30; with it, such a row's dq is exactly
// 0 and it adds nothing to dk / dv.
//
// What bounds them on an H100: per occupied tile, 10 x 64^2 x hd FLOPs
// (two score products and three gradient products) against four 64 x hd
// operand tiles from L2/HBM and 64^2 exp() calls. At the reference
// transformer's shapes (R = 32, s = 512, hd = 64, causal: 36 tiles per
// replica) the call is ~3 GFLOP over 256 blocks: latency- and
// occupancy-bound, like the forward.
//
// The simple design, FP32 FMA. All operand tiles sit row-major in shared
// memory ([64][hd + 4]); each product picks the thread mapping that reads
// them without bank conflicts: the score tiles give thread (ty, tx) rows
// ty * 4 + i and keys tx + 16 * j; the gradient products give it four rows
// (dq) or four keys (dk, dv) and hd / 16 consecutive head dims.
//   * flash_bwd_rows_kernel: one block per (query row block i, replica r),
//     walking the forward's row metadata over slots s < nblocks[b, i] (a
//     padded slot repeats the last column: walking past nblocks would add
//     that tile's dk / dv twice). dq stays in registers. A TPU core keeps
//     the whole replica's dk / dv resident in VMEM (2 * n_pad * hd * 4
//     bytes: 256 KiB at the driver shape, above a block's 227 KiB of shared
//     memory), so the fused variant atomicAdds each tile's dk / dv into
//     zero-initialised fp32 global buffers instead. The summation order of
//     those atomics varies from run to run: results agree with the plain
//     version to rounding, not bitwise. With WITH_KV = false it is the dq
//     kernel, with no atomics.
//   * flash_bwd_dkv_kernel: one block per (key column block j, KV replica),
//     walking the transposed metadata (build_flash_bwd_meta) of each query
//     replica of its group over slots u < t_nblocks[b, j]; it gathers the
//     q / g / m / l / D rows of each source row block and keeps dk / dv in
//     registers: no atomics, and a column no query attends writes 0.
// Rows past s_q and keys past s_kv are bound-checked, never padded in
// memory. hd <= 128 (templates 32 / 64 / 128, as the forward).
//
// Ring band (B11b): also replaces
// sputnik_tpu/ops/pallas/flash_sparse.py:flash_sparse_ring_band_bwd, one
// step of the ring backward (parallel/ring_flash.py): the fused row walk
// with CARRY = true over one key band's tiles, recomputing p from the
// FINAL m, l of the whole ring's forward, with D = rowsum(g * out). It
// advances the three gradient carries in place: dq [R, mb * 64, hd] is
// read and added to once per row block, dk / dv [R, s_kv, hd] (the band's
// accumulators, rotating with the band) take the tiles' fp32 atomics
// without being zeroed first. q comes pre-scaled (scale = 1); the band's
// metadata is one mask for every replica; group 1 only, as on the TPU
// (GQA rings run B10b + B10c and sum the group). Its bound is B10a's on
// the band's tiles plus the carries' read and write.
#include "common.cuh"

namespace stt {

constexpr float NEG_LARGE = -1e30f;
constexpr int PLD = TILE + 4;  // row length of the p / ds tiles

template <int HD>
constexpr int BWD_LD = HD + 4;  // row length of the operand tiles

template <int HD>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * TILE * BWD_LD<HD> + 2 * TILE * PLD + 3 * TILE);
}

// dst[row][d] = src[row0 + row][d] * mul for rows < nrows, d < hd; else 0.
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int nrows, int hd,
                                           float mul) {
  for (int e = threadIdx.x; e < TILE * HD; e += THREADS) {
    const int row = e / HD, d = e % HD, gr = row0 + row;
    dst[row * BWD_LD<HD> + d] =
        (gr < nrows && d < hd) ? src[(size_t)gr * hd + d] * mul : 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// acc[i][j] = sum_d A[ty*4 + i][d] * B[tx + 16*j][d] over row-major tiles.
template <int HD>
__device__ __forceinline__ void rows_dot(const float* A, const float* B,
                                         int ty, int tx, float acc[4][4]) {
  constexpr int LD = BWD_LD<HD>;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
      a[ii] = *reinterpret_cast<const float4*>(&A[(ty * 4 + ii) * LD + d]);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      b[jj] = *reinterpret_cast<const float4*>(&B[(tx + 16 * jj) * LD + d]);
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = dot4(a[ii], b[jj], acc[ii][jj]);
  }
}

// Recompute p and ds of one tile into Ps / Ds ([row][key]). pm is the
// tile's element mask (row-major 64 x 64), or null for a full tile.
template <int HD>
__device__ __forceinline__ void score_tile(const float* Qs, const float* Gs,
                                           const float* Ks, const float* Vs,
                                           const float* Ms, const float* Ls,
                                           const float* Dr, const float* pm,
                                           float* Ps, float* Ds) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float sc[4][4] = {}, dp[4][4] = {};
  rows_dot<HD>(Qs, Ks, ty, tx, sc);
  rows_dot<HD>(Gs, Vs, ty, tx, dp);
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = ty * 4 + ii;
    const float mr = Ms[row], lr = Ls[row], dr = Dr[row];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int key = tx + 16 * jj;
      float s = sc[ii][jj];
      if (pm != nullptr && pm[row * TILE + key] == 0.f) s = NEG_LARGE;
      const float p = s <= NEG_LARGE / 2 ? 0.f : expf(s - mr) / lr;
      Ps[row * PLD + key] = p;
      Ds[row * PLD + key] = p * (dp[ii][jj] - dr);
    }
  }
}

// acc[i][j] += sum_key W[ty*4 + i][key] * X[key][tx*CPT + j]   (dq = ds k)
template <int HD>
__device__ __forceinline__ void acc_rows(const float* W, const float* X,
                                         float acc[4][HD / 16]) {
  constexpr int CPT = HD / 16, LD = BWD_LD<HD>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int key = 0; key < TILE; ++key) {
    float a[4], x[CPT];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) a[ii] = W[(ty * 4 + ii) * PLD + key];
#pragma unroll
    for (int jj = 0; jj < CPT; jj += 2) {
      const float2 t = *reinterpret_cast<const float2*>(&X[key * LD + tx * CPT + jj]);
      x[jj] = t.x;
      x[jj + 1] = t.y;
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) acc[ii][jj] = fmaf(a[ii], x[jj], acc[ii][jj]);
  }
}

// acc[i][j] += sum_row W[row][ty*4 + i] * X[row][tx*CPT + j]
// (dk = ds^T (q * scale), dv = p^T g)
template <int HD>
__device__ __forceinline__ void acc_keys(const float* W, const float* X,
                                         float acc[4][HD / 16]) {
  constexpr int CPT = HD / 16, LD = BWD_LD<HD>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int row = 0; row < TILE; ++row) {
    const float4 w4 = *reinterpret_cast<const float4*>(&W[row * PLD + ty * 4]);
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
    float x[CPT];
#pragma unroll
    for (int jj = 0; jj < CPT; jj += 2) {
      const float2 t = *reinterpret_cast<const float2*>(&X[row * LD + tx * CPT + jj]);
      x[jj] = t.x;
      x[jj + 1] = t.y;
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) acc[ii][jj] = fmaf(w[ii], x[jj], acc[ii][jj]);
  }
}

// How store_tile lands a tile.
enum Store { STORE_WRITE, STORE_ADD, STORE_ATOMIC };

// Write, add (one owner per element: a carried dq) or atomically add a
// [4 keys/rows][CPT dims] register tile.
template <int HD, Store MODE>
__device__ __forceinline__ void store_tile(float* dst, int row0, int nrows,
                                           int hd, float acc[4][HD / 16]) {
  constexpr int CPT = HD / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int gr = row0 + ty * 4 + ii;
    if (gr >= nrows) continue;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int d = tx * CPT + jj;
      if (d >= hd) continue;
      float* at = dst + (size_t)gr * hd + d;
      if constexpr (MODE == STORE_ATOMIC)
        atomicAdd(at, acc[ii][jj]);
      else if constexpr (MODE == STORE_ADD)
        *at += acc[ii][jj];
      else
        *at = acc[ii][jj];
    }
  }
}

struct BwdSmem {
  float *Qs, *Gs, *Ks, *Vs, *Ps, *Ds, *Ms, *Ls, *Dr;
};

template <int HD>
__device__ __forceinline__ BwdSmem carve(float* smem) {
  constexpr int T = TILE * BWD_LD<HD>;
  BwdSmem s;
  s.Qs = smem;
  s.Gs = s.Qs + T;
  s.Ks = s.Gs + T;
  s.Vs = s.Ks + T;
  s.Ps = s.Vs + T;
  s.Ds = s.Ps + TILE * PLD;
  s.Ms = s.Ds + TILE * PLD;
  s.Ls = s.Ms + TILE;
  s.Dr = s.Ls + TILE;
  return s;
}

template <int HD, bool WITH_KV, bool CARRY>
__global__ void __launch_bounds__(THREADS)
flash_bwd_rows_kernel(const int* __restrict__ block_cols,
                      const int* __restrict__ nblocks,
                      const int* __restrict__ mask_slot,
                      const int* __restrict__ is_partial,
                      const float* __restrict__ pmask,
                      const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ g,
                      const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ D, float* __restrict__ dq,
                      float* __restrict__ dk, float* __restrict__ dv,
                      int heads, int group, int mb, int max_bpr,
                      int n_partial, int s_q, int s_kv, int hd, float scale) {
  constexpr int CPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  const BwdSmem sm = carve<HD>(smem);
  const int i = blockIdx.x, r = blockIdx.y;
  const int b = r / heads, rk = r / group;
  const size_t qoff = (size_t)r * s_q * hd, koff = (size_t)rk * s_kv * hd;

  stage_rows<HD>(sm.Qs, q + qoff, i * TILE, s_q, hd, scale);
  stage_rows<HD>(sm.Gs, g + qoff, i * TILE, s_q, hd, 1.f);
  stage_stats(sm.Ms, sm.Ls, sm.Dr, m, l, D, r, i, mb, s_q);

  float acc[4][CPT];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[ii][jj] = 0.f;

  const size_t meta0 = ((size_t)b * mb + i) * max_bpr;
  const int nb = nblocks[b * mb + i];
  for (int s = 0; s < nb; ++s) {
    const int c = block_cols[meta0 + s];
    stage_rows<HD>(sm.Ks, k + koff, c * TILE, s_kv, hd, 1.f);
    stage_rows<HD>(sm.Vs, v + koff, c * TILE, s_kv, hd, 1.f);
    __syncthreads();
    const float* pm =
        is_partial[meta0 + s]
            ? pmask + ((size_t)b * n_partial + mask_slot[meta0 + s]) * TILE * TILE
            : nullptr;
    score_tile<HD>(sm.Qs, sm.Gs, sm.Ks, sm.Vs, sm.Ms, sm.Ls, sm.Dr, pm, sm.Ps,
                   sm.Ds);
    __syncthreads();
    acc_rows<HD>(sm.Ds, sm.Ks, acc);
    if constexpr (WITH_KV) {
      float part[4][CPT];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) part[ii][jj] = 0.f;
      acc_keys<HD>(sm.Ds, sm.Qs, part);
      store_tile<HD, STORE_ATOMIC>(dk + koff, c * TILE, s_kv, hd, part);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) part[ii][jj] = 0.f;
      acc_keys<HD>(sm.Ps, sm.Gs, part);
      store_tile<HD, STORE_ATOMIC>(dv + koff, c * TILE, s_kv, hd, part);
    }
    __syncthreads();
  }
  constexpr Store dq_mode = CARRY ? STORE_ADD : STORE_WRITE;
  store_tile<HD, dq_mode>(dq + qoff, i * TILE, s_q, hd, acc);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const int* __restrict__ t_src_i,
                     const int* __restrict__ t_nblocks,
                     const int* __restrict__ t_mask_slot,
                     const int* __restrict__ t_is_partial,
                     const float* __restrict__ pmask,
                     const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ D, float* __restrict__ dk,
                     float* __restrict__ dv, int heads, int group, int mb,
                     int kb, int max_bpc, int n_partial, int s_q, int s_kv,
                     int hd, float scale) {
  constexpr int CPT = HD / 16;
  extern __shared__ __align__(16) float smem[];
  const BwdSmem sm = carve<HD>(smem);
  const int j = blockIdx.x, rk = blockIdx.y;
  const size_t koff = (size_t)rk * s_kv * hd;

  stage_rows<HD>(sm.Ks, k + koff, j * TILE, s_kv, hd, 1.f);
  stage_rows<HD>(sm.Vs, v + koff, j * TILE, s_kv, hd, 1.f);

  float ak[4][CPT], av[4][CPT];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) ak[ii][jj] = av[ii][jj] = 0.f;

  for (int gi = 0; gi < group; ++gi) {
    const int r = rk * group + gi, b = r / heads;
    const size_t qoff = (size_t)r * s_q * hd;
    const size_t meta0 = ((size_t)b * kb + j) * max_bpc;
    const int nb = t_nblocks[b * kb + j];
    for (int u = 0; u < nb; ++u) {
      const int i = t_src_i[meta0 + u];
      __syncthreads();  // the previous tile's readers are done
      stage_rows<HD>(sm.Qs, q + qoff, i * TILE, s_q, hd, scale);
      stage_rows<HD>(sm.Gs, g + qoff, i * TILE, s_q, hd, 1.f);
      stage_stats(sm.Ms, sm.Ls, sm.Dr, m, l, D, r, i, mb, s_q);
      __syncthreads();
      const float* pm =
          t_is_partial[meta0 + u]
              ? pmask + ((size_t)b * n_partial + t_mask_slot[meta0 + u]) *
                            TILE * TILE
              : nullptr;
      score_tile<HD>(sm.Qs, sm.Gs, sm.Ks, sm.Vs, sm.Ms, sm.Ls, sm.Dr, pm,
                     sm.Ps, sm.Ds);
      __syncthreads();
      acc_keys<HD>(sm.Ds, sm.Qs, ak);
      acc_keys<HD>(sm.Ps, sm.Gs, av);
    }
  }
  store_tile<HD, STORE_WRITE>(dk + koff, j * TILE, s_kv, hd, ak);
  store_tile<HD, STORE_WRITE>(dv + koff, j * TILE, s_kv, hd, av);
}

template <int HD, bool WITH_KV, bool CARRY>
int launch_rows(const int* cols, const int* nblk, const int* slot,
                const int* part, const float* pmask, const float* q,
                const float* k, const float* v, const float* g, const float* m,
                const float* l, const float* D, float* dq, float* dk,
                float* dv, int R, int heads, int group, int mb, int max_bpr,
                int n_partial, int s_q, int s_kv, int hd, float scale,
                cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD>();
  const int err = set_smem(flash_bwd_rows_kernel<HD, WITH_KV, CARRY>, smem);
  if (err) return err;
  flash_bwd_rows_kernel<HD, WITH_KV, CARRY>
      <<<dim3(mb, R), THREADS, smem, stream>>>(
      cols, nblk, slot, part, pmask, q, k, v, g, m, l, D, dq, dk, dv, heads,
      group, mb, max_bpr, n_partial, s_q, s_kv, hd, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const int* ti, const int* tn, const int* tslot,
               const int* tpart, const float* pmask, const float* q,
               const float* k, const float* v, const float* g, const float* m,
               const float* l, const float* D, float* dk, float* dv, int R,
               int heads, int group, int mb, int kb, int max_bpc,
               int n_partial, int s_q, int s_kv, int hd, float scale,
               cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<HD>();
  const int err = set_smem(flash_bwd_dkv_kernel<HD>, smem);
  if (err) return err;
  flash_bwd_dkv_kernel<HD><<<dim3(kb, R / group), THREADS, smem, stream>>>(
      ti, tn, tslot, tpart, pmask, q, k, v, g, m, l, D, dk, dv, heads, group,
      mb, kb, max_bpc, n_partial, s_q, s_kv, hd, scale);
  return (int)cudaGetLastError();
}

template <bool WITH_KV, bool CARRY = false>
int rows_by_hd(const void* block_cols, const void* nblocks,
               const void* mask_slot, const void* is_partial,
               const void* pmask, const void* q, const void* k,
               const void* v, const void* g, const void* m, const void* l,
               const void* D, void* dq, void* dk, void* dv, int R, int heads,
               int group, int mb, int max_bpr, int n_partial, int s_q,
               int s_kv, int hd, float scale, void* stream) {
#define STT_ROWS_ARGS                                                        \
  (const int*)block_cols, (const int*)nblocks, (const int*)mask_slot,        \
      (const int*)is_partial, (const float*)pmask, (const float*)q,          \
      (const float*)k, (const float*)v, (const float*)g, (const float*)m,    \
      (const float*)l, (const float*)D, (float*)dq, (float*)dk, (float*)dv,  \
      R, heads, group, mb, max_bpr, n_partial, s_q, s_kv, hd, scale,         \
      (cudaStream_t)stream
  if (hd <= 32) return launch_rows<32, WITH_KV, CARRY>(STT_ROWS_ARGS);
  if (hd <= 64) return launch_rows<64, WITH_KV, CARRY>(STT_ROWS_ARGS);
  if (hd <= 128) return launch_rows<128, WITH_KV, CARRY>(STT_ROWS_ARGS);
#undef STT_ROWS_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace stt

// Row walk, dq and dk / dv (dk / dv zero-initialised, [R / group, s_kv, hd],
// accumulated with atomics).
extern "C" int flash_sparse_bwd_fused_f32(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dq, void* dk, void* dv, int R, int heads, int group, int mb,
    int max_bpr, int n_partial, int s_q, int s_kv, int hd, float scale,
    void* stream) {
  return stt::rows_by_hd<true>(block_cols, nblocks, mask_slot, is_partial,
                               pmask, q, k, v, g, m, l, D, dq, dk, dv, R,
                               heads, group, mb, max_bpr, n_partial, s_q,
                               s_kv, hd, scale, stream);
}

// Row walk, dq only.
extern "C" int flash_sparse_bwd_dq_f32(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dq, int R, int heads, int group, int mb, int max_bpr, int n_partial,
    int s_q, int s_kv, int hd, float scale, void* stream) {
  return stt::rows_by_hd<false>(block_cols, nblocks, mask_slot, is_partial,
                                pmask, q, k, v, g, m, l, D, dq, nullptr,
                                nullptr, R, heads, group, mb, max_bpr,
                                n_partial, s_q, s_kv, hd, scale, stream);
}

// Column walk over the transposed metadata, dk / dv [R / group, s_kv, hd].
extern "C" int flash_sparse_bwd_dkv_f32(
    const void* t_src_i, const void* t_nblocks, const void* t_mask_slot,
    const void* t_is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dk, void* dv, int R, int heads, int group, int mb, int kb,
    int max_bpc, int n_partial, int s_q, int s_kv, int hd, float scale,
    void* stream) {
#define STT_DKV_ARGS                                                         \
  (const int*)t_src_i, (const int*)t_nblocks, (const int*)t_mask_slot,       \
      (const int*)t_is_partial, (const float*)pmask, (const float*)q,        \
      (const float*)k, (const float*)v, (const float*)g, (const float*)m,    \
      (const float*)l, (const float*)D, (float*)dk, (float*)dv, R, heads,    \
      group, mb, kb, max_bpc, n_partial, s_q, s_kv, hd, scale,               \
      (cudaStream_t)stream
  if (hd <= 32) return stt::launch_dkv<32>(STT_DKV_ARGS);
  if (hd <= 64) return stt::launch_dkv<64>(STT_DKV_ARGS);
  if (hd <= 128) return stt::launch_dkv<128>(STT_DKV_ARGS);
#undef STT_DKV_ARGS
  return (int)cudaErrorInvalidValue;
}

// One ring-backward step (B11b): q / g [R, mb * 64, hd] (q pre-scaled),
// k / v [R, s_kv, hd] (the band, group 1), the FINAL m / l [R, mb * 64],
// D [R, mb * 64], the band's metadata (one mask for all replicas), and the
// carries dq [R, mb * 64, hd], dk / dv [R, s_kv, hd], advanced in place.
extern "C" int flash_sparse_ring_bwd_f32(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dq, void* dk, void* dv, int R, int mb, int max_bpr, int n_partial,
    int s_kv, int hd, void* stream) {
  return stt::rows_by_hd<true, true>(
      block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v, g, m, l, D,
      dq, dk, dv, R, R, 1, mb, max_bpr, n_partial, mb * stt::TILE, s_kv, hd,
      1.f, stream);
}
