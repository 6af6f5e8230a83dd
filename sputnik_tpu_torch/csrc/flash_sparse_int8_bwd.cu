// Int8 sparse-flash attention backward: dq, dk, dv of
// out = softmax(q k^T * scale, masked) @ v with every contraction on int8
// codes, recomputing each occupied score tile from the int8 forward's row
// statistics (running max m, denominator l).
//
// Replaces two TPU kernels of sputnik_tpu/ops/pallas/flash_sparse_int8.py:
//   flash_sparse_bwd_dq_int8  (B18b) -> flash_bwd_dq_int8_kernel<HD>
//   flash_sparse_bwd_dkv_int8 (B18c) -> flash_bwd_dkv_int8_kernel<HD>
// They are B10b's and B10c's walks (flash_sparse_bwd.cu) with the TPU
// kernels' quantisation, whose grid is part of the result:
//   * q * scale and g per 64-row block ([64, hd] tile), k and v per 64-key
//     block, each at max(absmax / 127, 1e-30) (quant_i8), as B18a;
//   * per occupied tile, sc = int(q_q . k_q^T) * (q_s * k_s), -1e30 where a
//     partial tile's element mask is 0; p = exp(sc - m) / max(l, 1e-30),
//     0 where sc <= -5e29; dp = int(g_q . v_q^T) * (g_s * v_s);
//     ds = p * (dp - D), D = rowsum(g * out), quantised per [64, 64] tile;
//   * B18b: dq += int(ds_q . k_q) * (ds_s * k_s), the gradient with respect
//     to q * scale (the caller multiplies by scale);
//   * B18c: dk += int(ds_q^T . q_q) * (ds_s * q_s) and
//     dv += int(p_q^T . g_q) * (g_s / 127), p_q = clip(rint(p * 127), 0, 127).
// Both kernels form sc, p, dp and ds with the same operations in the same
// order as their plain PyTorch versions: the scale product first, products
// that are then added or subtracted rounded on their own (__fmul_rn, never
// contracted into an FMA), expf, true divides, rintf (round half to even).
// So B18b and B18c quantise the same ds tile to the same codes, and so does
// the plain version. The forced 0 in p is load-bearing: a fully-masked row
// has m = -1e30 and l = 0; with it such a row's dq is exactly 0 and it adds
// nothing to dk / dv. The transposed walk pads with repeats, so B18c walks
// only u < t_nblocks.
//
// What bounds them on an H100: 6 * hd (B18b: QK^T, GV^T, dS K) and 8 * hd
// (B18c: QK^T, GV^T, dS^T Q, P^T G) int8 operations per kept key-query pair
// at 1979 TOP/s, against one read of q, k, v, g (and m, l, D) and one write
// of the gradients; at the int8 example's attention (R = 8, s = 2048,
// hd = 128, causal) ~0.013 ms (B18b, bytes) and ~0.015 ms (B18c, bytes).
// These simple kernels multiply with __dp4a on the CUDA cores and
// re-quantise every visited K / V (B18b) or q / g (B18c) tile, as the TPU
// kernels do: instruction-bound, far from that bound.
//
// The simple design: one block of 256 threads per (row block, replica) for
// B18b and per (key column block, replica) for B18c; no GQA group (the TPU
// kernels have none). Codes are staged in shared memory as 32-bit words of
// four int8 values along each product's contraction: words of four head
// dims ([word][row or key]) for the two score products (tile_dp4a, thread
// (ty, tx) owning rows ty * 4 + i and keys tx * 4 + j), words of four keys
// ([key word][dim]) of k for dS K, words of four rows ([row word][dim]) of
// q and g for dS^T Q and P^T G. ds's codes go to shared memory row-major
// (B18b) or key-major in words of four rows (B18c, as p's). dq, or dk and
// dv, stay in registers, 4 rows (keys) x hd / 16 dims per thread; no
// atomics, and a key column that no query attends writes 0. Shared memory
// at hd = 128: 49 KB (B18b) and 61 KB (B18c), dynamic. 64 x 64 tiles,
// hd <= 128 (templates 32 / 64 / 128, as the forward).
#include "common.cuh"

namespace stt {

constexpr float NEG_LARGE = -1e30f;
constexpr int RWORDS = TILE / 4;  // words of four rows (or keys) of a tile

template <int HD>
struct __align__(16) DqInt8Smem {
  int Qw[HD / 4][TILE_LD];     // q * scale codes, [head-dim word][row]
  int Gw[HD / 4][TILE_LD];     // g codes
  int Kw[HD / 4][TILE_LD];     // k codes, [head-dim word][key]
  int Vw[HD / 4][TILE_LD];     // v codes
  int Kt[RWORDS][HD + 4];      // k codes, [key word][dim]
  signed char Db[TILE][TILE + 16];  // ds codes, [row][key]
  float Ms[TILE], Ls[TILE], Dr[TILE];
  float red[THREADS / 32];
};

template <int HD>
struct __align__(16) DkvInt8Smem {
  int Kw[HD / 4][TILE_LD];     // k codes, [head-dim word][key]
  int Vw[HD / 4][TILE_LD];     // v codes
  int Qw[HD / 4][TILE_LD];     // q * scale codes, [head-dim word][row]
  int Gw[HD / 4][TILE_LD];     // g codes
  int Qt[RWORDS][HD + 4];      // q * scale codes, [row word][dim]
  int Gt[RWORDS][HD + 4];      // g codes, [row word][dim]
  int DsT[TILE][RWORDS + 1];   // ds codes, [key][row word]
  int PT[TILE][RWORDS + 1];    // p codes, [key][row word]
  float Ms[TILE], Ls[TILE], Dr[TILE];
  float red[THREADS / 32];
};

// Quantise the 64-row tile x[row0 + row][d] * mul (0 for rows >= nrows or
// d >= hd) at its absmax scale, which it returns; stage its codes as words
// of four head dims in hw ([word][row]) and, if rw is not null, as words of
// four rows in rw ([row word][dim]).
template <int HD>
__device__ float stage_codes(const float* __restrict__ x, int row0, int nrows,
                             int hd, float mul, int (*hw)[TILE_LD],
                             int (*rw)[HD + 4], float* red) {
  constexpr int W = HD / 4;
  float mx = 0.f;
  for (int e = threadIdx.x; e < TILE * HD; e += THREADS) {
    const int row = e / HD, d = e % HD, gr = row0 + row;
    if (gr < nrows && d < hd) mx = fmaxf(mx, fabsf(x[(size_t)gr * hd + d] * mul));
  }
  const float sc = tile_scale(block_max(mx, red));
  for (int e = threadIdx.x; e < TILE * W; e += THREADS) {
    const int row = e / W, w = e % W, gr = row0 + row;
    unsigned word = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 4 * w + t;
      const float v = (gr < nrows && d < hd) ? x[(size_t)gr * hd + d] * mul : 0.f;
      word |= quant_i8(v, sc) << (8 * t);
    }
    hw[w][row] = (int)word;
  }
  if (rw != nullptr) {
    for (int e = threadIdx.x; e < RWORDS * HD; e += THREADS) {
      const int rw4 = e / HD, d = e % HD;  // coalesced along d
      unsigned word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int gr = row0 + 4 * rw4 + t;
        const float v = (gr < nrows && d < hd) ? x[(size_t)gr * hd + d] * mul : 0.f;
        word |= quant_i8(v, sc) << (8 * t);
      }
      rw[rw4][d] = (int)word;
    }
  }
  return sc;
}

// p and ds of the thread's 4 x 4 elements (rows ty * 4 + i, keys tx * 4 + j)
// of one tile from the integer score products si = q_q . k_q^T and
// di = g_q . v_q^T; pm is the tile's element mask or null. Returns the
// largest |ds| among them.
__device__ __forceinline__ float tile_p_ds(const int si[4][4],
                                           const int di[4][4], float qk,
                                           float gv, const float* pm,
                                           const float* Ms, const float* Ls,
                                           const float* Dr, int ty, int tx,
                                           float p[4][4], float ds[4][4]) {
  float mx = 0.f;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = ty * 4 + ii;
    const float mr = Ms[row], lr = Ls[row], dr = Dr[row];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float sc = __fmul_rn((float)si[ii][jj], qk);
      if (pm != nullptr && pm[row * TILE + tx * 4 + jj] == 0.f)
        sc = NEG_LARGE;
      const float pr = sc <= NEG_LARGE / 2 ? 0.f : expf(sc - mr) / lr;
      const float dp = __fmul_rn((float)di[ii][jj], gv);
      p[ii][jj] = pr;
      ds[ii][jj] = pr * (dp - dr);
      mx = fmaxf(mx, fabsf(ds[ii][jj]));
    }
  }
  return mx;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_int8_kernel(const int* __restrict__ block_cols,
                         const int* __restrict__ nblocks,
                         const int* __restrict__ mask_slot,
                         const int* __restrict__ is_partial,
                         const float* __restrict__ pmask,
                         const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ g,
                         const float* __restrict__ m,
                         const float* __restrict__ l,
                         const float* __restrict__ D, float* __restrict__ dq,
                         int heads, int mb, int max_bpr, int n_partial,
                         int s_q, int s_kv, int hd, float scale) {
  constexpr int W = HD / 4, CPT = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqInt8Smem<HD>& sm = *reinterpret_cast<DqInt8Smem<HD>*>(smem_raw);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i = blockIdx.x, r = blockIdx.y, b = r / heads;
  const size_t qoff = (size_t)r * s_q * hd, koff = (size_t)r * s_kv * hd;

  const float q_s = stage_codes<HD>(q + qoff, i * TILE, s_q, hd, scale, sm.Qw,
                                    nullptr, sm.red);
  const float g_s = stage_codes<HD>(g + qoff, i * TILE, s_q, hd, 1.f, sm.Gw,
                                    nullptr, sm.red);
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
    __syncthreads();  // the previous slot's readers are done
    const float k_s = stage_codes<HD>(k + koff, c * TILE, s_kv, hd, 1.f,
                                      sm.Kw, sm.Kt, sm.red);
    const float v_s = stage_codes<HD>(v + koff, c * TILE, s_kv, hd, 1.f,
                                      sm.Vw, nullptr, sm.red);
    __syncthreads();

    int si[4][4] = {}, di[4][4] = {};
    tile_dp4a<W>(sm.Qw, sm.Kw, ty, tx, si);
    tile_dp4a<W>(sm.Gw, sm.Vw, ty, tx, di);
    const float* pm =
        is_partial[meta0 + s]
            ? pmask + ((size_t)b * n_partial + mask_slot[meta0 + s]) * TILE * TILE
            : nullptr;
    float p[4][4], ds[4][4];
    const float mx = tile_p_ds(si, di, q_s * k_s, g_s * v_s, pm, sm.Ms, sm.Ls,
                               sm.Dr, ty, tx, p, ds);
    const float ds_s = tile_scale(block_max(mx, sm.red));
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      unsigned w = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) w |= quant_i8(ds[ii][jj], ds_s) << (8 * jj);
      *reinterpret_cast<int*>(&sm.Db[ty * 4 + ii][tx * 4]) = (int)w;
    }
    __syncthreads();

    // dq[row][d] += sum_key ds_q[row][key] k_q[key][d], in words of 4 keys
    int dqi[4][CPT] = {};
#pragma unroll 4
    for (int kw = 0; kw < RWORDS; ++kw) {
      int a[4], bw[CPT];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        a[ii] = *reinterpret_cast<const int*>(&sm.Db[ty * 4 + ii][4 * kw]);
#pragma unroll
      for (int jj = 0; jj < CPT; jj += 2) {
        const int2 t = *reinterpret_cast<const int2*>(&sm.Kt[kw][tx * CPT + jj]);
        bw[jj] = t.x;
        bw[jj + 1] = t.y;
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) dqi[ii][jj] = __dp4a(a[ii], bw[jj], dqi[ii][jj]);
    }
    const float dk_s = ds_s * k_s;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) acc[ii][jj] += (float)dqi[ii][jj] * dk_s;
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int gr = i * TILE + ty * 4 + ii;
    if (gr >= s_q) continue;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int d = tx * CPT + jj;
      if (d < hd) dq[qoff + (size_t)gr * hd + d] = acc[ii][jj];
    }
  }
}

// acc[i][j] += sum_w dp4a(A[ty*4 + i][w], B[w][tx*CPT + j]) over the 16 row
// words: the [key][dim] products ds_q^T q_q and p_q^T g_q.
template <int HD>
__device__ __forceinline__ void keys_dp4a(const int (*A)[RWORDS + 1],
                                          const int (*B)[HD + 4], int ty,
                                          int tx, int acc[4][HD / 16]) {
  constexpr int CPT = HD / 16;
#pragma unroll 4
  for (int w = 0; w < RWORDS; ++w) {
    int a[4], bw[CPT];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) a[ii] = A[ty * 4 + ii][w];
#pragma unroll
    for (int jj = 0; jj < CPT; jj += 2) {
      const int2 t = *reinterpret_cast<const int2*>(&B[w][tx * CPT + jj]);
      bw[jj] = t.x;
      bw[jj + 1] = t.y;
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) acc[ii][jj] = __dp4a(a[ii], bw[jj], acc[ii][jj]);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_int8_kernel(const int* __restrict__ t_src_i,
                          const int* __restrict__ t_nblocks,
                          const int* __restrict__ t_mask_slot,
                          const int* __restrict__ t_is_partial,
                          const float* __restrict__ pmask,
                          const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ g,
                          const float* __restrict__ m,
                          const float* __restrict__ l,
                          const float* __restrict__ D, float* __restrict__ dk,
                          float* __restrict__ dv, int heads, int mb, int kb,
                          int max_bpc, int n_partial, int s_q, int s_kv,
                          int hd, float scale) {
  constexpr int W = HD / 4, CPT = HD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvInt8Smem<HD>& sm = *reinterpret_cast<DkvInt8Smem<HD>*>(smem_raw);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int j = blockIdx.x, r = blockIdx.y, b = r / heads;
  const size_t qoff = (size_t)r * s_q * hd, koff = (size_t)r * s_kv * hd;

  const float k_s = stage_codes<HD>(k + koff, j * TILE, s_kv, hd, 1.f, sm.Kw,
                                    nullptr, sm.red);
  const float v_s = stage_codes<HD>(v + koff, j * TILE, s_kv, hd, 1.f, sm.Vw,
                                    nullptr, sm.red);

  float ak[4][CPT], av[4][CPT];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) ak[ii][jj] = av[ii][jj] = 0.f;

  const size_t meta0 = ((size_t)b * kb + j) * max_bpc;
  const int nb = t_nblocks[b * kb + j];
  for (int u = 0; u < nb; ++u) {
    const int i = t_src_i[meta0 + u];
    __syncthreads();  // the previous slot's readers are done
    const float q_s = stage_codes<HD>(q + qoff, i * TILE, s_q, hd, scale,
                                      sm.Qw, sm.Qt, sm.red);
    const float g_s = stage_codes<HD>(g + qoff, i * TILE, s_q, hd, 1.f, sm.Gw,
                                      sm.Gt, sm.red);
    stage_stats(sm.Ms, sm.Ls, sm.Dr, m, l, D, r, i, mb, s_q);
    __syncthreads();

    int si[4][4] = {}, di[4][4] = {};
    tile_dp4a<W>(sm.Qw, sm.Kw, ty, tx, si);
    tile_dp4a<W>(sm.Gw, sm.Vw, ty, tx, di);
    const float* pm =
        t_is_partial[meta0 + u]
            ? pmask + ((size_t)b * n_partial + t_mask_slot[meta0 + u]) *
                          TILE * TILE
            : nullptr;
    float p[4][4], ds[4][4];
    const float mx = tile_p_ds(si, di, q_s * k_s, g_s * v_s, pm, sm.Ms, sm.Ls,
                               sm.Dr, ty, tx, p, ds);
    const float ds_s = tile_scale(block_max(mx, sm.red));
    // the thread's four rows ty * 4 + i are one row word of each key
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      unsigned dw = 0, pw = 0;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        dw |= quant_i8(ds[ii][jj], ds_s) << (8 * ii);
        const float pq = fminf(fmaxf(rintf(p[ii][jj] * 127.f), 0.f), 127.f);
        pw |= (unsigned)(int)pq << (8 * ii);
      }
      sm.DsT[tx * 4 + jj][ty] = (int)dw;
      sm.PT[tx * 4 + jj][ty] = (int)pw;
    }
    __syncthreads();

    // keys ty * 4 + i, dims tx * CPT + j
    int acc[4][CPT] = {};
    keys_dp4a<HD>(sm.DsT, sm.Qt, ty, tx, acc);
    const float dq_s = ds_s * q_s;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        ak[ii][jj] += (float)acc[ii][jj] * dq_s;
        acc[ii][jj] = 0;
      }
    keys_dp4a<HD>(sm.PT, sm.Gt, ty, tx, acc);
    const float pg_s = g_s / 127.f;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) av[ii][jj] += (float)acc[ii][jj] * pg_s;
  }

#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int gk = j * TILE + ty * 4 + ii;
    if (gk >= s_kv) continue;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int d = tx * CPT + jj;
      if (d >= hd) continue;
      dk[koff + (size_t)gk * hd + d] = ak[ii][jj];
      dv[koff + (size_t)gk * hd + d] = av[ii][jj];
    }
  }
}

template <int HD>
int launch_dq_int8(const int* cols, const int* nblk, const int* slot,
                   const int* part, const float* pmask, const float* q,
                   const float* k, const float* v, const float* g,
                   const float* m, const float* l, const float* D, float* dq,
                   int R, int heads, int mb, int max_bpr, int n_partial,
                   int s_q, int s_kv, int hd, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = sizeof(DqInt8Smem<HD>);
  const int err = set_smem(flash_bwd_dq_int8_kernel<HD>, smem);
  if (err) return err;
  flash_bwd_dq_int8_kernel<HD><<<dim3(mb, R), THREADS, smem, stream>>>(
      cols, nblk, slot, part, pmask, q, k, v, g, m, l, D, dq, heads, mb,
      max_bpr, n_partial, s_q, s_kv, hd, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv_int8(const int* ti, const int* tn, const int* tslot,
                    const int* tpart, const float* pmask, const float* q,
                    const float* k, const float* v, const float* g,
                    const float* m, const float* l, const float* D, float* dk,
                    float* dv, int R, int heads, int mb, int kb, int max_bpc,
                    int n_partial, int s_q, int s_kv, int hd, float scale,
                    cudaStream_t stream) {
  constexpr size_t smem = sizeof(DkvInt8Smem<HD>);
  const int err = set_smem(flash_bwd_dkv_int8_kernel<HD>, smem);
  if (err) return err;
  flash_bwd_dkv_int8_kernel<HD><<<dim3(kb, R), THREADS, smem, stream>>>(
      ti, tn, tslot, tpart, pmask, q, k, v, g, m, l, D, dk, dv, heads, mb, kb,
      max_bpc, n_partial, s_q, s_kv, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace stt

// Row walk, dq [R, s_q, hd] with respect to q * scale. q (unscaled), g
// [R, s_q, hd]; k, v [R, s_kv, hd]; m, l [R, mb * 64]; D [R, s_q]; hd <= 128.
extern "C" int flash_sparse_bwd_dq_int8(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dq, int R, int heads, int mb, int max_bpr, int n_partial, int s_q,
    int s_kv, int hd, float scale, void* stream) {
#define STT_DQ_I8_ARGS                                                       \
  (const int*)block_cols, (const int*)nblocks, (const int*)mask_slot,        \
      (const int*)is_partial, (const float*)pmask, (const float*)q,          \
      (const float*)k, (const float*)v, (const float*)g, (const float*)m,    \
      (const float*)l, (const float*)D, (float*)dq, R, heads, mb, max_bpr,   \
      n_partial, s_q, s_kv, hd, scale, (cudaStream_t)stream
  if (hd <= 32) return stt::launch_dq_int8<32>(STT_DQ_I8_ARGS);
  if (hd <= 64) return stt::launch_dq_int8<64>(STT_DQ_I8_ARGS);
  if (hd <= 128) return stt::launch_dq_int8<128>(STT_DQ_I8_ARGS);
#undef STT_DQ_I8_ARGS
  return (int)cudaErrorInvalidValue;
}

// Column walk over the transposed metadata, dk / dv [R, s_kv, hd].
extern "C" int flash_sparse_bwd_dkv_int8(
    const void* t_src_i, const void* t_nblocks, const void* t_mask_slot,
    const void* t_is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dk, void* dv, int R, int heads, int mb, int kb, int max_bpc,
    int n_partial, int s_q, int s_kv, int hd, float scale, void* stream) {
#define STT_DKV_I8_ARGS                                                      \
  (const int*)t_src_i, (const int*)t_nblocks, (const int*)t_mask_slot,       \
      (const int*)t_is_partial, (const float*)pmask, (const float*)q,        \
      (const float*)k, (const float*)v, (const float*)g, (const float*)m,    \
      (const float*)l, (const float*)D, (float*)dk, (float*)dv, R, heads,    \
      mb, kb, max_bpc, n_partial, s_q, s_kv, hd, scale, (cudaStream_t)stream
  if (hd <= 32) return stt::launch_dkv_int8<32>(STT_DKV_I8_ARGS);
  if (hd <= 64) return stt::launch_dkv_int8<64>(STT_DKV_I8_ARGS);
  if (hd <= 128) return stt::launch_dkv_int8<128>(STT_DKV_I8_ARGS);
#undef STT_DKV_I8_ARGS
  return (int)cudaErrorInvalidValue;
}
