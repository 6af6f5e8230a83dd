// Sparse-flash attention forward: softmax(q k^T * scale, masked) @ v over
// the occupied key blocks of each replica's mask, scores never written out.
//
// Replaces the TPU kernel
// sputnik_tpu/ops/pallas/flash_sparse.py:flash_sparse_attention_fwd.
// q is [R, s_q, hd], k and v are [R / group, s_kv, hd] (GQA: query replica r
// reads KV replica r / group), the block metadata is per batch element
// b = r / heads: block_cols / mask_slot / is_partial [B, mb * max_bpr],
// nblocks [B, mb], and pmask [B, n_partial, 64, 64] holds the deduplicated
// element masks of partial tiles. Tiles are 64 x 64 (bm = bk = 64).
//
// What bounds it on an H100: per occupied tile, 4 x 64^2 x hd FLOPs (QK^T
// and PV) against one 64 x hd K and V tile read from L2/HBM and 64^2 exp()
// calls; at the reference transformer's shapes (R = 32, s = 512, hd = 64)
// the whole call is ~0.3 GFLOP over 256 blocks, so it is latency- and
// occupancy-bound, not bandwidth-bound.
//
// The simple design: one block of 256 threads per (query row block i,
// replica r). It stages q * scale once, then for each occupied slot
// s < nblocks[b, i] stages the K and V tile, computes the 64 x 64 score
// tile (4 x 4 per thread, common.cuh), applies the partial-tile mask, and
// runs the online softmax: running max m and denominator l per row,
// reduced across the 16 threads sharing a row with warp shuffles; p goes
// through shared memory into acc += p @ V held in registers. The -1e30
// sentinel stays finite and p is forced to 0 where the score is <= -5e29,
// so a fully-masked row yields m = -1e30, l = 0 and an output of exactly 0
// (a -inf sentinel would give exp(-inf - -inf) = NaN). The output is
// acc / max(l, 1e-30); m and l are written per row as [R, mb * 64].
#include "common.cuh"

namespace stt {

constexpr float NEG_LARGE = -1e30f;

template <int HD>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) *
         (2 * HD * TILE_LD + TILE * TILE_LD + TILE * (HD + 4));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_sparse_fwd_kernel(const int* __restrict__ block_cols,
                        const int* __restrict__ nblocks,
                        const int* __restrict__ mask_slot,
                        const int* __restrict__ is_partial,
                        const float* __restrict__ pmask,
                        const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        int heads, int group, int mb, int max_bpr,
                        int n_partial, int s_q, int s_kv, int hd,
                        float scale) {
  constexpr int CPT = HD / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  auto QsT = reinterpret_cast<float (*)[TILE_LD]>(smem);  // [HD][TILE_LD]
  auto KsT = reinterpret_cast<float (*)[TILE_LD]>(smem + HD * TILE_LD);
  auto PsT = reinterpret_cast<float (*)[TILE_LD]>(smem + 2 * HD * TILE_LD);
  auto Vs = reinterpret_cast<float (*)[HD + 4]>(
      smem + 2 * HD * TILE_LD + TILE * TILE_LD);  // [TILE][HD + 4]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i = blockIdx.x, r = blockIdx.y;
  const int b = r / heads, rk = r / group;
  const float* Q = q + (size_t)r * s_q * hd;
  const float* Kr = k + (size_t)rk * s_kv * hd;
  const float* Vr = v + (size_t)rk * s_kv * hd;

  for (int e = tid; e < TILE * HD; e += THREADS) {
    const int row = e / HD, d = e % HD, gr = i * TILE + row;
    QsT[d][row] = (gr < s_q && d < hd) ? Q[(size_t)gr * hd + d] * scale : 0.f;
  }

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m_i[ii] = NEG_LARGE;
    l_i[ii] = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[ii][jj] = 0.f;
  }

  const size_t meta0 = ((size_t)b * mb + i) * max_bpr;
  const int nb = nblocks[b * mb + i];
  for (int s = 0; s < nb; ++s) {
    const int c = block_cols[meta0 + s];
    for (int e = tid; e < TILE * HD; e += THREADS) {
      const int key = e / HD, d = e % HD, gk = c * TILE + key;
      const bool ok = gk < s_kv && d < hd;
      KsT[d][key] = ok ? Kr[(size_t)gk * hd + d] : 0.f;
      Vs[key][d] = ok ? Vr[(size_t)gk * hd + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4] = {};
    tile_fma<HD>(QsT, KsT, ty, tx, sc);
    if (is_partial[meta0 + s]) {
      const float* pm = pmask + ((size_t)b * n_partial + mask_slot[meta0 + s])
                                    * TILE * TILE;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (pm[(ty * 4 + ii) * TILE + tx * 4 + jj] == 0.f)
            sc[ii][jj] = NEG_LARGE;
    }

#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float mx = fmaxf(fmaxf(sc[ii][0], sc[ii][1]), fmaxf(sc[ii][2], sc[ii][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[ii], mx);
      float rs = 0.f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = sc[ii][jj] <= NEG_LARGE / 2 ? 0.f
                                                    : expf(sc[ii][jj] - m_new);
        sc[ii][jj] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m_i[ii] - m_new);
      l_i[ii] = l_i[ii] * corr + rs;
      m_i[ii] = m_new;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) acc[ii][jj] *= corr;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) PsT[tx * 4 + jj][ty * 4 + ii] = sc[ii][jj];
    }
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < TILE; ++key) {
      const float4 p4 = *reinterpret_cast<const float4*>(&PsT[key][ty * 4]);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
      float vv[CPT];
#pragma unroll
      for (int jj = 0; jj < CPT; jj += 2) {
        const float2 t = *reinterpret_cast<const float2*>(&Vs[key][tx * CPT + jj]);
        vv[jj] = t.x;
        vv[jj + 1] = t.y;
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj)
          acc[ii][jj] = fmaf(pv[ii], vv[jj], acc[ii][jj]);
    }
    __syncthreads();
  }

  const size_t m_pad = (size_t)mb * TILE;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int gr = i * TILE + ty * 4 + ii;
    if (tx == 0) {
      m_out[(size_t)r * m_pad + gr] = m_i[ii];
      l_out[(size_t)r * m_pad + gr] = l_i[ii];
    }
    if (gr >= s_q) continue;
    const float den = fmaxf(l_i[ii], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int d = tx * CPT + jj;
      if (d < hd) out[((size_t)r * s_q + gr) * hd + d] = acc[ii][jj] / den;
    }
  }
}

template <int HD>
int launch_flash(const int* cols, const int* nblk, const int* slot,
                 const int* part, const float* pmask, const float* q,
                 const float* k, const float* v, float* out, float* m_out,
                 float* l_out, int R, int heads, int group, int mb,
                 int max_bpr, int n_partial, int s_q, int s_kv, int hd,
                 float scale, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_sparse_fwd_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(mb, R);
  flash_sparse_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      cols, nblk, slot, part, pmask, q, k, v, out, m_out, l_out, heads,
      group, mb, max_bpr, n_partial, s_q, s_kv, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace stt

// q [R, s_q, hd], k/v [R / group, s_kv, hd], out [R, s_q, hd],
// m_out/l_out [R, mb * 64]; hd <= 128.
extern "C" int flash_sparse_fwd_f32(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, void* out, void* m_out, void* l_out, int R, int heads,
    int group, int mb, int max_bpr, int n_partial, int s_q, int s_kv, int hd,
    float scale, void* stream) {
#define STT_FLASH_ARGS                                                      \
  (const int*)block_cols, (const int*)nblocks, (const int*)mask_slot,       \
      (const int*)is_partial, (const float*)pmask, (const float*)q,         \
      (const float*)k, (const float*)v, (float*)out, (float*)m_out,         \
      (float*)l_out, R, heads, group, mb, max_bpr, n_partial, s_q, s_kv, hd, \
      scale, (cudaStream_t)stream
  if (hd <= 32) return stt::launch_flash<32>(STT_FLASH_ARGS);
  if (hd <= 64) return stt::launch_flash<64>(STT_FLASH_ARGS);
  if (hd <= 128) return stt::launch_flash<128>(STT_FLASH_ARGS);
#undef STT_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}
