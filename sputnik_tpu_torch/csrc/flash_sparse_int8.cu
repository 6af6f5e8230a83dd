// Int8 sparse-flash attention forward: softmax(q k^T * scale, masked) @ v
// with both contractions on int8 codes, the online softmax in f32.
//
// Replaces the TPU kernel sputnik_tpu/ops/pallas/flash_sparse_int8.py:
// flash_sparse_attention_fwd_int8 (B18a). It is B9's kernel
// (flash_sparse_fwd.cu) with the TPU kernel's quantisation, whose grid is
// part of the result:
//   * q * scale is quantised once per 64-row block ([64, hd] tile), k and v
//     per 64-key block, each at max(absmax / 127, 1e-30) (quant_i8);
//   * the score tile is the exact int32 q_q . k_q^T times q_s * k_s, masked
//     to -1e30 where a partial tile's element mask is 0;
//   * p = exp(sc - m_new) over the whole 64-key tile (0 where sc <= -5e29),
//     l sums the unquantised p, and the PV product takes
//     p_q = clip(rint(p * 127), 0, 127) against v's codes, rescaled by
//     v_s / 127; out = acc / max(l, 1e-30).
// expf (not __expf) and true divides, so the kernel and its plain PyTorch
// version agree on every integer product; they differ in the f32 sums'
// order and, where two exps differ in the last place, in a rounded p.
// Metadata, tiles (64 x 64), the -1e30 / -5e29 sentinel rules and the
// (out, m, l) outputs are B9's; there is no GQA group (the TPU kernel has
// none).
//
// What bounds it on an H100: 4 * hd int8 operations per kept key-query pair
// (QK^T and PV) at 1979 TOP/s against one read of q, k, v and one write of
// out; at the int8 serving example (R = 8, s = 2048, hd = 128, causal) the
// ~34 MB take ~0.010 ms and the 8.6 G operations ~0.004 ms. The kernel
// re-quantises each K/V tile for every row block that visits it, as the TPU
// kernel does.
//
// The simple design: one block of 256 threads per (query row block,
// replica), B9's thread layout (4 rows x 4 keys of the score tile, 4 rows x
// hd / 16 output columns per thread). q's codes are staged once as words of
// four head dims ([word][row]); per occupied slot the block reduces the K
// and V tiles' absmax, stages K's codes the same way and V's as words of
// four keys ([key word][dim]), forms the scores with __dp4a (tile_dp4a),
// runs the online softmax with warp shuffles over the 16 threads of a row,
// writes p's codes row-major to shared memory and forms PV with __dp4a over
// words of four keys.
#include "common.cuh"

namespace stt {

constexpr float NEG_LARGE_I8 = -1e30f;

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_sparse_fwd_int8_kernel(const int* __restrict__ block_cols,
                             const int* __restrict__ nblocks,
                             const int* __restrict__ mask_slot,
                             const int* __restrict__ is_partial,
                             const float* __restrict__ pmask,
                             const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ out,
                             float* __restrict__ m_out,
                             float* __restrict__ l_out, int heads, int mb,
                             int max_bpr, int n_partial, int s_q, int s_kv,
                             int hd, float scale) {
  constexpr int W = HD / 4;     // words of four head dims
  constexpr int CPT = HD / 16;  // output columns per thread
  constexpr int KW = TILE / 4;  // words of four keys
  __shared__ __align__(16) int Qw[W][TILE_LD];
  __shared__ __align__(16) int Kw[W][TILE_LD];
  __shared__ __align__(16) int Vw[KW][HD + 4];
  __shared__ __align__(16) signed char Pb[TILE][TILE + 16];
  __shared__ float red[THREADS / 32];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i = blockIdx.x, r = blockIdx.y;
  const int b = r / heads;
  const float* Q = q + (size_t)r * s_q * hd;
  const float* Kr = k + (size_t)r * s_kv * hd;
  const float* Vr = v + (size_t)r * s_kv * hd;

  // q * scale, quantised once for the row block
  float mx = 0.f;
  for (int e = tid; e < TILE * HD; e += THREADS) {
    const int row = e / HD, d = e % HD, gr = i * TILE + row;
    if (gr < s_q && d < hd) mx = fmaxf(mx, fabsf(Q[(size_t)gr * hd + d] * scale));
  }
  const float q_s = tile_scale(block_max(mx, red));
  for (int e = tid; e < TILE * W; e += THREADS) {
    const int row = e / W, w = e % W, gr = i * TILE + row;
    unsigned word = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int d = 4 * w + t;
      const float x = (gr < s_q && d < hd) ? Q[(size_t)gr * hd + d] * scale
                                           : 0.f;
      word |= quant_i8(x, q_s) << (8 * t);
    }
    Qw[w][row] = (int)word;
  }

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    m_i[ii] = NEG_LARGE_I8;
    l_i[ii] = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[ii][jj] = 0.f;
  }

  const size_t meta0 = ((size_t)b * mb + i) * max_bpr;
  const int nb = nblocks[b * mb + i];
  for (int s = 0; s < nb; ++s) {
    const int c = block_cols[meta0 + s];
    float mk = 0.f, mv = 0.f;
    for (int e = tid; e < TILE * HD; e += THREADS) {
      const int key = e / HD, d = e % HD, gk = c * TILE + key;
      if (gk < s_kv && d < hd) {
        mk = fmaxf(mk, fabsf(Kr[(size_t)gk * hd + d]));
        mv = fmaxf(mv, fabsf(Vr[(size_t)gk * hd + d]));
      }
    }
    const float k_s = tile_scale(block_max(mk, red));
    const float v_s = tile_scale(block_max(mv, red));
    for (int e = tid; e < TILE * W; e += THREADS) {
      const int key = e / W, w = e % W, gk = c * TILE + key;
      unsigned word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int d = 4 * w + t;
        const float x = (gk < s_kv && d < hd) ? Kr[(size_t)gk * hd + d] : 0.f;
        word |= quant_i8(x, k_s) << (8 * t);
      }
      Kw[w][key] = (int)word;
    }
    for (int e = tid; e < KW * HD; e += THREADS) {
      const int kw = e / HD, d = e % HD;  // coalesced along d
      unsigned word = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int gk = c * TILE + 4 * kw + t;
        const float x = (gk < s_kv && d < hd) ? Vr[(size_t)gk * hd + d] : 0.f;
        word |= quant_i8(x, v_s) << (8 * t);
      }
      Vw[kw][d] = (int)word;
    }
    __syncthreads();

    int si[4][4] = {};
    tile_dp4a<W>(Qw, Kw, ty, tx, si);
    const float qk = q_s * k_s;
    float sc[4][4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sc[ii][jj] = (float)si[ii][jj] * qk;
    if (is_partial[meta0 + s]) {
      const float* pm = pmask + ((size_t)b * n_partial + mask_slot[meta0 + s])
                                    * TILE * TILE;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          if (pm[(ty * 4 + ii) * TILE + tx * 4 + jj] == 0.f)
            sc[ii][jj] = NEG_LARGE_I8;
    }

    float corr[4];
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      float rmx = fmaxf(fmaxf(sc[ii][0], sc[ii][1]),
                        fmaxf(sc[ii][2], sc[ii][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmx = fmaxf(rmx, __shfl_xor_sync(0xffffffffu, rmx, off));
      const float m_new = fmaxf(m_i[ii], rmx);
      float rs = 0.f;
      unsigned pw = 0;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = sc[ii][jj] <= NEG_LARGE_I8 / 2
                            ? 0.f : expf(sc[ii][jj] - m_new);
        rs += p;
        const float pq = fminf(fmaxf(rintf(p * 127.f), 0.f), 127.f);
        pw |= (unsigned)(int)pq << (8 * jj);
      }
      *reinterpret_cast<int*>(&Pb[ty * 4 + ii][tx * 4]) = (int)pw;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      corr[ii] = expf(m_i[ii] - m_new);
      l_i[ii] = l_i[ii] * corr[ii] + rs;
      m_i[ii] = m_new;
    }
    __syncthreads();

    int pv[4][CPT] = {};
#pragma unroll 4
    for (int kw = 0; kw < KW; ++kw) {
      int a[4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        a[ii] = *reinterpret_cast<const int*>(&Pb[ty * 4 + ii][4 * kw]);
      int bw[CPT];
#pragma unroll
      for (int jj = 0; jj < CPT; jj += 2) {
        const int2 t = *reinterpret_cast<const int2*>(&Vw[kw][tx * CPT + jj]);
        bw[jj] = t.x;
        bw[jj + 1] = t.y;
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj)
          pv[ii][jj] = __dp4a(a[ii], bw[jj], pv[ii][jj]);
    }
    const float vs = v_s / 127.f;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii)
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj)
        acc[ii][jj] = acc[ii][jj] * corr[ii] + (float)pv[ii][jj] * vs;
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
int launch_flash_int8(const int* cols, const int* nblk, const int* slot,
                      const int* part, const float* pmask, const float* q,
                      const float* k, const float* v, float* out,
                      float* m_out, float* l_out, int R, int heads, int mb,
                      int max_bpr, int n_partial, int s_q, int s_kv, int hd,
                      float scale, cudaStream_t stream) {
  dim3 grid(mb, R);
  flash_sparse_fwd_int8_kernel<HD><<<grid, THREADS, 0, stream>>>(
      cols, nblk, slot, part, pmask, q, k, v, out, m_out, l_out, heads, mb,
      max_bpr, n_partial, s_q, s_kv, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace stt

// q, k, v [R, s, hd] f32 (q unscaled), out [R, s_q, hd], m_out / l_out
// [R, mb * 64]; hd <= 128.
extern "C" int flash_sparse_fwd_int8(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, void* out, void* m_out, void* l_out, int R, int heads,
    int mb, int max_bpr, int n_partial, int s_q, int s_kv, int hd,
    float scale, void* stream) {
#define STT_FLASH_I8_ARGS                                                    \
  (const int*)block_cols, (const int*)nblocks, (const int*)mask_slot,       \
      (const int*)is_partial, (const float*)pmask, (const float*)q,         \
      (const float*)k, (const float*)v, (float*)out, (float*)m_out,         \
      (float*)l_out, R, heads, mb, max_bpr, n_partial, s_q, s_kv, hd, scale, \
      (cudaStream_t)stream
  if (hd <= 32) return stt::launch_flash_int8<32>(STT_FLASH_I8_ARGS);
  if (hd <= 64) return stt::launch_flash_int8<64>(STT_FLASH_I8_ARGS);
  if (hd <= 128) return stt::launch_flash_int8<128>(STT_FLASH_I8_ARGS);
#undef STT_FLASH_I8_ARGS
  return (int)cudaErrorInvalidValue;
}
