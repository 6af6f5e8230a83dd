// Int8 sparse-flash attention forward: softmax(q k^T * scale, masked) @ v
// with both contractions on int8 codes, the online softmax in f32.
//
// Replaces the TPU kernel sputnik_tpu/ops/pallas/flash_sparse_int8.py:
// flash_sparse_attention_fwd_int8 (B18a). The quantisation grid is part of
// the result, so it is the TPU kernel's:
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
// The walk stays serial: p's codes are rint(exp(sc - m) * 127) with m the
// running max over the tiles walked so far, so a walk cut into chunks and
// merged would form other codes, a different function from the TPU
// kernel's. Parallelism comes from the walks, the tensor cores and the
// streamed tiles.
//
// What bounds it on an H100: 4 * hd int8 operations per kept key-query pair
// (QK^T and PV) at 1979 TOP/s against one read of q, k, v and one write of
// out; at the int8 serving example (R = 8, s = 2048, hd = 128, causal) the
// ~34 MB take ~0.010 ms and the 8.6 G operations ~0.004 ms.
//
// The design, two launches:
//   * quant_kv_kernel, once a call: a block a (64-key block, replica, K or
//     V) reads its tile once (registers), reduces its absmax and writes its
//     scale and codes in wgmma's core-matrix order (no swizzle): K as
//     [key][d] (K-major along the head dim, QK^T's B), V transposed as
//     [d][key] (K-major along the keys: int8 wgmma reads B K-major only, and
//     PV contracts over keys), through shared memory. The grid of the scales
//     does not depend on the visitor, so the TPU kernel's per-visit
//     quantisation of each tile (a TPU grid step has no earlier pass) is
//     the same function done once.
//   * flash_int8_wgmma_kernel: one block of two warpgroups walks the slots
//     of one (row block, replica) in slot order, the longest causal walks
//     first in the grid. q * scale is quantised in the prologue into
//     shared memory (A of QK^T). Each slot's K and V^T code tiles stream
//     into a two-stage shared-memory ring by cp.async one slot ahead, its
//     metadata and scales read a slot ahead too. Each warpgroup scores
//     half the tile's keys, wgmma m64n32k32 s8 into exact int32 sums, and
//     computes the scores, the partial-tile mask, the online softmax, l and
//     p's codes on its accumulator fragments (the row max and sum reduced
//     over each quad's 4 lanes, then across the two halves through shared
//     memory; splitting the tile's keys, not the walk, keeps every running
//     max the serial walk's). The codes go through shared memory in
//     core-matrix order to be PV's A (the accumulator's layout is not an
//     8-bit A fragment's), and each warpgroup forms its half of the output
//     columns by wgmma m64n{hd / 2}k32 s8 against V^T, then acc = acc * corr
//     + pv * (v_s / 127), once per slot. hd <= 64 runs at 64, hd <= 128 at
//     128, the head dims past hd zero codes.
#include "common.cuh"

namespace stt {

constexpr float NEG_LARGE_I8 = -1e30f;
constexpr int IT = 256;  // threads of a walk block: two warpgroups

// The pre-pass: key block c of replica r of k (blockIdx.z = 0) or v (1)
// -> its scale, scales[(r * kb + c) * 2 + blockIdx.z], and its codes in
// codes[(r * kb + c) * 2 * 64 * HD]: K's (rows key, kp HD), then V's
// transposed (rows d, kp 64 keys), core-matrix order.
template <int HD>
__global__ void __launch_bounds__(THREADS)
quant_kv_kernel(const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ scales, signed char* __restrict__ codes,
                int s_kv, int hd, int kb) {
  __shared__ __align__(16) unsigned char S[TILE][HD + 16];
  __shared__ float red[THREADS / 32];
  const int c = blockIdx.x, r = blockIdx.y, half = blockIdx.z;
  signed char* const out = codes + ((size_t)r * kb + c) * 2 * TILE * HD;
  const float sc = quant_codes_tile<HD>(
      (half ? v : k) + (size_t)r * s_kv * hd, c * TILE, s_kv, hd, 1.f,
      half ? nullptr : out, half ? out + TILE * HD : nullptr, S, red);
  if (threadIdx.x == 0) scales[((size_t)r * kb + c) * 2 + half] = sc;
}

// One walk: row block i = mb - 1 - blockIdx.y of replica blockIdx.x, by
// two warpgroups: warpgroup wg scores keys 32 wg .. 32 wg + 31 of each
// tile and owns output columns wg * HD / 2 .. of the row block; the row
// maxima and sums of the two halves meet in shared memory. Thread (warp w
// of its warpgroup, lane 4g + t) holds rows 16w + g (h = 0) and 16w + g + 8
// (h = 1); score element 4j + e is row h = e >> 1, key 32 wg + 8j + 2t + (e
// & 1), output element 4j + e head dim wg * HD / 2 + 8j + 2t + (e & 1).
template <int HD>
__global__ void __launch_bounds__(IT)
flash_int8_wgmma_kernel(const int* __restrict__ block_cols,
                        const int* __restrict__ nblocks,
                        const int* __restrict__ mask_slot,
                        const int* __restrict__ is_partial,
                        const float* __restrict__ pmask,
                        const float* __restrict__ q,
                        const signed char* __restrict__ codes,
                        const float* __restrict__ scales,
                        float* __restrict__ out, float* __restrict__ m_out,
                        float* __restrict__ l_out, int heads, int mb,
                        int max_bpr, int n_partial, int s_q, int kb, int hd,
                        float scale) {
  constexpr int NV = HD / 2;                // output columns a warpgroup
  constexpr int NO = NV / 2;                // output sums a thread
  constexpr int STAGE = 2 * TILE * HD;      // K's codes, then V^T's
  constexpr unsigned QSBO = HD / 16 * CORE;  // Q / K: an 8-row group
  constexpr unsigned PSBO = TILE / 16 * CORE;  // P / V^T: an 8-row group
  __shared__ __align__(128) signed char Qc[TILE * HD];
  __shared__ __align__(128) signed char KV[2][STAGE];
  __shared__ __align__(128) signed char Pc[TILE * TILE];
  __shared__ float xch[2][2][TILE];  // [max, sum][warpgroup][row]
  __shared__ float red[IT / 32];

  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int r = blockIdx.x, i = mb - 1 - (int)blockIdx.y;
  const int b = r / heads;
  const size_t meta0 = ((size_t)b * mb + i) * max_bpr;
  const int nb = nblocks[b * mb + i];
  const signed char* const cr = codes + (size_t)r * kb * STAGE;
  // a slot's block column, scales and partial-tile mask, read a slot ahead
  // of use
  struct Slot {
    int c, part, mslot;
    float k_s, v_s;
  };
  auto slot_of = [&](int s) {
    const int c = block_cols[meta0 + s];
    return Slot{c, is_partial[meta0 + s], mask_slot[meta0 + s],
                scales[((size_t)r * kb + c) * 2],
                scales[((size_t)r * kb + c) * 2 + 1]};
  };
  auto load = [&](int s, int c) {
    const signed char* src = cr + (size_t)c * STAGE;
    signed char* dst = KV[s & 1];
#pragma unroll
    for (int e = tid; e < STAGE / 16; e += IT)
      cp_async16(dst + 16 * e, src + 16 * e, 16);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  Slot cur{0, 0, 0, 0.f, 0.f}, nxt{0, 0, 0, 0.f, 0.f};
  if (nb > 0) {
    cur = slot_of(0);
    load(0, cur.c);
    if (nb > 1) nxt = slot_of(1);
  }

  // q * scale, quantised once for the row block into Qc (rows 64, kp HD);
  // every load of a thread in flight together
  float q_s;
  {
    constexpr int PER = TILE * HD / IT;
    const float* Q = q + (size_t)r * s_q * hd;
    float f[PER];
    float mx = 0.f;
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int e = tid + n * IT, row = e / HD, d = e % HD;
      const int gr = i * TILE + row;
      f[n] = gr < s_q && d < hd ? Q[(size_t)gr * hd + d] * scale : 0.f;
      mx = fmaxf(mx, fabsf(f[n]));
    }
    q_s = tile_scale(block_max(mx, red));
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int e = tid + n * IT, row = e / HD, d = e % HD;
      Qc[core_off(row, d >> 4, HD) + (d & 15)] =
          (signed char)quant_i8(f[n], q_s);
    }
  }

  float m_i[2], l_i[2], acc[NO];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_i[h] = NEG_LARGE_I8;
    l_i[h] = 0.f;
  }
#pragma unroll
  for (int x = 0; x < NO; ++x) acc[x] = 0.f;

  for (int s = 0; s < nb; ++s) {
    // slot s has landed; every warp is done with slot s - 1 (its stage,
    // Pc and xch are free), and the codes of q are visible
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (s + 1 < nb) load(s + 1, nxt.c);
    const signed char* Ks = KV[s & 1];
    const signed char* Vt = Ks + TILE * HD;

    int si[16];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < HD / 32; ++ks)
      wgmma_s8_n32(si, core_desc(Qc + ks * 2 * CORE, CORE, QSBO),
                   core_desc(Ks + core_off(32 * wg, 0, HD) + ks * 2 * CORE,
                             CORE, QSBO), ks > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < 16; ++x) asm volatile("" : "+r"(si[x])::"memory");

    const float qk = q_s * cur.k_s;
    float sc[16];
#pragma unroll
    for (int x = 0; x < 16; ++x) sc[x] = (float)si[x] * qk;
    if (cur.part) {
      const float* pm =
          pmask + ((size_t)b * n_partial + cur.mslot) * TILE * TILE;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * w + g + 8 * (e >> 1);
          if (pm[row * TILE + 32 * wg + 8 * j + 2 * t + (e & 1)] == 0.f)
            sc[4 * j + e] = NEG_LARGE_I8;
        }
    }
    // the row maxima of both halves
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float rmx = NEG_LARGE_I8;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        rmx = fmaxf(rmx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      rmx = fmaxf(rmx, __shfl_xor_sync(0xffffffffu, rmx, 1));
      rmx = fmaxf(rmx, __shfl_xor_sync(0xffffffffu, rmx, 2));
      if (t == 0) xch[0][wg][16 * w + g + 8 * h] = rmx;
    }
    __syncthreads();
    float corr[2], m_new[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w + g + 8 * h;
      m_new[h] = fmaxf(m_i[h], fmaxf(xch[0][0][row], xch[0][1][row]));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        unsigned pw = 0u;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float y = sc[4 * j + 2 * h + x];
          const float p = y <= NEG_LARGE_I8 / 2 ? 0.f : expf(y - m_new[h]);
          rs += p;
          const float pq = fminf(fmaxf(rintf(p * 127.f), 0.f), 127.f);
          pw |= (unsigned)(int)pq << (8 * x);
        }
        const int col = 32 * wg + 8 * j + 2 * t;
        *reinterpret_cast<unsigned short*>(
            Pc + core_off(row, col >> 4, TILE) + (col & 15)) =
            (unsigned short)pw;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      if (t == 0) xch[1][wg][row] = rs;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // p's codes are visible to wgmma, the sums to all
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * w + g + 8 * h;
      corr[h] = expf(m_i[h] - m_new[h]);
      l_i[h] = l_i[h] * corr[h] + (xch[1][0][row] + xch[1][1][row]);
      m_i[h] = m_new[h];
    }

    int pv[NO];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TILE / 32; ++kk)
      wgmma_s8<NV>(pv, core_desc(Pc + kk * 2 * CORE, CORE, PSBO),
                   core_desc(Vt + core_off(NV * wg, 0, TILE) + kk * 2 * CORE,
                             CORE, PSBO), kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < NO; ++x) asm volatile("" : "+r"(pv[x])::"memory");
    const float vs = cur.v_s / 127.f;
#pragma unroll
    for (int x = 0; x < NO; ++x)
      acc[x] = acc[x] * corr[(x >> 1) & 1] + (float)pv[x] * vs;
    cur = nxt;
    if (s + 2 < nb) nxt = slot_of(s + 2);
  }

  const size_t m_pad = (size_t)mb * TILE;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = i * TILE + 16 * w + g + 8 * h;
    if (t == 0 && wg == 0) {
      m_out[(size_t)r * m_pad + gr] = m_i[h];
      l_out[(size_t)r * m_pad + gr] = l_i[h];
    }
    if (gr >= s_q) continue;
    const float den = fmaxf(l_i[h], 1e-30f);
#pragma unroll
    for (int j = 0; j < NV / 8; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const int d = NV * wg + 8 * j + 2 * t + (e & 1);
        if (d < hd) out[((size_t)r * s_q + gr) * hd + d] = acc[4 * j + e] / den;
      }
  }
}

template <int HD>
int launch_flash_int8(const int* cols, const int* nblk, const int* slot,
                      const int* ispart, const float* pmask, const float* q,
                      const float* k, const float* v, float* out,
                      float* m_out, float* l_out, void* work, int R,
                      int heads, int mb, int max_bpr, int n_partial,
                      int s_q, int s_kv, int hd, float scale,
                      cudaStream_t stream) {
  const int kb = (s_kv + TILE - 1) / TILE;
  if (mb > 65535) return (int)cudaErrorInvalidValue;
  float* const scales = (float*)work;
  const size_t head = ((size_t)R * kb * 2 * sizeof(float) + 127) / 128 * 128;
  signed char* const codes = (signed char*)work + head;
  if (kb > 0) {
    quant_kv_kernel<HD><<<dim3(kb, R, 2), THREADS, 0, stream>>>(
        k, v, scales, codes, s_kv, hd, kb);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  flash_int8_wgmma_kernel<HD><<<dim3(R, mb), IT, 0, stream>>>(
      cols, nblk, slot, ispart, pmask, q, codes, scales, out, m_out, l_out,
      heads, mb, max_bpr, n_partial, s_q, kb, hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace stt

// q, k, v [R, s, hd] f32 (q unscaled), out [R, s_q, hd], m_out / l_out
// [R, mb * 64]; hd <= 128. work: the pre-pass's k_s / v_s, f32 [R, kb, 2]
// (kb = ceil(s_kv / 64)), then, from the next multiple of 128 bytes, the
// codes int8 [R, kb, 2, 64 * HD] (HD = 64 for hd <= 64, else 128).
extern "C" int flash_sparse_fwd_int8(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, void* out, void* m_out, void* l_out, void* work, int R,
    int heads, int mb, int max_bpr, int n_partial, int s_q, int s_kv, int hd,
    float scale, void* stream) {
#define STT_FLASH_I8_ARGS                                                    \
  (const int*)block_cols, (const int*)nblocks, (const int*)mask_slot,       \
      (const int*)is_partial, (const float*)pmask, (const float*)q,         \
      (const float*)k, (const float*)v, (float*)out, (float*)m_out,         \
      (float*)l_out, work, R, heads, mb, max_bpr, n_partial, s_q, s_kv, hd,  \
      scale, (cudaStream_t)stream
  if (hd <= 64) return stt::launch_flash_int8<64>(STT_FLASH_I8_ARGS);
  if (hd <= 128) return stt::launch_flash_int8<128>(STT_FLASH_I8_ARGS);
#undef STT_FLASH_I8_ARGS
  return (int)cudaErrorInvalidValue;
}
