// Int8 sparse-flash attention backward: dq, dk, dv of
// out = softmax(q k^T * scale, masked) @ v with every contraction on int8
// codes, recomputing each occupied score tile from the int8 forward's row
// statistics (running max m, denominator l).
//
// Replaces two TPU kernels of sputnik_tpu/ops/pallas/flash_sparse_int8.py:
//   flash_sparse_bwd_dq_int8  (B18b) -> flash_bwd_dq_int8_kernel<HD>
//   flash_sparse_bwd_dkv_int8 (B18c) -> quant_rows_kernel<HD>, then
//                                       flash_bwd_dkv_int8_wgmma_kernel<HD>
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
//
// B18b, the simple design: one block of 256 threads per (row block,
// replica), multiplying with __dp4a on the CUDA cores and re-quantising
// every visited K / V tile, as the TPU kernel does: instruction-bound, far
// from that bound. Codes are staged in shared memory as 32-bit words of four
// int8 values along each product's contraction: words of four head dims
// ([word][row or key]) for the two score products (tile_dp4a, thread
// (ty, tx) owning rows ty * 4 + i and keys tx * 4 + j), words of four keys
// ([key word][dim]) of k for dS K; ds's codes go to shared memory
// row-major. dq stays in registers, 4 rows x hd / 16 dims per thread. 49 KB
// of shared memory at hd = 128, dynamic.
//
// B18c on the int8 tensor cores, two launches:
//   * quant_rows_kernel, once a call: every row block of q * scale and of g
//     quantised once (the TPU kernel re-quantises a row block on each of up
//     to 32 visits) into a record: the codes K-major [row][d] (B of the
//     score products) and transposed [d][row] (B of the gradient products,
//     which contract over rows), in core-matrix order, with the scales and
//     the rows' m, max(l, 1e-30) and D beside them, so that one cp.async
//     stream brings a slot's whole row side.
//   * flash_bwd_dkv_int8_wgmma_kernel: one block of two warpgroups per (key
//     column block, replica): K and V codes quantised once and resident;
//     the score products S^T = k_q q_q^T and dP^T = v_q g_q^T on wgmma
//     m64n32k32 s8 with keys as M, so p and ds come out key-major, the
//     layout dK and dV need; one block-wide absmax of ds a tile; p's and
//     ds's codes through shared memory (2 x 4 KB) as the A operands of
//     dK = ds_q^T q_q and dV = p_q^T g_q (wgmma m64n{hd / 2}k32 s8, a
//     warpgroup a half of the head dims). No atomics: a block owns its key
//     block's dk / dv, and a key column that no query attends writes 0.
//     Shared memory: 56,096 B at HD = 64, 101,152 B at HD = 128 (two walks
//     an SM: R x kb = 256 walks at the example's shape).
// 64 x 64 tiles, hd <= 128 (B18b: templates 32 / 64 / 128; B18c: hd <= 64
// at HD = 64, else 128, the head dims past hd zero codes).
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

// --- B18c on the int8 tensor cores

constexpr int IT = 256;  // threads of a column-walk block: two warpgroups

// bytes of one row block's record: the codes of q * scale and of g, each
// K-major [row][d] (rows 64, kp HD) and transposed [d][row] (rows HD, kp
// 64), then m, max(l, 1e-30), D (64 floats each) and q_s, g_s; padded to
// 128 bytes
template <int HD>
__host__ __device__ constexpr int row_rec() {
  return (4 * TILE * HD + (3 * TILE + 2) * 4 + 127) / 128 * 128;
}

// The pre-pass, once a call: row block i of replica r of q * scale
// (blockIdx.z = 0) or g (1) quantised at its tile's scale into its record
// rec[(r * mb + i) * row_rec]: the codes in both layouts, the scale, and
// (q's block) the rows' statistics. The grid of the scales does not depend
// on the visitor, so the TPU kernel's per-visit quantisation of each row
// block (a TPU grid step has no earlier pass) is the same function done
// once.
template <int HD>
__global__ void __launch_bounds__(THREADS)
quant_rows_kernel(const float* __restrict__ q, const float* __restrict__ g,
                  const float* __restrict__ m, const float* __restrict__ l,
                  const float* __restrict__ D, signed char* __restrict__ rec,
                  int mb, int s_q, int hd, float scale) {
  __shared__ __align__(16) unsigned char S[TILE][HD + 16];
  __shared__ float red[THREADS / 32];
  const int i = blockIdx.x, r = blockIdx.y, half = blockIdx.z;
  signed char* const out = rec + ((size_t)r * mb + i) * row_rec<HD>();
  float* const st = reinterpret_cast<float*>(out + 4 * TILE * HD);
  const float sc = quant_codes_tile<HD>(
      (half ? g : q) + (size_t)r * s_q * hd, i * TILE, s_q, hd,
      half ? 1.f : scale, out + half * TILE * HD,
      out + (2 + half) * TILE * HD, S, red);
  if (half == 0) stage_stats(st, st + TILE, st + 2 * TILE, m, l, D, r, i, mb,
                             s_q);
  if (threadIdx.x == 0) st[3 * TILE + half] = sc;
}

// Shared memory of a column-walk block.
template <int HD>
struct __align__(128) DkvInt8Smem {
  signed char Kc[TILE * HD];          // k codes, [key][d], core-matrix order
  signed char Vc[TILE * HD];          // v codes
  signed char rec[2][row_rec<HD>()];  // the streamed row-block records
  signed char DSc[TILE * TILE];       // ds codes, [key][row]
  signed char Pc[TILE * TILE];        // p codes, [key][row]
  unsigned char S[TILE][HD + 16];     // staging of the K / V quantisation
  float red[IT / 32];
};

// One column walk: key block j = blockIdx.x of replica r = blockIdx.y over
// its slots u < t_nblocks, by two warpgroups. The block quantises its K and
// V block once into shared memory (A of the score products); each slot's
// row-block record streams into a two-stage ring by cp.async a slot ahead,
// its metadata read a slot ahead too. Warpgroup wg scores the tile's rows
// 32 wg .. 32 wg + 31 against all 64 keys, S^T = k_q q_q^T and dP^T =
// v_q g_q^T by wgmma m64n32k32 s8 into exact int32 sums (keys as M, so p and
// ds come out key-major, the layout dK / dV contract), forms sc, p, dp and
// ds on the fragments with the plain version's operations, and the tile's
// ds absmax is one reduction over the block. p's and ds's codes go to
// shared memory in core-matrix order as the A operands ([key][row]) of
// dK = ds_q^T q_q and dV = p_q^T g_q, wgmma m64n{HD / 2}k32 s8 against the
// record's transposed codes, each warpgroup owning half the head dims; then
// dk += int * (ds_s * q_s), dv += int * (g_s / 127) in registers. Thread
// (warp w of its warpgroup, lane 4g + t): score element 4j + e is key 16w
// + g + 8 (e >> 1), row 32 wg + 8j + 2t + (e & 1); dk / dv element 4j + e
// key 16w + g + 8 (e >> 1), head dim wg * HD / 2 + 8j + 2t + (e & 1).
template <int HD>
__global__ void __launch_bounds__(IT, 2)
flash_bwd_dkv_int8_wgmma_kernel(const int* __restrict__ t_src_i,
                                const int* __restrict__ t_nblocks,
                                const int* __restrict__ t_mask_slot,
                                const int* __restrict__ t_is_partial,
                                const float* __restrict__ pmask,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                const signed char* __restrict__ rec,
                                float* __restrict__ dk,
                                float* __restrict__ dv, int heads, int mb,
                                int kb, int max_bpc, int n_partial, int s_kv,
                                int hd) {
  constexpr int NV = HD / 2;                  // head dims a warpgroup
  constexpr int NO = NV / 2;                  // dk (dv) sums a thread
  constexpr int REC = row_rec<HD>();
  constexpr unsigned KSBO = HD / 16 * CORE;   // [.][d] codes: an 8-row group
  constexpr unsigned PSBO = TILE / 16 * CORE; // [.][row] codes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvInt8Smem<HD>& sm = *reinterpret_cast<DkvInt8Smem<HD>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int w = (tid >> 5) & 3, g = lane >> 2, t = lane & 3;
  const int j = blockIdx.x, r = blockIdx.y, b = r / heads;
  const size_t meta0 = ((size_t)b * kb + j) * max_bpc;
  const int nb = t_nblocks[b * kb + j];
  const signed char* const recr = rec + (size_t)r * mb * REC;
  // a slot's record, partial-tile flag and mask, read a slot ahead of use
  struct Slot {
    const signed char* src;
    int part, mslot;
  };
  auto slot_of = [&](int u) {
    return Slot{recr + (size_t)t_src_i[meta0 + u] * REC,
                t_is_partial[meta0 + u], t_mask_slot[meta0 + u]};
  };
  auto load = [&](int u, const signed char* src) {
    signed char* dst = sm.rec[u & 1];
#pragma unroll 4
    for (int e = tid; e < REC / 16; e += IT)
      cp_async16(dst + 16 * e, src + 16 * e, 16);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  Slot cur{recr, 0, 0}, nxt{recr, 0, 0};
  if (nb > 0) {
    cur = slot_of(0);
    load(0, cur.src);
    if (nb > 1) nxt = slot_of(1);
  }
  // the walk's own K and V block, quantised once
  const size_t koff = (size_t)r * s_kv * hd;
  const float k_s = quant_codes_tile<HD>(k + koff, j * TILE, s_kv, hd, 1.f,
                                         sm.Kc, nullptr, sm.S, sm.red);
  const float v_s = quant_codes_tile<HD>(v + koff, j * TILE, s_kv, hd, 1.f,
                                         sm.Vc, nullptr, sm.S, sm.red);

  float ak[NO], av[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) ak[x] = av[x] = 0.f;

  for (int u = 0; u < nb; ++u) {
    // slot u has landed; every warp is done with slot u - 1 (its stage,
    // DSc and Pc are free); at u = 0 the K / V codes are visible
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (u + 1 < nb) load(u + 1, nxt.src);
    const signed char* const Qc = sm.rec[u & 1];
    const signed char* const Gc = Qc + TILE * HD;
    const signed char* const QT = Qc + 2 * TILE * HD;
    const signed char* const GT = Qc + 3 * TILE * HD;
    const float* const st = reinterpret_cast<const float*>(Qc + 4 * TILE * HD);
    const float q_s = st[3 * TILE], g_s = st[3 * TILE + 1];

    int si[16], di[16];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < HD / 32; ++ks)
      wgmma_s8_n32(si, core_desc(sm.Kc + ks * 2 * CORE, CORE, KSBO),
                   core_desc(Qc + core_off(32 * wg, 0, HD) + ks * 2 * CORE,
                             CORE, KSBO), ks > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < 16; ++x) asm volatile("" : "+r"(si[x])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < HD / 32; ++ks)
      wgmma_s8_n32(di, core_desc(sm.Vc + ks * 2 * CORE, CORE, KSBO),
                   core_desc(Gc + core_off(32 * wg, 0, HD) + ks * 2 * CORE,
                             CORE, KSBO), ks > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < 16; ++x) asm volatile("" : "+r"(di[x])::"memory");

    // sc, p, dp and ds as the plain version forms them
    const float qk = q_s * k_s, gv = g_s * v_s;
    const float* pm =
        cur.part ? pmask + ((size_t)b * n_partial + cur.mslot) * TILE * TILE
                 : nullptr;
    float p[16], ds[16];
    float mx = 0.f;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 16 * w + g + 8 * (e >> 1);
        const int row = 32 * wg + 8 * jj + 2 * t + (e & 1);
        float sc = __fmul_rn((float)si[4 * jj + e], qk);
        if (pm != nullptr && pm[row * TILE + key] == 0.f) sc = NEG_LARGE;
        const float pr =
            sc <= NEG_LARGE / 2 ? 0.f : expf(sc - st[row]) / st[TILE + row];
        const float dp = __fmul_rn((float)di[4 * jj + e], gv);
        p[4 * jj + e] = pr;
        ds[4 * jj + e] = pr * (dp - st[2 * TILE + row]);
        mx = fmaxf(mx, fabsf(ds[4 * jj + e]));
      }
    const float ds_s = tile_scale(block_max(mx, sm.red));
    // the codes, two rows a 16-bit store, [key][row] in core-matrix order
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = 16 * w + g + 8 * h;
        const int row = 32 * wg + 8 * jj + 2 * t;
        unsigned dw = 0u, pw = 0u;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          dw |= quant_i8(ds[4 * jj + 2 * h + x], ds_s) << (8 * x);
          const float pq =
              fminf(fmaxf(rintf(p[4 * jj + 2 * h + x] * 127.f), 0.f), 127.f);
          pw |= (unsigned)(int)pq << (8 * x);
        }
        const size_t at = core_off(key, row >> 4, TILE) + (row & 15);
        *reinterpret_cast<unsigned short*>(sm.DSc + at) = (unsigned short)dw;
        *reinterpret_cast<unsigned short*>(sm.Pc + at) = (unsigned short)pw;
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the codes are visible to wgmma

    // dK, then dV, through one set of int32 accumulators (two blocks an
    // SM fit 128 registers a thread)
    int gi[NO];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TILE / 32; ++kk)
      wgmma_s8<NV>(gi, core_desc(sm.DSc + kk * 2 * CORE, CORE, PSBO),
                   core_desc(QT + core_off(NV * wg, 0, TILE) + kk * 2 * CORE,
                             CORE, PSBO), kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < NO; ++x) asm volatile("" : "+r"(gi[x])::"memory");
    const float dq_s = ds_s * q_s, pg_s = g_s / 127.f;
#pragma unroll
    for (int x = 0; x < NO; ++x) ak[x] += (float)gi[x] * dq_s;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TILE / 32; ++kk)
      wgmma_s8<NV>(gi, core_desc(sm.Pc + kk * 2 * CORE, CORE, PSBO),
                   core_desc(GT + core_off(NV * wg, 0, TILE) + kk * 2 * CORE,
                             CORE, PSBO), kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < NO; ++x) asm volatile("" : "+r"(gi[x])::"memory");
#pragma unroll
    for (int x = 0; x < NO; ++x) av[x] += (float)gi[x] * pg_s;
    cur = nxt;
    if (u + 2 < nb) nxt = slot_of(u + 2);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gk = j * TILE + 16 * w + g + 8 * h;
    if (gk >= s_kv) continue;
#pragma unroll
    for (int jj = 0; jj < NV / 8; ++jj)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const int d = NV * wg + 8 * jj + 2 * t + (e & 1);
        if (d >= hd) continue;
        dk[koff + (size_t)gk * hd + d] = ak[4 * jj + e];
        dv[koff + (size_t)gk * hd + d] = av[4 * jj + e];
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
                    float* dv, void* work, int R, int heads, int mb, int kb,
                    int max_bpc, int n_partial, int s_q, int s_kv, int hd,
                    float scale, cudaStream_t stream) {
  signed char* const rec = (signed char*)work;
  if (mb > 0) {
    quant_rows_kernel<HD><<<dim3(mb, R, 2), THREADS, 0, stream>>>(
        q, g, m, l, D, rec, mb, s_q, hd, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  constexpr size_t smem = sizeof(DkvInt8Smem<HD>);
  const int err = set_smem(flash_bwd_dkv_int8_wgmma_kernel<HD>, smem);
  if (err) return err;
  flash_bwd_dkv_int8_wgmma_kernel<HD><<<dim3(kb, R), IT, smem, stream>>>(
      ti, tn, tslot, tpart, pmask, k, v, rec, dk, dv, heads, mb, kb, max_bpc,
      n_partial, s_kv, hd);
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

// Column walk over the transposed metadata, dk / dv [R, s_kv, hd]; hd <=
// 128. work: the pre-pass's row-block records, R * mb * row_rec<HD> bytes
// (row_rec: 4 * 64 * HD + 776 rounded up to 128; HD = 64 for hd <= 64,
// else 128).
extern "C" int flash_sparse_bwd_dkv_int8(
    const void* t_src_i, const void* t_nblocks, const void* t_mask_slot,
    const void* t_is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dk, void* dv, void* work, int R, int heads, int mb, int kb,
    int max_bpc, int n_partial, int s_q, int s_kv, int hd, float scale,
    void* stream) {
#define STT_DKV_I8_ARGS                                                      \
  (const int*)t_src_i, (const int*)t_nblocks, (const int*)t_mask_slot,       \
      (const int*)t_is_partial, (const float*)pmask, (const float*)q,        \
      (const float*)k, (const float*)v, (const float*)g, (const float*)m,    \
      (const float*)l, (const float*)D, (float*)dk, (float*)dv, work, R,     \
      heads, mb, kb, max_bpc, n_partial, s_q, s_kv, hd, scale,               \
      (cudaStream_t)stream
  if (hd <= 64) return stt::launch_dkv_int8<64>(STT_DKV_I8_ARGS);
  if (hd <= 128) return stt::launch_dkv_int8<128>(STT_DKV_I8_ARGS);
#undef STT_DKV_I8_ARGS
  return (int)cudaErrorInvalidValue;
}
