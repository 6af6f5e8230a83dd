// Int8 sparse-flash attention backward: dq, dk, dv of
// out = softmax(q k^T * scale, masked) @ v with every contraction on int8
// codes, recomputing each occupied score tile from the int8 forward's row
// statistics (running max m, denominator l).
//
// Replaces two TPU kernels of sputnik_tpu/ops/pallas/flash_sparse_int8.py:
//   flash_sparse_bwd_dq_int8  (B18b) -> quant_keys_kernel<HD>, then
//                                       flash_bwd_dq_int8_wgmma_kernel<HD>
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
// Both run on the int8 tensor cores in two launches each, one the mirror
// of the other (rows and keys swapped):
//   * a pre-pass, once a call, quantises each block the walks visit once
//     (the TPU kernels re-quantise it on each of up to 32 visits; the grid
//     of the scales does not depend on the visitor, so that is the same
//     function) into a record in wgmma's core-matrix order (no swizzle),
//     so that one cp.async stream brings a slot's whole side:
//     - B18b, quant_keys_kernel: each 64-key block of k and v: K's codes
//       K-major [key][d] (B of S = q k^T), V's K-major [key][d] (B of
//       dP = g v^T), K's transposed [d][key] (B of dQ = ds k, which
//       contracts over keys), then k_s and v_s;
//     - B18c, quant_rows_kernel: each row block of q * scale and of g: the
//       codes K-major [row][d] (B of the score products) and transposed
//       [d][row] (B of the gradient products), with the scales and the
//       rows' m, max(l, 1e-30) and D.
//   * the walk: one block of two warpgroups per (row block, replica) for
//     B18b, per (key column block, replica) for B18c. The walk's own side is
//     quantised once into shared memory (B18b: q * scale and g, A of the
//     score products; B18c: K and V, their A); each slot's record streams
//     into a two-stage ring by cp.async a slot ahead, its metadata read a
//     slot ahead too. The score products run on wgmma m64n32k32 s8 into
//     exact int32 sums, each warpgroup taking 32 of the tile's keys (B18b,
//     rows as M) or rows (B18c, keys as M, so p and ds come out key-major,
//     the layout dK / dV contract); sc, p, dp and ds are formed on the
//     fragments with the plain version's operations, and the tile's ds
//     absmax is one block-wide reduction. ds's codes (and B18c's p codes)
//     go to shared memory in core-matrix order (4 KB each) as the A of the
//     gradient products, wgmma m64n{HD / 2}k32 s8 against the record's
//     transposed codes, each warpgroup owning half the head dims; then
//     dq (dk, dv) += (float)int * scale in f32 registers, in slot order.
//     No atomics: a block owns its row block's dq (key block's dk / dv); a
//     row that attends no key (a key column that no query attends) writes 0.
// B18b: 79,904 B of shared memory at HD = 128, two walks an SM (256 walks
// at the example's shape, 1 to 32 tiles each): the first 132 blocks take
// the longest causal walks (the last row blocks), the rest come reversed,
// so that each SM pairs a long walk with a short one (B10c's order).
// B18c: 56,096 B at HD = 64, 101,152 B at HD = 128.
// 64 x 64 tiles, hd <= 128: HD = 64 for hd <= 64, else 128, the head dims
// past hd zero codes.
#include "common.cuh"

namespace stt {

constexpr float NEG_LARGE = -1e30f;
constexpr int IT = 256;  // threads of a walk block: two warpgroups

// --- B18b on the int8 tensor cores

// bytes of one key block's record: the codes of k K-major [key][d], of v
// K-major, of k transposed [d][key], then k_s and v_s; padded to 128 bytes
template <int HD>
__host__ __device__ constexpr int key_rec() {
  return (3 * TILE * HD + 2 * 4 + 127) / 128 * 128;
}

// The pre-pass, once a call: key block c of replica r of k (blockIdx.z = 0:
// K-major and transposed codes) or v (1: K-major) quantised at its tile's
// scale into its record rec[(r * kb + c) * key_rec].
template <int HD>
__global__ void __launch_bounds__(THREADS)
quant_keys_kernel(const float* __restrict__ k, const float* __restrict__ v,
                  signed char* __restrict__ rec, int kb, int s_kv, int hd) {
  __shared__ __align__(16) unsigned char S[TILE][HD + 16];
  __shared__ float red[THREADS / 32];
  const int c = blockIdx.x, r = blockIdx.y, half = blockIdx.z;
  signed char* const out = rec + ((size_t)r * kb + c) * key_rec<HD>();
  const float sc = quant_codes_tile<HD>(
      (half ? v : k) + (size_t)r * s_kv * hd, c * TILE, s_kv, hd, 1.f,
      out + half * TILE * HD, half ? nullptr : out + 2 * TILE * HD, S, red);
  if (threadIdx.x == 0)
    reinterpret_cast<float*>(out + 3 * TILE * HD)[half] = sc;
}

// Shared memory of a row-walk block.
template <int HD>
struct __align__(128) DqInt8Smem {
  signed char Qc[TILE * HD];          // q * scale codes, [row][d]
  signed char Gc[TILE * HD];          // g codes
  signed char rec[2][key_rec<HD>()];  // the streamed key-block records
  signed char DSc[TILE * TILE];       // ds codes, [row][key]
  unsigned char S[TILE][HD + 16];     // staging of the q / g quantisation
  float Ms[TILE], Ls[TILE], Dr[TILE];
  float red[IT / 32];
};

// One row walk: row block i of replica r over its slots s < nblocks, by two
// warpgroups (block -> walk: the first `sms` blocks take the longest causal
// walks, i = mb - 1 down, the rest come reversed). Warpgroup wg scores the
// tile's keys 32 wg .. 32 wg + 31 against all 64 rows, S = q_q k_q^T and
// dP = g_q v_q^T by wgmma m64n32k32 s8 (rows as M), forms sc, p, dp and ds
// on the fragments, and the tile's ds absmax is one reduction over the
// block; ds's codes go to shared memory as the A operand ([row][key]) of
// dQ = ds_q k_q, wgmma m64n{HD / 2}k32 s8 against the record's transposed K
// codes, each warpgroup owning half the head dims; then dq += int *
// (ds_s * k_s) in registers. Thread (warp w of its warpgroup, lane 4g + t):
// score element 4j + e is row 16w + g + 8 (e >> 1), key 32 wg + 8j + 2t +
// (e & 1); dq element 4j + e row 16w + g + 8 (e >> 1), head dim
// wg * HD / 2 + 8j + 2t + (e & 1).
template <int HD>
__global__ void __launch_bounds__(IT, 2)
flash_bwd_dq_int8_wgmma_kernel(const int* __restrict__ block_cols,
                               const int* __restrict__ nblocks,
                               const int* __restrict__ mask_slot,
                               const int* __restrict__ is_partial,
                               const float* __restrict__ pmask,
                               const float* __restrict__ q,
                               const float* __restrict__ g,
                               const float* __restrict__ m,
                               const float* __restrict__ l,
                               const float* __restrict__ D,
                               const signed char* __restrict__ rec,
                               float* __restrict__ dq, int heads, int mb,
                               int kb, int max_bpr, int n_partial, int s_q,
                               int hd, float scale, int sms) {
  constexpr int NV = HD / 2;                  // head dims a warpgroup
  constexpr int NO = NV / 2;                  // dq sums a thread
  constexpr int REC = key_rec<HD>();
  constexpr unsigned KSBO = HD / 16 * CORE;   // [.][d] codes: an 8-row group
  constexpr unsigned PSBO = TILE / 16 * CORE; // [.][key] codes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqInt8Smem<HD>& sm = *reinterpret_cast<DqInt8Smem<HD>*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, wg = tid >> 7;
  const int w = (tid >> 5) & 3, gq = lane >> 2, t = lane & 3;
  const int nw = gridDim.x, R = nw / mb, lb = blockIdx.x;
  const int wk = lb < sms ? lb : sms + (nw - 1 - lb);
  const int r = wk % R, i = mb - 1 - wk / R, b = r / heads;
  const size_t meta0 = ((size_t)b * mb + i) * max_bpr;
  const int nb = nblocks[b * mb + i];
  const signed char* const recr = rec + (size_t)r * kb * REC;
  // a slot's record, partial-tile flag and mask, read a slot ahead of use
  struct Slot {
    const signed char* src;
    int part, mslot;
  };
  auto slot_of = [&](int s) {
    return Slot{recr + (size_t)block_cols[meta0 + s] * REC,
                is_partial[meta0 + s], mask_slot[meta0 + s]};
  };
  auto load = [&](int s, const signed char* src) {
    signed char* dst = sm.rec[s & 1];
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
  // the walk's own row block of q * scale and g, quantised once
  const size_t qoff = (size_t)r * s_q * hd;
  const float q_s = quant_codes_tile<HD>(q + qoff, i * TILE, s_q, hd, scale,
                                         sm.Qc, nullptr, sm.S, sm.red);
  const float g_s = quant_codes_tile<HD>(g + qoff, i * TILE, s_q, hd, 1.f,
                                         sm.Gc, nullptr, sm.S, sm.red);
  stage_stats(sm.Ms, sm.Ls, sm.Dr, m, l, D, r, i, mb, s_q);

  float acc[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) acc[x] = 0.f;

  for (int s = 0; s < nb; ++s) {
    // slot s has landed; every warp is done with slot s - 1 (its stage and
    // DSc are free); at s = 0 the q / g codes and the stats are visible
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (s + 1 < nb) load(s + 1, nxt.src);
    const signed char* const Kc = sm.rec[s & 1];
    const signed char* const Vc = Kc + TILE * HD;
    const signed char* const KT = Kc + 2 * TILE * HD;
    const float* const ks = reinterpret_cast<const float*>(Kc + 3 * TILE * HD);
    const float k_s = ks[0], v_s = ks[1];

    // S, waited for; then dP, left running while p is formed
    int si[16], di[16];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < HD / 32; ++kk)
      wgmma_s8_n32(si, core_desc(sm.Qc + kk * 2 * CORE, CORE, KSBO),
                   core_desc(Kc + core_off(32 * wg, 0, HD) + kk * 2 * CORE,
                             CORE, KSBO), kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < 16; ++x) asm volatile("" : "+r"(si[x])::"memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < HD / 32; ++kk)
      wgmma_s8_n32(di, core_desc(sm.Gc + kk * 2 * CORE, CORE, KSBO),
                   core_desc(Vc + core_off(32 * wg, 0, HD) + kk * 2 * CORE,
                             CORE, KSBO), kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");

    // sc, p, dp and ds as the plain version forms them
    const float qk = q_s * k_s, gv = g_s * v_s;
    const float* pm =
        cur.part ? pmask + ((size_t)b * n_partial + cur.mslot) * TILE * TILE
                 : nullptr;
    float pr[16];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * w + gq + 8 * (e >> 1);
        const int key = 32 * wg + 8 * jj + 2 * t + (e & 1);
        float sc = __fmul_rn((float)si[4 * jj + e], qk);
        if (pm != nullptr && pm[row * TILE + key] == 0.f) sc = NEG_LARGE;
        pr[4 * jj + e] =
            sc <= NEG_LARGE / 2 ? 0.f : expf(sc - sm.Ms[row]) / sm.Ls[row];
      }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < 16; ++x) asm volatile("" : "+r"(di[x])::"memory");
    float ds[16];
    float mx = 0.f;
#pragma unroll
    for (int x = 0; x < 16; ++x) {
      const float dp = __fmul_rn((float)di[x], gv);
      ds[x] = pr[x] * (dp - sm.Dr[16 * w + gq + 8 * ((x & 3) >> 1)]);
      mx = fmaxf(mx, fabsf(ds[x]));
    }
    // the tile's ds absmax over the block: red's last readers (the slot
    // before, or the prologue) have passed a barrier since, so one barrier
    // suffices here
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) sm.red[tid >> 5] = mx;
    __syncthreads();
    float amax = 0.f;
#pragma unroll
    for (int x = 0; x < IT / 32; ++x) amax = fmaxf(amax, sm.red[x]);
    const float ds_s = tile_scale(amax);
    // the codes, two keys a 16-bit store, [row][key] in core-matrix order
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * w + gq + 8 * h;
        const int key = 32 * wg + 8 * jj + 2 * t;
        const unsigned dw = quant_i8(ds[4 * jj + 2 * h], ds_s) |
                            quant_i8(ds[4 * jj + 2 * h + 1], ds_s) << 8;
        *reinterpret_cast<unsigned short*>(
            sm.DSc + core_off(row, key >> 4, TILE) + (key & 15)) =
            (unsigned short)dw;
      }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the codes are visible to wgmma

    int gi[NO];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < TILE / 32; ++kk)
      wgmma_s8<NV>(gi, core_desc(sm.DSc + kk * 2 * CORE, CORE, PSBO),
                   core_desc(KT + core_off(NV * wg, 0, TILE) + kk * 2 * CORE,
                             CORE, PSBO), kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < NO; ++x) asm volatile("" : "+r"(gi[x])::"memory");
    const float dk_s = ds_s * k_s;
#pragma unroll
    for (int x = 0; x < NO; ++x) acc[x] += __fmul_rn((float)gi[x], dk_s);
    cur = nxt;
    if (s + 2 < nb) nxt = slot_of(s + 2);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = i * TILE + 16 * w + gq + 8 * h;
    if (gr >= s_q) continue;
#pragma unroll
    for (int jj = 0; jj < NV / 8; ++jj)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const int d = NV * wg + 8 * jj + 2 * t + (e & 1);
        if (d < hd) dq[qoff + (size_t)gr * hd + d] = acc[4 * jj + e];
      }
  }
}

// --- B18c on the int8 tensor cores

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
                   void* work, int R, int heads, int mb, int max_bpr,
                   int n_partial, int s_q, int s_kv, int hd, int sms,
                   float scale, cudaStream_t stream) {
  const int kb = (s_kv + TILE - 1) / TILE;
  signed char* const rec = (signed char*)work;
  if (kb > 0) {
    quant_keys_kernel<HD><<<dim3(kb, R, 2), THREADS, 0, stream>>>(
        k, v, rec, kb, s_kv, hd);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  constexpr size_t smem = sizeof(DqInt8Smem<HD>);
  const int err = set_smem(flash_bwd_dq_int8_wgmma_kernel<HD>, smem);
  if (err) return err;
  flash_bwd_dq_int8_wgmma_kernel<HD><<<R * mb, IT, smem, stream>>>(
      cols, nblk, slot, part, pmask, q, g, m, l, D, rec, dq, heads, mb, kb,
      max_bpr, n_partial, s_q, hd, scale, sms);
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
// work: the pre-pass's key-block records, R * kb * key_rec<HD> bytes (kb =
// ceil(s_kv / 64); key_rec: 3 * 64 * HD + 8 rounded up to 128; HD = 64 for
// hd <= 64, else 128). sms: the SMs the block order pairs long and short
// walks over.
extern "C" int flash_sparse_bwd_dq_int8(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dq, void* work, int R, int heads, int mb, int max_bpr,
    int n_partial, int s_q, int s_kv, int hd, int sms, float scale,
    void* stream) {
#define STT_DQ_I8_ARGS                                                       \
  (const int*)block_cols, (const int*)nblocks, (const int*)mask_slot,        \
      (const int*)is_partial, (const float*)pmask, (const float*)q,          \
      (const float*)k, (const float*)v, (const float*)g, (const float*)m,    \
      (const float*)l, (const float*)D, (float*)dq, work, R, heads, mb,      \
      max_bpr, n_partial, s_q, s_kv, hd, sms, scale, (cudaStream_t)stream
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
