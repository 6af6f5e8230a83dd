// Sparse-flash attention backward: dq, dk, dv of
// out = softmax(q k^T * scale, masked) @ v, recomputing each occupied score
// tile from the forward's row statistics (running max m, denominator l);
// scores and probabilities are never written out.
//
// Replaces three TPU kernels of sputnik_tpu/ops/pallas/flash_sparse.py:
//   flash_sparse_bwd_fused -> flash_bwd_tc_kernel<HD, true, .>   (dq, dk, dv)
//   flash_sparse_bwd_dq    -> flash_bwd_tc_kernel<HD, false, .>  (dq)
//   flash_sparse_bwd_dkv   -> flash_bwd_dkv_kernel<HD>           (dk, dv)
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
// 0 and it adds nothing to dk / dv. Rows past s_q and keys past s_kv are
// zero in the staged operands and never stored.
//
// Ring band (B11b): also replaces
// sputnik_tpu/ops/pallas/flash_sparse.py:flash_sparse_ring_band_bwd, one
// step of the ring backward (parallel/ring_flash.py): the fused row walk
// over one key band's tiles, recomputing p from the FINAL m, l of the whole
// ring's forward, with D = rowsum(g * out). It advances the three gradient
// carries in place: dq [R, mb * 64, hd] is added to once a row block (after
// the chunks' merge where the walk is split), dk / dv [R, s_kv, hd] (the
// band's accumulators, rotating with the band) take the tiles' fp32 atomics
// without being zeroed first. q comes pre-scaled (scale = 1); the band's
// metadata is one mask for every replica; group 1 only, as on the TPU (GQA
// rings run B10b + B10c and sum the group).
//
// What bounds the row walk on an H100: 10 * hd FLOPs per kept key-query
// pair (two score products, three gradient products; 6 * hd for B10b) in
// fp32-accurate split TF32 at 495 / 3 = 165 TFLOP/s: at the driver shape
// (R = 32, s = 512, hd = 64, causal) 2.69 G, 0.016 ms; at the ring's
// fullest band (2048^2 keys, R = 4) 10.74 G, 0.065 ms. Per tile the
// softmax takes 4096 expf, so a walk is softmax-bound unless another
// walk's products run beside it on the SM.
//
// The row walk's design (B10a, B10b and B11b are one body; two launches,
// three where the host splits the walks):
//   * split_kv_kernel (flash_tc.cuh), once a call: each key block of K and
//     V split into TF32 hi / lo in the three layouts the walk reads, K as
//     [key][d] (QK^T's B), V as [key][d] (dO V^T's B) and K as [d][key]
//     with vcore's in-group key order (dS K's B; TF32 wgmma reads B K-major
//     only). A tile is visited by up to 32 row blocks (the ring's full
//     band): split once, not per visit.
//   * flash_bwd_tc_kernel: one warpgroup (128 threads) walks the slots of
//     one (row block, replica), or a chunk of them. The five products of a
//     tile are wgmma m64nNk8 TF32, each as hi.hi + hi.lo + lo.hi:
//       S = (q * scale) K^T and dP = dO V^T: M = rows, contraction hd; A is
//         q or dO from registers, loaded from their raw rows and split there;
//         B the streamed K or V half.
//       dQ += dS K: M = rows, N = hd, contraction keys; A is dS straight
//         from the dP accumulator (keys 2t, 2t + 1 where the k8 fragment
//         wants t, t + 4: the K^T half's keys are stored permuted to
//         match), B the streamed K^T half. dq stays in registers.
//       dK^T = (q * scale)^T dS and dV^T = dO^T P: M = head dims (one or
//         two m64 blocks), N = keys, contraction rows; A is q^T or dO^T in
//         registers, read from the same raw rows; B is dS (then P) written
//         split as [key][row] into shared memory, the one operand that
//         crosses the accumulator's layout. Computing dK^T rather than dK
//         keeps q and dO raw and single: dK = dS^T q would need q^T split
//         in shared memory beside them.
//     The tile's dK^T / dV^T leave the accumulators as fp32 atomics, four
//     head dims a reduction (a 4 x 4 transpose by shuffles inside each
//     quad of lanes, then atomicAdd on float4): 2 * 64 * hd / 4 a tile.
//     Per slot the three halves stream by cp.async through one buffer: V
//     lands while p is formed, K^T while ds is formed, and the next slot's
//     K during dK / dV and their atomics; the slot metadata is read a slot
//     ahead.
//     Shared memory (floats -> bytes): the staged half 2 * 64 * HD, the
//     [key][row] split score tile 2 * 64 * 64, q * scale and dO raw
//     2 * 64 * (HD + 4), m / l / D 3 * 64: 101,120 B at HD = 64 (hd 32 and
//     64: two walks an SM) and 166,656 B at HD = 128 (one walk an SM); keeping
//     q and dO split and K, V, K^T double-buffered would take 320 KB at
//     HD = 64.
//     Registers: dq HD / 2, two score tiles 64, the fragments of one
//     product 64, the dK^T / dV^T block 32.
//   * the split walk: with few walks for the card (the ring's band: 128 of
//     32 tiles), the host cuts each walk into chunks of `tiles` slots
//     (ops/kernels/flash_sparse.py: flash_split_tiles, the forward's plan).
//     p uses the forward's final m and l, so a chunk's dq needs no rescale:
//     each chunk writes its partial dq to a workspace and dq_merge_kernel
//     sums them in chunk order (after the ring's dq carry). No float atomics
//     on dq: the same bits from run to run. dk / dv take their atomics per
//     tile, split or not.
// hd <= 64 runs at HD = 64, hd <= 128 at HD = 128, the head dims past hd
// zero.
//
// The column walk (B10c), the simple design, fp32 FMA:
//   * flash_bwd_dkv_kernel: one block of 256 threads per (key column block
//     j, KV replica), walking the transposed metadata (build_flash_bwd_meta)
//     of each query replica of its group over slots u < t_nblocks[b, j]; it
//     gathers the q / g / m / l / D rows of each source row block and keeps
//     dk / dv in registers: no atomics, and a column no query attends
//     writes 0. All operand tiles sit row-major in shared memory
//     ([64][hd + 4]); each product picks the thread mapping that reads them
//     without bank conflicts: the score tiles give thread (ty, tx) rows
//     ty * 4 + i and keys tx + 16 * j; the gradient products give it four
//     keys and hd / 16 consecutive head dims. hd <= 128 (templates 32 / 64
//     / 128).
#include "flash_tc.cuh"

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

// Write a [4 keys][CPT dims] register tile (rows < nrows, d < hd).
template <int HD>
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
      if (d < hd) dst[(size_t)gr * hd + d] = acc[ii][jj];
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
  extern __shared__ __align__(128) float smem[];
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
  store_tile<HD>(dk + koff, j * TILE, s_kv, hd, ak);
  store_tile<HD>(dv + koff, j * TILE, s_kv, hd, av);
}


// --- the row walk on the tensor cores (B10a, B10b, B11b)

constexpr int BT = 128;  // threads of a row-walk block: one warpgroup
constexpr unsigned KEY_SBO = TILE / 4 * 128;  // an 8-row group, kp 64

enum RowMode { ROW_WRITE = 0, ROW_ADD = 1, ROW_PART = 2 };

// Shared memory of a row-walk block: the staged split half, the [key][row]
// split score tile (dS, then P), q * scale and dO raw ([row][d], HD + 4 a
// row), m, max(l, 1e-30) and D.
template <int HD>
constexpr size_t row_walk_smem() {
  return sizeof(float) * (split_half<HD>() + 2 * TILE * TILE +
                          2 * TILE * (HD + 4) + 3 * TILE);
}

// The A fragments (hi, lo) of k8 step ks of X . B^T: rows 16w + g (+ 8),
// columns 8 ks + t (+ 4) of the raw [row][d] tile X.
template <int HD>
__device__ __forceinline__ void row_frag(const float* X, int ks,
                                         unsigned (&h)[4], unsigned (&l)[4]) {
  constexpr int LD = HD + 4;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const float* p = X + (16 * w + (lane >> 2)) * LD + 8 * ks + (lane & 3);
  split_tf32(p[0], h[0], l[0]);
  split_tf32(p[8 * LD], h[1], l[1]);
  split_tf32(p[4], h[2], l[2]);
  split_tf32(p[8 * LD + 4], h[3], l[3]);
}

// The A fragments of k8 step s of X^T . B: rows (head dims) 64 hb + 16w +
// g (+ 8), columns (rows of X) 8s + t (+ 4) of the raw [row][d] tile X.
template <int HD>
__device__ __forceinline__ void col_frag(const float* X, int hb, int s,
                                         unsigned (&h)[4], unsigned (&l)[4]) {
  constexpr int LD = HD + 4;
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const float* p =
      X + (8 * s + (lane & 3)) * LD + 64 * hb + 16 * w + (lane >> 2);
  split_tf32(p[0], h[0], l[0]);
  split_tf32(p[8], h[1], l[1]);
  split_tf32(p[4 * LD], h[2], l[2]);
  split_tf32(p[4 * LD + 8], h[3], l[3]);
}

// Commit the issued products, wait for them, and keep the accumulators and
// the fragments they read in their registers until then.
template <int N, int S>
__device__ __forceinline__ void mma_done(float (&acc)[N],
                                         unsigned (&h)[S][4],
                                         unsigned (&l)[S][4]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int x = 0; x < N; ++x) asm volatile("" : "+f"(acc[x])::"memory");
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      asm volatile("" : "+r"(h[s][x]), "+r"(l[s][x])::"memory");
}

// acc = X . B^T over the HD head dims (S = q K^T, dP = dO V^T): X raw
// [row][d] split in registers, B a split [key][d] half (kcore<HD>). Eight
// k8 steps a batch (64 fragment registers), each batch waited for.
template <int HD>
__device__ __forceinline__ void score_mma(const float* X, const float* B,
                                          float (&acc)[32]) {
  constexpr unsigned SBO = HD / 4 * 128;
#pragma unroll
  for (int bt = 0; bt < HD / 64; ++bt) {
    unsigned h[8][4], l[8][4];
#pragma unroll
    for (int s = 0; s < 8; ++s) row_frag<HD>(X, 8 * bt + s, h[s], l[s]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int ks = 8 * bt + s;
      const uint64_t bh = core_desc(B + ks * 64, 128, SBO);
      const uint64_t bl = core_desc(B + TILE * HD + ks * 64, 128, SBO);
      wgmma_tf32_n64(acc, h[s], bh, ks > 0);
      wgmma_tf32_n64(acc, h[s], bl, 1);
      wgmma_tf32_n64(acc, l[s], bh, 1);
    }
    mma_done(acc, h, l);
  }
}

// acc (head dims 64 hb .. + 63 x the tile's 64 keys) = X^T . P over the
// tile's 64 rows (dK^T = (q * scale)^T dS, dV^T = dO^T P): X raw [row][d]
// split in registers, P the split [key][row] tile (kcore<64>).
template <int HD>
__device__ __forceinline__ void grad_mma(const float* X, const float* P,
                                         int hb, float (&acc)[32]) {
  unsigned h[8][4], l[8][4];
#pragma unroll
  for (int s = 0; s < 8; ++s) col_frag<HD>(X, hb, s, h[s], l[s]);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const uint64_t bh = core_desc(P + s * 64, 128, KEY_SBO);
    const uint64_t bl = core_desc(P + TILE * TILE + s * 64, 128, KEY_SBO);
    wgmma_tf32_n64(acc, h[s], bh, s > 0);
    wgmma_tf32_n64(acc, h[s], bl, 1);
    wgmma_tf32_n64(acc, l[s], bh, 1);
  }
  mma_done(acc, h, l);
}

// The score tile x (accumulator layout: rows 16w + g (+ 8), keys 8j + 2t
// (+ 1)) split into P as [key][row] (kcore<64>): hi, then lo.
__device__ __forceinline__ void store_keys(float* P, const float (&x)[32]) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at =
          kcore<64>(8 * j + 2 * t + (e & 1), 16 * w + g + 8 * (e >> 1));
      unsigned h, l;
      split_tf32(x[4 * j + e], h, l);
      P[at] = __uint_as_float(h);
      P[TILE * TILE + at] = __uint_as_float(l);
    }
}

__device__ __forceinline__ void swap2(float& a, float& b) {
  const float c = a;
  a = b;
  b = c;
}

// Inside each quad of lanes g = 4a .. 4a + 3 (same t; b = g & 3, lanes 4
// apart): lane b's x[c] becomes lane c's x[b].
__device__ __forceinline__ void quad_transpose(float (&x)[4], int b) {
  if (b & 1) {
    swap2(x[0], x[1]);
    swap2(x[2], x[3]);
  }
  x[1] = __shfl_xor_sync(0xffffffffu, x[1], 4);
  x[3] = __shfl_xor_sync(0xffffffffu, x[3], 4);
  if (b & 1) {
    swap2(x[0], x[1]);
    swap2(x[2], x[3]);
  }
  if (b & 2) {
    swap2(x[0], x[2]);
    swap2(x[1], x[3]);
  }
  x[2] = __shfl_xor_sync(0xffffffffu, x[2], 8);
  x[3] = __shfl_xor_sync(0xffffffffu, x[3], 8);
  if (b & 2) {
    swap2(x[0], x[2]);
    swap2(x[1], x[3]);
  }
}

// Adds acc (head dims 64 hb + 16w + g (+ 8) x keys 8j + 2t (+ 1) of key
// block c) into dst [s_kv][hd] by fp32 atomics, four head dims a
// reduction: after quad_transpose, lane b = g & 3 holds head dims 64 hb +
// 16w + 4 (g >> 2) + 8 (b >> 1) .. + 3 of key 8j + 2t + (b & 1). vec: hd %
// 4 == 0 and dst 16-byte aligned, else four scalar atomics.
__device__ __forceinline__ void red_tile(float* dst, const float (&acc)[32],
                                         int c, int hb, int s_kv, int hd,
                                         bool vec) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3, bq = g & 3;
  const int d0 = 64 * hb + 16 * w + 4 * (g >> 2) + 8 * (bq >> 1);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float x[4] = {acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]};
    quad_transpose(x, bq);
    const int key = c * TILE + 8 * j + 2 * t + (bq & 1);
    if (key >= s_kv || d0 >= hd) continue;
    float* at = dst + (size_t)key * hd + d0;
    if (vec) {
      atomicAdd(reinterpret_cast<float4*>(at),
                make_float4(x[0], x[1], x[2], x[3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d0 + e < hd) atomicAdd(at + e, x[e]);
    }
  }
}

__device__ __forceinline__ void cp_wait0_sync() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// One walk (ROW_WRITE, ROW_ADD: the ring's dq carry) or one chunk of
// `tiles` slots of it (ROW_PART: its dq to part) of row block i = mb - 1 -
// blockIdx.y (the longest causal walks first), replica blockIdx.x, chunk
// blockIdx.z. kv: the pre-pass's tiles, three split halves a key block (K,
// V, K^T). Thread (warp w, lane 4g + t) holds rows 16w + g (h = 0) and
// 16w + g + 8 (h = 1): score element 4j + e is row h = e >> 1, key 8j + 2t
// + (e & 1); dq element 4j + e head dim 8j + 2t + (e & 1).
template <int HD, bool WITH_KV, int MODE>
__global__ void __launch_bounds__(BT)
flash_bwd_tc_kernel(const int* __restrict__ block_cols,
                    const int* __restrict__ nblocks,
                    const int* __restrict__ mask_slot,
                    const int* __restrict__ is_partial,
                    const float* __restrict__ pmask,
                    const float* __restrict__ q,
                    const float* __restrict__ gout,
                    const float* __restrict__ kv,
                    const float* __restrict__ m, const float* __restrict__ l,
                    const float* __restrict__ D, float* __restrict__ dq,
                    float* __restrict__ dk, float* __restrict__ dv,
                    float* __restrict__ part, int heads, int group, int mb,
                    int max_bpr, int n_partial, int s_q, int s_kv, int kb,
                    int hd, float scale, int tiles) {
  constexpr int LD = HD + 4, UNIT = split_half<HD>(), NO = HD / 2;
  extern __shared__ __align__(128) float smem[];
  float* const U = smem;              // the staged half: K, V or K^T
  float* const PS = U + UNIT;         // dS, then P, split [key][row]
  float* const Qr = PS + 2 * TILE * TILE;
  float* const Gr = Qr + TILE * LD;
  float* const Ms = Gr + TILE * LD;
  float* const Ls = Ms + TILE;
  float* const Dr = Ls + TILE;

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r = blockIdx.x, i = mb - 1 - (int)blockIdx.y, ch = blockIdx.z;
  const int b = r / heads, rk = r / group;
  const size_t meta0 = ((size_t)b * mb + i) * max_bpr;
  const int nb = nblocks[b * mb + i];
  const int s0 = MODE == ROW_PART ? ch * tiles : 0;
  const int nt = max(0, min(nb, MODE == ROW_PART ? s0 + tiles : nb) - s0);
  const float* const kvr = kv + (size_t)rk * kb * 3 * UNIT;
  const size_t koff = (size_t)rk * s_kv * hd;
  // a slot's tile, block column and partial-tile mask, read a slot ahead
  struct Slot {
    const float* src;
    int c, part, mslot;
  };
  auto slot_of = [&](int u) {
    const size_t at = meta0 + s0 + u;
    const int c = block_cols[at];
    return Slot{kvr + (size_t)c * 3 * UNIT, c, is_partial[at], mask_slot[at]};
  };
  Slot cur{kvr, 0, 0, 0}, nxt{kvr, 0, 0, 0};
  if (nt > 0) {
    cur = slot_of(0);
    load_half<HD, BT>(U, cur.src);
    if (nt > 1) nxt = slot_of(1);
  }

  // q * scale and dO of the row block, raw (0 past s_q and hd)
  {
    const size_t qoff = (size_t)r * s_q * hd;
    for (int e = tid; e < TILE * HD; e += BT) {
      const int row = e / HD, d = e % HD, gr = i * TILE + row;
      const bool ok = gr < s_q && d < hd;
      const size_t at = qoff + (size_t)gr * hd + d;
      Qr[row * LD + d] = ok ? q[at] * scale : 0.f;
      Gr[row * LD + d] = ok ? gout[at] : 0.f;
    }
  }
  stage_stats(Ms, Ls, Dr, m, l, D, r, i, mb, s_q);
  const bool vec = (hd & 3) == 0 &&
                   ((reinterpret_cast<size_t>(dk) |
                     reinterpret_cast<size_t>(dv)) & 15) == 0;
  const int rows[2] = {16 * w + g, 16 * w + g + 8};

  float dqa[NO];
#pragma unroll
  for (int x = 0; x < NO; ++x) dqa[x] = 0.f;

  for (int u = 0; u < nt; ++u) {
    cp_wait0_sync();  // K has landed; at u = 0 the staged rows are visible
    float sc[32];
    score_mma<HD>(Qr, U, sc);
    __syncthreads();  // every warp is done with K
    load_half<HD, BT>(U, cur.src + UNIT);  // V, while p is formed

    if (cur.part) {
      const float* pm =
          pmask + ((size_t)b * n_partial + cur.mslot) * TILE * TILE;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (pm[rows[e >> 1] * TILE + 8 * j + 2 * t + (e & 1)] == 0.f)
            sc[4 * j + e] = NEG_LARGE;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float mr = Ms[rows[h]], lr = Ls[rows[h]];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float x = sc[4 * j + e];
          sc[4 * j + e] = x <= NEG_LARGE / 2 ? 0.f : expf(x - mr) / lr;
        }
    }

    cp_wait0_sync();  // V has landed
    float ds[32];
    score_mma<HD>(Gr, U, ds);
    __syncthreads();  // every warp is done with V
    load_half<HD, BT>(U, cur.src + 2 * UNIT);  // K^T, while ds is formed
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float dr = Dr[rows[h]];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e)
          ds[4 * j + e] = sc[4 * j + e] * (ds[4 * j + e] - dr);
    }
    if constexpr (WITH_KV) store_keys(PS, ds);
    // ds as the A fragments of the 8 k8 steps over keys, split: a0 / a1
    // rows g / g + 8 at position t (key 2t), a2 / a3 at t + 4 (key 2t + 1)
    unsigned dh[8][4], dl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split_tf32(ds[4 * j + 0], dh[j][0], dl[j][0]);
      split_tf32(ds[4 * j + 2], dh[j][1], dl[j][1]);
      split_tf32(ds[4 * j + 1], dh[j][2], dl[j][2]);
      split_tf32(ds[4 * j + 3], dh[j][3], dl[j][3]);
    }

    cp_wait0_sync();  // K^T has landed; dS is visible to the tensor cores
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t kh = core_desc(U + j * 64, 128, KEY_SBO);
      const uint64_t kl = core_desc(U + TILE * HD + j * 64, 128, KEY_SBO);
      wgmma_tf32_rs<HD>(dqa, dh[j], kh, 1);
      wgmma_tf32_rs<HD>(dqa, dh[j], kl, 1);
      wgmma_tf32_rs<HD>(dqa, dl[j], kh, 1);
    }
    mma_done(dqa, dh, dl);
    __syncthreads();  // every warp is done with K^T
    if (u + 1 < nt) load_half<HD, BT>(U, nxt.src);  // the next K

    if constexpr (WITH_KV) {
#pragma unroll
      for (int hb = 0; hb < HD / 64; ++hb) {
        float acc[32];
        grad_mma<HD>(Qr, PS, hb, acc);
        red_tile(dk + koff, acc, cur.c, hb, s_kv, hd, vec);
      }
      __syncthreads();  // every warp is done with dS
      store_keys(PS, sc);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();  // P is visible to the tensor cores
#pragma unroll
      for (int hb = 0; hb < HD / 64; ++hb) {
        float acc[32];
        grad_mma<HD>(Gr, PS, hb, acc);
        red_tile(dv + koff, acc, cur.c, hb, s_kv, hd, vec);
      }
    }
    cur = nxt;
    if (u + 2 < nt) nxt = slot_of(u + 2);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  const size_t m_pad = (size_t)mb * TILE;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gr = i * TILE + rows[h];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const int d = 8 * j + 2 * t + (e & 1);
        const float x = dqa[4 * j + e];
        if (MODE == ROW_PART) {
          part[(((size_t)ch * gridDim.x + r) * m_pad + gr) * HD + d] = x;
        } else if (gr < s_q && d < hd) {
          float* at = dq + ((size_t)r * s_q + gr) * hd + d;
          *at = MODE == ROW_ADD ? *at + x : x;
        }
      }
  }
}

// dq from the chunks' partial sums, in chunk order, after the carry
// (CARRY_IN: the ring's dq) or from 0: one thread an element of dq
// [R, s_q, hd].
template <int HD, bool CARRY_IN>
__global__ void __launch_bounds__(THREADS)
dq_merge_kernel(const float* __restrict__ part, float* __restrict__ dq,
                int R, int mb, int s_q, int hd, int chunks) {
  const size_t e = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (size_t)R * s_q * hd) return;
  const int d = (int)(e % hd);
  const size_t rr = e / hd;
  const int row = (int)(rr % s_q), r = (int)(rr / s_q);
  const size_t stride = (size_t)R * mb * TILE * HD;
  const float* p = part + ((size_t)r * mb * TILE + row) * HD + d;
  float a = CARRY_IN ? dq[e] : 0.f;
  for (int c = 0; c < chunks; ++c) a += p[c * stride];
  dq[e] = a;
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


template <int HD, bool WITH_KV, bool RING>
int launch_rows(const int* cols, const int* nblk, const int* slot,
                const int* ispart, const float* pmask, const float* q,
                const float* k, const float* v, const float* g,
                const float* m, const float* l, const float* D, float* dq,
                float* dk, float* dv, float* work, int R, int heads,
                int group, int mb, int max_bpr, int n_partial, int s_q,
                int s_kv, int hd, float scale, int tiles, cudaStream_t st) {
  const int kb = (s_kv + TILE - 1) / TILE, Rk = R / group;
  const int chunks = max_bpr > tiles ? (max_bpr + tiles - 1) / tiles : 1;
  if (tiles < 1 || mb > 65535 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  float* const kv = work;
  float* const part = kv + (size_t)Rk * kb * 3 * split_half<HD>();
  if (kb > 0 && Rk > 0) {
    split_kv_kernel<HD><<<dim3(kb, Rk, 3), THREADS, 0, st>>>(
        k, v, kv, s_kv, hd, kb, 0b010, 0b100);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  constexpr size_t smem = row_walk_smem<HD>();
  const dim3 grid(R, mb, chunks);
#define STT_ROW_TC_ARGS                                                      \
  cols, nblk, slot, ispart, pmask, q, g, kv, m, l, D, dq, dk, dv, part,     \
      heads, group, mb, max_bpr, n_partial, s_q, s_kv, kb, hd, scale, tiles
  if (chunks == 1) {
    constexpr int ONE = RING ? ROW_ADD : ROW_WRITE;
    const int e = set_smem(flash_bwd_tc_kernel<HD, WITH_KV, ONE>, smem);
    if (e) return e;
    flash_bwd_tc_kernel<HD, WITH_KV, ONE><<<grid, BT, smem, st>>>(
        STT_ROW_TC_ARGS);
    return (int)cudaGetLastError();
  }
  int e = set_smem(flash_bwd_tc_kernel<HD, WITH_KV, ROW_PART>, smem);
  if (e) return e;
  flash_bwd_tc_kernel<HD, WITH_KV, ROW_PART><<<grid, BT, smem, st>>>(
      STT_ROW_TC_ARGS);
#undef STT_ROW_TC_ARGS
  e = (int)cudaGetLastError();
  if (e) return e;
  const size_t n = (size_t)R * s_q * hd;
  if (n > 0)
    dq_merge_kernel<HD, RING>
        <<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, st>>>(
            part, dq, R, mb, s_q, hd, chunks);
  return (int)cudaGetLastError();
}

template <bool WITH_KV, bool RING = false>
int rows_by_hd(const void* block_cols, const void* nblocks,
               const void* mask_slot, const void* is_partial,
               const void* pmask, const void* q, const void* k,
               const void* v, const void* g, const void* m, const void* l,
               const void* D, void* dq, void* dk, void* dv, void* work,
               int R, int heads, int group, int mb, int max_bpr,
               int n_partial, int s_q, int s_kv, int hd, float scale,
               int tiles, void* stream) {
#define STT_ROWS_ARGS                                                        \
  (const int*)block_cols, (const int*)nblocks, (const int*)mask_slot,        \
      (const int*)is_partial, (const float*)pmask, (const float*)q,          \
      (const float*)k, (const float*)v, (const float*)g, (const float*)m,    \
      (const float*)l, (const float*)D, (float*)dq, (float*)dk, (float*)dv,  \
      (float*)work, R, heads, group, mb, max_bpr, n_partial, s_q, s_kv, hd,  \
      scale, tiles, (cudaStream_t)stream
  if (hd <= 64) return launch_rows<64, WITH_KV, RING>(STT_ROWS_ARGS);
  if (hd <= 128) return launch_rows<128, WITH_KV, RING>(STT_ROWS_ARGS);
#undef STT_ROWS_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace stt

// The row walk's workspace `work` (f32): the split K / V tiles, (R / group)
// * ceil(s_kv / 64) * 3 * 2 * 64 * HD floats (HD = 64 for hd <= 64, else
// 128), then, where max_bpr > tiles, the chunks' partial dq, chunks * R *
// mb * 64 * HD floats, chunks = ceil(max_bpr / tiles).

// Row walk, dq and dk / dv (dk / dv zero-initialised, [R / group, s_kv, hd],
// accumulated with atomics).
extern "C" int flash_sparse_bwd_fused_f32(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dq, void* dk, void* dv, void* work, int R, int heads, int group,
    int mb, int max_bpr, int n_partial, int s_q, int s_kv, int hd, int tiles,
    float scale, void* stream) {
  return stt::rows_by_hd<true>(block_cols, nblocks, mask_slot, is_partial,
                               pmask, q, k, v, g, m, l, D, dq, dk, dv, work,
                               R, heads, group, mb, max_bpr, n_partial, s_q,
                               s_kv, hd, scale, tiles, stream);
}

// Row walk, dq only.
extern "C" int flash_sparse_bwd_dq_f32(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dq, void* work, int R, int heads, int group, int mb, int max_bpr,
    int n_partial, int s_q, int s_kv, int hd, int tiles, float scale,
    void* stream) {
  return stt::rows_by_hd<false>(block_cols, nblocks, mask_slot, is_partial,
                                pmask, q, k, v, g, m, l, D, dq, nullptr,
                                nullptr, work, R, heads, group, mb, max_bpr,
                                n_partial, s_q, s_kv, hd, scale, tiles,
                                stream);
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
// carries dq [R, mb * 64, hd], dk / dv [R, s_kv, hd], advanced in place;
// work as the row walk's.
extern "C" int flash_sparse_ring_bwd_f32(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dq, void* dk, void* dv, void* work, int R, int mb, int max_bpr,
    int n_partial, int s_kv, int hd, int tiles, void* stream) {
  return stt::rows_by_hd<true, true>(
      block_cols, nblocks, mask_slot, is_partial, pmask, q, k, v, g, m, l, D,
      dq, dk, dv, work, R, R, 1, mb, max_bpr, n_partial, mb * stt::TILE,
      s_kv, hd, 1.f, tiles, stream);
}
