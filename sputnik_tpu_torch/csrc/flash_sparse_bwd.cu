// Sparse-flash attention backward: dq, dk, dv of
// out = softmax(q k^T * scale, masked) @ v, recomputing each occupied score
// tile from the forward's row statistics (running max m, denominator l);
// scores and probabilities are never written out.
//
// Replaces three TPU kernels of sputnik_tpu/ops/pallas/flash_sparse.py:
//   flash_sparse_bwd_fused -> flash_bwd_tc_kernel<HD, true, .>   (dq, dk, dv)
//   flash_sparse_bwd_dq    -> flash_bwd_tc_kernel<HD, false, .>  (dq)
//   flash_sparse_bwd_dkv   -> flash_bwd_col_tc_kernel<HD, .>     (dk, dv)
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
// The column walk (B10c) on the tensor cores, the row walk's mirror (two
// launches, three where the host splits the walks). Its bound: 8 * hd
// FLOPs per kept pair (two score products, two gradient products) at
// 165 TFLOP/s, 2.15 G and 0.013 ms at the driver shape.
//   * split_rows_kernel, once a call: each row block of each query replica
//     as one record: q * scale and dO split into TF32 hi / lo as [row][d]
//     (kcore: the score products' B) and as [d][row] in vcore's row order
//     (the gradient products' B), then m, 1 / max(l, 1e-30) and D (0
//     past s_q). A row block is visited by up to kb column walks: split
//     once.
//   * flash_bwd_col_tc_kernel: HD / 64 warpgroups walk the slots of one
//     (key block j, KV replica) over the transposed metadata
//     (build_flash_bwd_meta), the query replicas of its group one after
//     another, or a chunk of that walk. Keys are M in all four products:
//       S^T = K (q * scale)^T and dP^T = V dO^T: A is K or V from
//         registers, loaded from their raw rows (staged once a walk) and
//         split there; B the streamed q or dO half. Every warpgroup
//         computes both whole.
//       dK += dS^T (q * scale) and dV += P^T dO: A is dS^T / P^T straight
//         from the score accumulators (rows 2t, 2t + 1 where the k8
//         fragment wants t, t + 4: the transposed halves store the rows
//         permuted to match); B the streamed transposed half, warpgroup wg
//         taking head dims 64 wg .. + 63. m, l and D are indexed by the
//         accumulator's column (the query row); p = exp(sc - m) * (1 / l)
//         by the fast exp (the plain version divides: the two differ in
//         the last places, far inside the kernels' 1e-4).
//     dK and dV stay in registers for the whole walk and are written once:
//     no atomics, and a key column no query attends writes exactly 0. The
//     four halves of a slot stream by cp.async through two buffers, each
//     landing while the product before it runs, and dP^T runs while p is
//     formed. Shared memory: the two halves 4 * 64 * HD floats, K and V
//     raw 2 * 64 * (HD + 4), the rows' m / l / D 3 * 64: 101,120 B at
//     HD = 64 (two walks an SM), 199,424 B at HD = 128 (two warpgroups,
//     one walk an SM). Registers: dK and dV (32 each a thread), the two
//     score tiles 64, the fragments of one product 64.
//   * the split walk: with few walks for the card (the GQA ring's band: 64
//     walks of 64 slots), the host cuts each walk into chunks of `tiles`
//     slots (ops/kernels/flash_sparse.py: flash_split_tiles over the walks
//     and their longest length, group * max_bpc; one wave, as the row
//     walk's: two waves, or a split of the driver's 256 causal walks, took
//     longer than their merge saved); each chunk writes its partial dk /
//     dv to the workspace and dkv_merge_kernel sums them in chunk order:
//     no float atomics, the same bits from run to run.
#include "flash_tc.cuh"

namespace stt {

constexpr float NEG_LARGE = -1e30f;

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

// Wait for the committed products, and keep the accumulators and the
// fragments they read in their registers until then.
template <int N, int S>
__device__ __forceinline__ void mma_wait(float (&acc)[N],
                                         unsigned (&h)[S][4],
                                         unsigned (&l)[S][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int x = 0; x < N; ++x) asm volatile("" : "+f"(acc[x])::"memory");
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      asm volatile("" : "+r"(h[s][x]), "+r"(l[s][x])::"memory");
}

// Commit the issued products and wait for them (mma_wait).
template <int N, int S>
__device__ __forceinline__ void mma_done(float (&acc)[N],
                                         unsigned (&h)[S][4],
                                         unsigned (&l)[S][4]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  mma_wait(acc, h, l);
}

// acc = X . B^T over the HD head dims (S = q K^T, dP = dO V^T; the column
// walk's S^T = K q^T, dP^T = V dO^T): X raw [row][d] split in registers,
// B a split [key][d] half (kcore<HD>). Eight k8 steps a batch (64
// fragment registers h / l), each batch but the last waited for; the last
// is committed and left running: mma_wait(acc, h, l) ends it.
template <int HD>
__device__ __forceinline__ void score_issue(const float* X, const float* B,
                                            float (&acc)[32],
                                            unsigned (&h)[8][4],
                                            unsigned (&l)[8][4]) {
  constexpr unsigned SBO = HD / 4 * 128;
#pragma unroll
  for (int bt = 0; bt < HD / 64; ++bt) {
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
    if (bt + 1 < HD / 64) mma_done(acc, h, l);
    else asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
}

// score_issue, waited for.
template <int HD>
__device__ __forceinline__ void score_mma(const float* X, const float* B,
                                          float (&acc)[32]) {
  unsigned h[8][4], l[8][4];
  score_issue<HD>(X, B, acc, h, l);
  mma_wait(acc, h, l);
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

// --- the column walk on the tensor cores (B10c)

constexpr int ROW_STATS = 3 * TILE;  // m, 1 / max(l, 1e-30), D: a row block

enum ColMode { COL_WRITE = 0, COL_PART = 1 };

// floats of a row block's record: q * scale and dO split as [row][d]
// (kcore<HD>), then both as [d][row] in vcore's row order, then m, 1 /
// max(l, 1e-30) and D
template <int HD>
__host__ __device__ constexpr int col_record() {
  return 4 * split_half<HD>() + ROW_STATS;
}

// The column walk's pre-pass: the record of row block blockIdx.x of query
// replica blockIdx.y, its q * scale (blockIdx.z = 0: halves 0 and 2) or dO
// (1: halves 1 and 3) read once and written split as [row][d] and [d][row]
// (zero past s_q and hd); the first also writes the row statistics, the
// denominator as its reciprocal (one IEEE divide a row, not one a score).
template <int HD>
__global__ void __launch_bounds__(THREADS)
split_rows_kernel(const float* __restrict__ q, const float* __restrict__ g,
                  const float* __restrict__ m, const float* __restrict__ l,
                  const float* __restrict__ D, float* __restrict__ rec,
                  int mb, int s_q, int hd, float scale) {
  __shared__ float S[TILE][HD + 4];
  const int i = blockIdx.x, r = blockIdx.y, z = blockIdx.z;
  float* const R0 = rec + ((size_t)r * mb + i) * col_record<HD>();
  stage_tile<HD>((z ? g : q) + (size_t)r * s_q * hd, i * TILE, s_q, hd,
                 z ? 1.f : scale, S);
  write_split<HD>(S, false, R0 + z * split_half<HD>());
  write_split<HD>(S, true, R0 + (2 + z) * split_half<HD>());
  if (z == 0) {
    float* const st = R0 + 4 * split_half<HD>();
    stage_stats(st, st + TILE, st + 2 * TILE, m, l, D, r, i, mb, s_q);
    if (threadIdx.x < TILE)
      st[TILE + threadIdx.x] = 1.f / st[TILE + threadIdx.x];
  }
}

// Shared memory of a column-walk block: two split halves, K and V raw
// ([key][d], HD + 4 a row), the slot's m, 1 / max(l, 1e-30) and D.
template <int HD>
constexpr size_t col_walk_smem() {
  return sizeof(float) *
         (2 * split_half<HD>() + 2 * TILE * (HD + 4) + ROW_STATS);
}

// A record's first half (q * scale [row][d]) and its row statistics
// global -> shared by cp.async, one commit group; NT threads.
template <int HD, int NT>
__device__ __forceinline__ void load_q_stats(float* dst, float* st,
                                             const float* src) {
#pragma unroll 4
  for (int e = threadIdx.x; e < split_half<HD>() / 4; e += NT)
    cp_async16(dst + 4 * e, src + 4 * e, 16);
  if (threadIdx.x < ROW_STATS / 4)
    cp_async16(st + 4 * threadIdx.x,
               src + 4 * split_half<HD>() + 4 * threadIdx.x, 16);
  asm volatile("cp.async.commit_group;\n" ::);
}

// Every cp.async group but the newest has landed: visible to every warp
// and to the tensor cores.
__device__ __forceinline__ void cp_wait1_sync() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// A score tile x (accumulator layout: keys 16w + g (+ 8), rows 8j + 2t
// (+ 1)) as the A fragments of the 8 k8 steps over rows, split: a0 / a1
// keys g / g + 8 at position t (row 2t), a2 / a3 at t + 4 (row 2t + 1).
__device__ __forceinline__ void acc_frags(const float (&x)[32],
                                          unsigned (&h)[8][4],
                                          unsigned (&l)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    split_tf32(x[4 * j + 0], h[j][0], l[j][0]);
    split_tf32(x[4 * j + 2], h[j][1], l[j][1]);
    split_tf32(x[4 * j + 1], h[j][2], l[j][2]);
    split_tf32(x[4 * j + 3], h[j][3], l[j][3]);
  }
}

// acc (64 keys x the warpgroup's 64 head dims) += X^T . B over the tile's
// 64 rows (dK += dS^T (q * scale), dV += P^T dO): X^T from the fragments
// h / l, B the hi / lo pieces Th / Tl of a transposed half ([d][row]).
__device__ __forceinline__ void key_grad_mma(float (&acc)[32],
                                             unsigned (&h)[8][4],
                                             unsigned (&l)[8][4],
                                             const float* Th,
                                             const float* Tl) {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint64_t bh = core_desc(Th + j * 64, 128, KEY_SBO);
    const uint64_t bl = core_desc(Tl + j * 64, 128, KEY_SBO);
    wgmma_tf32_n64(acc, h[j], bh, 1);
    wgmma_tf32_n64(acc, h[j], bl, 1);
    wgmma_tf32_n64(acc, l[j], bh, 1);
  }
  mma_done(acc, h, l);
}

// One column walk (COL_WRITE) or one chunk of `tiles` slots of it
// (COL_PART: its dk / dv to part) of key block j, KV replica rk (the
// grid's (x, y) in the order below: j ascending is the longest causal
// walk first), chunk blockIdx.z. The walk
// is the group's query replicas one after another, nb = t_nblocks slots
// each: position p is slot p % nb of replica rk * group + p / nb. rec: the
// pre-pass's records. Thread (warp w, lane 4g + t) of warpgroup wg holds
// keys 16w + g (e < 2) and 16w + g + 8: score element 4j + e is key
// 16w + g + 8 (e >> 1), row 8j + 2t + (e & 1); dk / dv element 4j + e head
// dim 64 wg + 8j + 2t + (e & 1).
template <int HD, int MODE>
__global__ void __launch_bounds__(128 * (HD / 64))
flash_bwd_col_tc_kernel(const int* __restrict__ t_src_i,
                        const int* __restrict__ t_nblocks,
                        const int* __restrict__ t_mask_slot,
                        const int* __restrict__ t_is_partial,
                        const float* __restrict__ pmask,
                        const float* __restrict__ rec,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ dk,
                        float* __restrict__ dv, float* __restrict__ part,
                        int heads, int group, int mb, int kb, int max_bpc,
                        int n_partial, int s_kv, int hd, int tiles,
                        int sms) {
  constexpr int NT = 128 * (HD / 64), LD = HD + 4, UNIT = split_half<HD>();
  constexpr int REC = col_record<HD>();
  extern __shared__ __align__(128) float smem[];
  float* const U0 = smem;            // q * scale, then its transpose
  float* const U1 = U0 + UNIT;       // dO, then its transpose
  float* const Kr = U1 + UNIT;       // K raw [key][d]
  float* const Vr = Kr + TILE * LD;  // V raw
  float* const St = Vr + TILE * LD;  // m, 1 / l, D of the slot's rows

  const int tid = threadIdx.x, lane = tid & 31, w = (tid >> 5) & 3;
  const int wg = tid >> 7, g = lane >> 2, t = lane & 3;
  // block -> walk: the first `sms` blocks (one an SM) take the longest
  // causal walks, the rest come in reverse order, so that a long walk
  // shares its SM with a short one and then runs alone
  const int nw = gridDim.x * gridDim.y;
  const int lb = blockIdx.x + gridDim.x * blockIdx.y;
  const int wk = lb < sms ? lb : sms + (nw - 1 - lb);
  const int rk = wk % gridDim.x, j = wk / gridDim.x, ch = blockIdx.z;
  const int b = rk * group / heads;  // the mask of the group's replicas
  const size_t meta0 = ((size_t)b * kb + j) * max_bpc;
  const int nb = t_nblocks[b * kb + j];
  const int len = group * nb;
  const int p0 = MODE == COL_PART ? ch * tiles : 0;
  const int np = max(0, min(len, MODE == COL_PART ? p0 + tiles : len) - p0);
  // a slot's record and partial-tile mask, read a slot ahead
  struct Slot {
    const float* src;
    int part, mslot;
  };
  auto slot_of = [&](int p) {
    const size_t at = meta0 + p % nb;
    const int r = rk * group + p / nb;
    return Slot{rec + ((size_t)r * mb + t_src_i[at]) * REC, t_is_partial[at],
                t_mask_slot[at]};
  };
  Slot cur{rec, 0, 0}, nxt{rec, 0, 0};
  if (np > 0) {
    cur = slot_of(p0);
    load_q_stats<HD, NT>(U0, St, cur.src);
    load_half<HD, NT>(U1, cur.src + UNIT);
    if (np > 1) nxt = slot_of(p0 + 1);
  }

  // K and V of the key block, raw (0 past s_kv and hd)
  {
    const size_t koff = (size_t)rk * s_kv * hd;
    for (int e = tid; e < TILE * HD; e += NT) {
      const int key = e / HD, d = e % HD, gk = j * TILE + key;
      const bool ok = gk < s_kv && d < hd;
      const size_t at = koff + (size_t)gk * hd + d;
      Kr[key * LD + d] = ok ? k[at] : 0.f;
      Vr[key * LD + d] = ok ? v[at] : 0.f;
    }
  }
  const int keys[2] = {16 * w + g, 16 * w + g + 8};
  const int dof = wg * TILE * TILE;  // the warpgroup's head dims in a
                                     // transposed half
  float dka[32], dva[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) dka[x] = dva[x] = 0.f;

  for (int u = 0; u < np; ++u) {
    cp_wait1_sync();  // q * scale and the stats have landed; at u = 0 K
                      // and V are visible
    float sc[32];
    score_mma<HD>(Kr, U0, sc);  // S^T = K (q * scale)^T
    cp_wait0_sync();  // dO has landed; every warp is done with q * scale
    load_half<HD, NT>(U0, cur.src + 2 * UNIT);  // its transpose
    float ds[32];
    unsigned fh[8][4], fl[8][4];
    score_issue<HD>(Vr, U1, ds, fh, fl);  // dP^T = V dO^T, running while
                                          // p is formed
    if (cur.part) {
      const float* pm =
          pmask + ((size_t)b * n_partial + cur.mslot) * TILE * TILE;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (pm[(8 * jj + 2 * t + (e & 1)) * TILE + keys[e >> 1]] == 0.f)
            sc[4 * jj + e] = NEG_LARGE;
    }
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 8 * jj + 2 * t + (e & 1);
        const float x = sc[4 * jj + e];
        sc[4 * jj + e] =
            x <= NEG_LARGE / 2 ? 0.f : __expf(x - St[row]) * St[TILE + row];
      }
    mma_wait(ds, fh, fl);
    __syncthreads();  // every warp is done with dO
    load_half<HD, NT>(U1, cur.src + 3 * UNIT);  // its transpose, while ds
                                                // is formed
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[4 * jj + e] = sc[4 * jj + e] *
                         (ds[4 * jj + e] - St[2 * TILE + 8 * jj + 2 * t +
                                              (e & 1)]);
    acc_frags(ds, fh, fl);

    cp_wait1_sync();  // (q * scale)^T has landed
    key_grad_mma(dka, fh, fl, U0 + dof, U0 + TILE * HD + dof);
    __syncthreads();  // every warp is done with (q * scale)^T and the stats
    if (u + 1 < np) load_q_stats<HD, NT>(U0, St, nxt.src);
    else asm volatile("cp.async.commit_group;\n" ::);
    acc_frags(sc, fh, fl);

    cp_wait1_sync();  // dO^T has landed
    key_grad_mma(dva, fh, fl, U1 + dof, U1 + TILE * HD + dof);
    __syncthreads();  // every warp is done with dO^T
    if (u + 1 < np) load_half<HD, NT>(U1, nxt.src + UNIT);
    else asm volatile("cp.async.commit_group;\n" ::);
    cur = nxt;
    if (u + 2 < np) nxt = slot_of(p0 + u + 2);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  const size_t stride = (size_t)gridDim.x * kb * TILE * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gk = j * TILE + keys[h];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int d = 64 * wg + 8 * jj + 2 * t;
      const float2 a = make_float2(dka[4 * jj + 2 * h], dka[4 * jj + 2 * h + 1]);
      const float2 c = make_float2(dva[4 * jj + 2 * h], dva[4 * jj + 2 * h + 1]);
      if (MODE == COL_PART) {
        float* const at =
            part + (size_t)ch * stride + ((size_t)rk * kb * TILE + gk) * HD + d;
        *reinterpret_cast<float2*>(at) = a;
        *reinterpret_cast<float2*>(at + (size_t)gridDim.z * stride) = c;
      } else if (gk < s_kv) {
        const size_t at = ((size_t)rk * s_kv + gk) * hd + d;
        if (d < hd) dk[at] = a.x, dv[at] = c.x;
        if (d + 1 < hd) dk[at + 1] = a.y, dv[at + 1] = c.y;
      }
    }
  }
}

// dk (blockIdx.y = 0) or dv (1) from the chunks' partial sums, in chunk
// order: one thread four head dims of one row of [Rk, s_kv, hd]; the
// partials are [chunks, Rk, kb * 64, hdp], dk's then dv's. vec: hd % 4 ==
// 0 and dk / dv 16-byte aligned.
__global__ void __launch_bounds__(THREADS)
dkv_merge_kernel(const float* __restrict__ part, float* __restrict__ dk,
                 float* __restrict__ dv, int Rk, int kb, int s_kv, int hd,
                 int hdp, int chunks, int vec) {
  const int nq = (hd + 3) / 4;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= Rk * s_kv * nq) return;
  const int row = e / nq, d = (e - row * nq) * 4;
  const int rk = row / s_kv, key = row - rk * s_kv;
  const size_t stride = (size_t)Rk * kb * TILE * hdp;
  const float* p = part + blockIdx.y * (size_t)chunks * stride +
                   ((size_t)rk * kb * TILE + key) * hdp + d;
  float4 a = *reinterpret_cast<const float4*>(p);
  for (int c = 1; c < chunks; ++c) {
    const float4 b = *reinterpret_cast<const float4*>(p + c * stride);
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  float* const o = (blockIdx.y ? dv : dk) + (size_t)row * hd + d;
  if (vec) {
    *reinterpret_cast<float4*>(o) = a;
  } else {
    const float x[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (d + q < hd) o[q] = x[q];
  }
}

template <int HD>
int launch_cols(const int* ti, const int* tn, const int* tslot,
                const int* tpart, const float* pmask, const float* q,
                const float* k, const float* v, const float* g,
                const float* m, const float* l, const float* D, float* dk,
                float* dv, float* work, int R, int heads, int group, int mb,
                int kb, int max_bpc, int n_partial, int s_q, int s_kv,
                int hd, float scale, int tiles, int sms, cudaStream_t st) {
  const int Rk = R / group, longest = group * max_bpc;
  const int chunks = longest > tiles ? (longest + tiles - 1) / tiles : 1;
  if (tiles < 1 || kb > 65535 || chunks > 65535)
    return (int)cudaErrorInvalidValue;
  float* const rec = work;
  float* const part = rec + (size_t)R * mb * col_record<HD>();
  if (mb > 0 && R > 0) {
    split_rows_kernel<HD><<<dim3(mb, R, 2), THREADS, 0, st>>>(
        q, g, m, l, D, rec, mb, s_q, hd, scale);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  constexpr size_t smem = col_walk_smem<HD>();
  constexpr int NT = 128 * (HD / 64);
  const dim3 grid(Rk, kb, chunks);
#define STT_COL_TC_ARGS                                                      \
  ti, tn, tslot, tpart, pmask, rec, k, v, dk, dv, part, heads, group, mb,   \
      kb, max_bpc, n_partial, s_kv, hd, tiles, sms
  if (chunks == 1) {
    const int e = set_smem(flash_bwd_col_tc_kernel<HD, COL_WRITE>, smem);
    if (e) return e;
    flash_bwd_col_tc_kernel<HD, COL_WRITE><<<grid, NT, smem, st>>>(
        STT_COL_TC_ARGS);
    return (int)cudaGetLastError();
  }
  int e = set_smem(flash_bwd_col_tc_kernel<HD, COL_PART>, smem);
  if (e) return e;
  flash_bwd_col_tc_kernel<HD, COL_PART><<<grid, NT, smem, st>>>(
      STT_COL_TC_ARGS);
#undef STT_COL_TC_ARGS
  e = (int)cudaGetLastError();
  if (e) return e;
  const size_t n = (size_t)Rk * s_kv * ((hd + 3) / 4);
  const int ovec = hd % 4 == 0 &&
                   (((uintptr_t)dk | (uintptr_t)dv) & 15) == 0;
  if (n > 0)
    dkv_merge_kernel<<<dim3((unsigned)((n + THREADS - 1) / THREADS), 2),
                       THREADS, 0, st>>>(part, dk, dv, Rk, kb, s_kv, hd, HD,
                                         chunks, ovec);
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

// The column walk's workspace `work` (f32): the row blocks' records,
// R * mb * (4 * 2 * 64 * HD + 3 * 64) floats (HD = 64 for hd <= 64, else
// 128), then, where group * max_bpc > tiles, the chunks' partial dk and
// dv, 2 * chunks * (R / group) * kb * 64 * HD floats, chunks =
// ceil(group * max_bpc / tiles).

// Column walk over the transposed metadata, dk / dv [R / group, s_kv, hd];
// sms: the SMs the block order pairs long and short walks over.
extern "C" int flash_sparse_bwd_dkv_f32(
    const void* t_src_i, const void* t_nblocks, const void* t_mask_slot,
    const void* t_is_partial, const void* pmask, const void* q, const void* k,
    const void* v, const void* g, const void* m, const void* l, const void* D,
    void* dk, void* dv, void* work, int R, int heads, int group, int mb,
    int kb, int max_bpc, int n_partial, int s_q, int s_kv, int hd, int tiles,
    int sms, float scale, void* stream) {
#define STT_DKV_ARGS                                                         \
  (const int*)t_src_i, (const int*)t_nblocks, (const int*)t_mask_slot,       \
      (const int*)t_is_partial, (const float*)pmask, (const float*)q,        \
      (const float*)k, (const float*)v, (const float*)g, (const float*)m,    \
      (const float*)l, (const float*)D, (float*)dk, (float*)dv,              \
      (float*)work, R, heads, group, mb, kb, max_bpc, n_partial, s_q, s_kv,  \
      hd, scale, tiles, sms, (cudaStream_t)stream
  if (hd <= 64) return stt::launch_cols<64>(STT_DKV_ARGS);
  if (hd <= 128) return stt::launch_cols<128>(STT_DKV_ARGS);
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
