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
// Ring band (B11a): also replaces
// sputnik_tpu/ops/pallas/flash_sparse.py:flash_sparse_ring_band_fwd, one
// step of the sequence-parallel ring (parallel/ring_flash.py): the same
// body continues the online softmax across key bands from the carried
// unnormalised accumulator acc [R, mb * 64, hd] and running max /
// denominator m, l [R, mb * 64], written back unnormalised, in place; the
// caller finishes with acc / max(l, 1e-30) after the last band. q comes
// pre-scaled (scale = 1); the band's metadata is one mask for every
// replica (heads = R). The TPU kernel's 128-lane stats layout and hd_pad
// are TPU layouts: m and l are plain vectors here.
//
// What bounds it on an H100: 4 * hd FLOPs per kept key-query pair (QK^T and
// PV). In fp32-accurate split TF32 (common.cuh: three TF32 products, hi.hi
// + hi.lo + lo.hi) the tensor cores do them at 495 / 3 = 165 TFLOP/s; at
// the ring's fullest band (2048^2 keys, R = 4, hd = 64: 4.295 G) that is
// 0.026 ms, at B9's driver shape (R = 32, s = 512, hd = 64) 0.006 ms. Per
// 64 x 64 tile the softmax takes 4096 expf, so a warpgroup's tile is
// softmax-bound unless another walk's products run beside it on the SM.
//
// The design, three launches (two where the walk is not split):
//   * split_kv_kernel, once a call: K and V split into TF32 hi / lo and
//     written tile by tile in wgmma's core-matrix order (no swizzle): K as
//     [key][d] (K-major along the head dim, QK^T's B), V transposed as
//     [d][key] (K-major along the keys, PV's B; TF32 wgmma reads B K-major
//     only), its keys permuted inside each group of 8 (see vcore). A tile
//     is visited by every row block whose walk names it (32 times at the
//     ring's full band), so it is split once, not per visit, and the walk
//     needs no raw staging buffer: 96 KB of shared memory a block at
//     hd <= 64 leave room for two walks an SM.
//   * flash_tc_kernel: one warpgroup (128 threads) walks the slots of one
//     (row block, replica), or of one chunk of them. q * scale is split
//     once into shared memory. Per slot, the K tile and the V tile each
//     stream into their own buffer by cp.async, K(s + 1) while the softmax
//     and PV of slot s run, V(s + 1) while QK^T of slot s + 1 runs. QK^T is
//     wgmma m64n64k8 with both operands in shared memory; the partial-tile
//     mask, the online softmax and l are computed on the accumulator
//     fragments, the row max and sum reduced over each quad's 4 lanes. PV
//     takes p straight from the score registers as wgmma's A fragments, split
//     there: the accumulator holds (row g, keys 2t, 2t + 1) where the A
//     fragment of a k8 step wants (row g, keys t, t + 4), so V's keys are
//     stored permuted to match (vcore) and the sum over keys is unchanged.
//     acc is rescaled by exp(m_old - m_new) in registers before the PV
//     products accumulate onto it.
//   * the split walk: with few walks for the card (the ring's band: 128 of
//     32 tiles), the host cuts each walk into chunks of `tiles` slots
//     (ops/kernels/flash_sparse.py: flash_split_tiles); every chunk starts
//     from m = -1e30, l = 0, acc = 0 and writes its unnormalised state to
//     a workspace, and flash_merge_kernel folds the chunks (and, for the
//     ring, the carry) in chunk order: M = max of the parts' m, each part
//     rescaled by exp(m_part - M); a part that no kept score reached (m
//     <= -5e29, so l = 0 and acc = 0) is skipped, so a row the band never
//     touches keeps its carry bit for bit. m is a max, so it comes out
//     bit-equal to the unsplit walk's. No float atomics: the same bits
//     from run to run.
// The -1e30 sentinel stays finite and p is forced to 0 where the score is
// <= -5e29, so a fully-masked row yields m = -1e30, l = 0 and an output of
// exactly 0 (a -inf sentinel would give exp(-inf - -inf) = NaN). hd <= 64
// runs at HD = 64, hd <= 128 at HD = 128, the head dims past hd zero.
#include "flash_tc.cuh"

namespace stt {

constexpr float NEG_LARGE = -1e30f;
constexpr int FT = 128;  // threads of a walk block: one warpgroup

enum FlashMode { FINAL = 0, CARRY = 1, PART = 2 };

// floats of one split tile: K hi, K lo, V^T hi, V^T lo
template <int HD>
__host__ __device__ constexpr int kv_tile() { return 2 * split_half<HD>(); }

__device__ __forceinline__ void cp_wait1_sync() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

// Shared memory of a walk block: q * scale split (hi, lo), the K half and
// the V half of one split tile.
template <int HD>
constexpr size_t flash_tc_smem() {
  return sizeof(float) * 6 * TILE * HD;
}

// One walk (MODE FINAL, CARRY) or one chunk of `tiles` slots of it (PART)
// of row block i = mb - 1 - blockIdx.y (the longest causal walks first),
// replica blockIdx.x, chunk blockIdx.z. Thread (warp w, lane 4g + t) holds
// rows 16w + g (h = 0) and 16w + g + 8 (h = 1); score element 4j + e is
// row h = e >> 1, key 8j + 2t + (e & 1), output element 4j + e head dim
// 8j + 2t + (e & 1).
template <int HD, int MODE>
__global__ void __launch_bounds__(FT)
flash_tc_kernel(const int* __restrict__ block_cols,
                const int* __restrict__ nblocks,
                const int* __restrict__ mask_slot,
                const int* __restrict__ is_partial,
                const float* __restrict__ pmask,
                const float* __restrict__ q, const float* __restrict__ kv,
                float* __restrict__ out, float* __restrict__ m_out,
                float* __restrict__ l_out, float* __restrict__ part,
                int heads, int group, int mb, int max_bpr, int n_partial,
                int s_q, int kb, int hd, float scale, int tiles) {
  constexpr int NO = HD / 2;                 // output floats a thread
  constexpr unsigned QSBO = HD / 4 * 128;    // Q / K: an 8-row group
  constexpr unsigned VSBO = TILE / 4 * 128;  // V^T: an 8-row group
  extern __shared__ __align__(128) float smem[];
  float* const Qh = smem;
  float* const Ql = smem + TILE * HD;
  float* const Kb = smem + 2 * TILE * HD;  // hi, lo
  float* const Vb = smem + 4 * TILE * HD;  // hi, lo

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r = blockIdx.x, i = mb - 1 - (int)blockIdx.y, ch = blockIdx.z;
  const int b = r / heads, rk = r / group;
  const size_t meta0 = ((size_t)b * mb + i) * max_bpr;
  const int nb = nblocks[b * mb + i];
  const int s0 = MODE == PART ? ch * tiles : 0;
  const int nt = max(0, min(nb, MODE == PART ? s0 + tiles : nb) - s0);
  const float* const kvr = kv + (size_t)rk * kb * kv_tile<HD>();
  // a slot's split tile and partial-tile mask, read a slot ahead of use
  struct Slot {
    const float* src;
    int part, mslot;
  };
  auto slot_of = [&](int s) {
    return Slot{kvr + (size_t)block_cols[meta0 + s] * kv_tile<HD>(),
                is_partial[meta0 + s], mask_slot[meta0 + s]};
  };
  Slot cur{kvr, 0, 0}, nxt{kvr, 0, 0};
  if (nt > 0) {
    cur = slot_of(s0);
    load_half<HD, FT>(Kb, cur.src);
    load_half<HD, FT>(Vb, cur.src + 2 * TILE * HD);
    if (nt > 1) nxt = slot_of(s0 + 1);
  }

  // q * scale, split once into Qh / Ql; every load of a thread in flight
  // together
  {
    constexpr int PER = TILE * HD / FT;
    const float* Q = q + (size_t)r * s_q * hd;
    float f[PER];
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int e = tid + n * FT, row = e / HD, d = e % HD;
      const int gr = i * TILE + row;
      f[n] = gr < s_q && d < hd ? Q[(size_t)gr * hd + d] * scale : 0.f;
    }
#pragma unroll
    for (int n = 0; n < PER; ++n) {
      const int e = tid + n * FT, row = e / HD, d = e % HD;
      unsigned h, l;
      split_tf32(f[n], h, l);
      Qh[kcore<HD>(row, d)] = __uint_as_float(h);
      Ql[kcore<HD>(row, d)] = __uint_as_float(l);
    }
  }

  const size_t m_pad = (size_t)mb * TILE;
  int rows[2];
  float m_i[2], l_i[2], acc[NO];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = i * TILE + 16 * w + g + 8 * h;
    m_i[h] = MODE == CARRY ? m_out[r * m_pad + rows[h]] : NEG_LARGE;
    l_i[h] = MODE == CARRY ? l_out[r * m_pad + rows[h]] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gr = rows[e >> 1], d = 8 * j + 2 * t + (e & 1);
      acc[4 * j + e] = MODE == CARRY && gr < s_q && d < hd
                           ? out[((size_t)r * s_q + gr) * hd + d] : 0.f;
    }

  for (int u = 0; u < nt; ++u) {
    // K(s) has landed (V(s) may still be in flight); after the barrier the
    // split q is visible too
    cp_wait1_sync();
    float sc[32];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      const uint64_t qh = core_desc(Qh + ks * 64, 128, QSBO);
      const uint64_t ql = core_desc(Ql + ks * 64, 128, QSBO);
      const uint64_t kh = core_desc(Kb + ks * 64, 128, QSBO);
      const uint64_t kl = core_desc(Kb + TILE * HD + ks * 64, 128, QSBO);
      wgmma_tf32_ss_n64(sc, qh, kh, ks > 0);
      wgmma_tf32_ss_n64(sc, qh, kl, 1);
      wgmma_tf32_ss_n64(sc, ql, kh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < 32; ++x) asm volatile("" : "+f"(sc[x])::"memory");
    __syncthreads();  // every warp is done with K(s)
    if (u + 1 < nt) load_half<HD, FT>(Kb, nxt.src);
    else asm volatile("cp.async.commit_group;\n" ::);

    if (cur.part) {
      const float* pm =
          pmask + ((size_t)b * n_partial + cur.mslot) * TILE * TILE;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * w + g + 8 * (e >> 1);
          if (pm[row * TILE + 8 * j + 2 * t + (e & 1)] == 0.f)
            sc[4 * j + e] = NEG_LARGE;
        }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = NEG_LARGE;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * h], sc[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[h], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          const float x = sc[4 * j + e];
          const float p = x <= NEG_LARGE / 2 ? 0.f : expf(x - m_new);
          sc[4 * j + e] = p;
          rs += p;
        }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      corr[h] = expf(m_i[h] - m_new);
      l_i[h] = l_i[h] * corr[h] + rs;
      m_i[h] = m_new;
    }
#pragma unroll
    for (int x = 0; x < NO; ++x) acc[x] *= corr[(x >> 1) & 1];
    // p as the A fragments of the 8 k8 steps, split: a0 / a1 rows g / g + 8
    // at position t (key 2t), a2 / a3 at position t + 4 (key 2t + 1)
    unsigned ph[8][4], pl[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      split_tf32(sc[4 * j + 0], ph[j][0], pl[j][0]);
      split_tf32(sc[4 * j + 2], ph[j][1], pl[j][1]);
      split_tf32(sc[4 * j + 1], ph[j][2], pl[j][2]);
      split_tf32(sc[4 * j + 3], ph[j][3], pl[j][3]);
    }

    cp_wait1_sync();  // V(s) has landed (K(s + 1) may still be in flight)
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint64_t vh = core_desc(Vb + j * 64, 128, VSBO);
      const uint64_t vl = core_desc(Vb + TILE * HD + j * 64, 128, VSBO);
      wgmma_tf32_rs<HD>(acc, ph[j], vh, 1);
      wgmma_tf32_rs<HD>(acc, ph[j], vl, 1);
      wgmma_tf32_rs<HD>(acc, pl[j], vh, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int x = 0; x < NO; ++x) asm volatile("" : "+f"(acc[x])::"memory");
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        asm volatile("" : "+r"(ph[j][x]), "+r"(pl[j][x])::"memory");
    __syncthreads();  // every warp is done with V(s)
    if (u + 1 < nt) load_half<HD, FT>(Vb, nxt.src + 2 * TILE * HD);
    else asm volatile("cp.async.commit_group;\n" ::);
    cur = nxt;
    if (u + 2 < nt) nxt = slot_of(s0 + u + 2);
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();  // the quad's lanes have read the carried m, l

  float* const pacc = part + (size_t)ch * gridDim.x * m_pad * HD;
  float* const pml = part + (size_t)gridDim.z * gridDim.x * m_pad * HD +
                     (size_t)ch * gridDim.x * m_pad * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t at = r * m_pad + rows[h];
    if (t == 0) {
      if (MODE == PART) {
        pml[2 * at] = m_i[h];
        pml[2 * at + 1] = l_i[h];
      } else {
        m_out[at] = m_i[h];
        l_out[at] = l_i[h];
      }
    }
    const float den = MODE == FINAL ? fmaxf(l_i[h], 1e-30f) : 1.f;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 2 * h; e < 2 * h + 2; ++e) {
        const int d = 8 * j + 2 * t + (e & 1);
        if (MODE == PART)
          pacc[at * HD + d] = acc[4 * j + e];
        else if (rows[h] < s_q && d < hd)
          out[((size_t)r * s_q + rows[h]) * hd + d] =
              MODE == FINAL ? acc[4 * j + e] / den : acc[4 * j + e];
      }
  }
}

// The chunks' states folded into each row (one warp a row, R * mb * 64
// rows): M = max(carry's m, the chunks' m), each part rescaled by exp(m -
// M) and summed in chunk order after the carry; parts with m <= -5e29
// (no kept score: l = 0, acc = 0) are skipped. CARRY: acc, m, l advanced in
// place, unnormalised; else out = acc / max(l, 1e-30) for rows < s_q.
// Lane c reads chunk c's m and l (chunks <= 32, the host checks) and the
// weights go round by shuffles, so a row costs two rounds of loads.
template <int HD, bool CARRY_IN>
__global__ void __launch_bounds__(THREADS)
flash_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int R, int mb, int s_q, int hd, int chunks) {
  const int lane = threadIdx.x & 31;
  const size_t m_pad = (size_t)mb * TILE, nrows = (size_t)R * m_pad;
  const size_t at = (size_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  if (at >= nrows) return;
  const int r = (int)(at / m_pad), row = (int)(at % m_pad);
  const float* pacc = part;
  const float* pml = part + (size_t)chunks * nrows * HD;
  const float mc = CARRY_IN ? m_out[at] : NEG_LARGE;
  const float lc = CARRY_IN ? l_out[at] : 0.f;
  float mp = NEG_LARGE, lp = 0.f;
  if (lane < chunks) {
    mp = pml[2 * (lane * nrows + at)];
    lp = pml[2 * (lane * nrows + at) + 1];
  }
  float M = fmaxf(mc, mp);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  const float cc = CARRY_IN ? expf(mc - M) : 0.f;
  const bool live = mp > NEG_LARGE / 2;
  const float wl = live ? expf(mp - M) : 0.f;
  float L = lc * cc;
  for (int c = 0; c < chunks; ++c) {
    const float w = __shfl_sync(0xffffffffu, wl, c);
    const float lpc = __shfl_sync(0xffffffffu, lp, c);
    if (__shfl_sync(0xffffffffu, (int)live, c)) L += lpc * w;
  }
  const unsigned lives = __ballot_sync(0xffffffffu, live);
  for (int d0 = 0; (CARRY_IN || row < s_q) && d0 < hd; d0 += 32) {
    const int d = d0 + lane;
    const size_t o = ((size_t)r * s_q + row) * hd + d;
    float a = CARRY_IN && d < hd ? out[o] * cc : 0.f;
    for (int c = 0; c < chunks; ++c) {
      const float w = __shfl_sync(0xffffffffu, wl, c);
      if ((lives >> c & 1u) && d < hd)
        a += pacc[(c * nrows + at) * HD + d] * w;
    }
    if (d < hd) out[o] = CARRY_IN ? a : a / fmaxf(L, 1e-30f);
  }
  if (lane == 0) {
    m_out[at] = M;
    l_out[at] = L;
  }
}

template <int HD, bool RING>
int launch_flash(const int* cols, const int* nblk, const int* slot,
                 const int* ispart, const float* pmask, const float* q,
                 const float* k, const float* v, float* out, float* m_out,
                 float* l_out, float* work, int R, int heads, int group,
                 int mb, int max_bpr, int n_partial, int s_q, int s_kv,
                 int hd, float scale, int tiles, cudaStream_t st) {
  const int kb = (s_kv + TILE - 1) / TILE, Rk = R / group;
  const int chunks = max_bpr > tiles ? (max_bpr + tiles - 1) / tiles : 1;
  if (tiles < 1 || mb > 65535 || chunks > 32)
    return (int)cudaErrorInvalidValue;
  float* const kv = work;
  float* const scratch = kv + (size_t)Rk * kb * kv_tile<HD>();
  if (kb > 0 && Rk > 0) {
    split_kv_kernel<HD><<<dim3(kb, Rk, 2), THREADS, 0, st>>>(
        k, v, kv, s_kv, hd, kb, 0b10, 0b10);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  constexpr size_t smem = flash_tc_smem<HD>();
  constexpr int ONE = RING ? CARRY : FINAL;
  const dim3 grid(R, mb, chunks);
#define STT_FLASH_TC_ARGS                                                    \
  cols, nblk, slot, ispart, pmask, q, kv, out, m_out, l_out, scratch,      \
      heads, group, mb, max_bpr, n_partial, s_q, kb, hd, scale, tiles
  if (chunks == 1) {
    const int e = set_smem(flash_tc_kernel<HD, ONE>, smem);
    if (e) return e;
    flash_tc_kernel<HD, ONE><<<grid, FT, smem, st>>>(STT_FLASH_TC_ARGS);
    return (int)cudaGetLastError();
  }
  int e = set_smem(flash_tc_kernel<HD, PART>, smem);
  if (e) return e;
  flash_tc_kernel<HD, PART><<<grid, FT, smem, st>>>(STT_FLASH_TC_ARGS);
#undef STT_FLASH_TC_ARGS
  e = (int)cudaGetLastError();
  if (e) return e;
  const size_t rows = (size_t)R * mb * TILE;
  const unsigned blocks =
      (unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32));
  flash_merge_kernel<HD, RING><<<blocks, THREADS, 0, st>>>(
      scratch, out, m_out, l_out, R, mb, s_q, hd, chunks);
  return (int)cudaGetLastError();
}

}  // namespace stt

// q [R, s_q, hd], k/v [R / group, s_kv, hd], out [R, s_q, hd],
// m_out/l_out [R, mb * 64]; hd <= 128. work f32: the split K / V, (R /
// group) * ceil(s_kv / 64) * 4 * 64 * HD floats (HD = 64 for hd <= 64,
// else 128), then, where max_bpr > tiles, the chunks' states: chunks * R *
// mb * 64 * (HD + 2) floats, chunks = ceil(max_bpr / tiles).
extern "C" int flash_sparse_fwd_f32(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, void* out, void* m_out, void* l_out, void* work, int R,
    int heads, int group, int mb, int max_bpr, int n_partial, int s_q,
    int s_kv, int hd, int tiles, float scale, void* stream) {
#define STT_FLASH_ARGS                                                      \
  (const int*)block_cols, (const int*)nblocks, (const int*)mask_slot,       \
      (const int*)is_partial, (const float*)pmask, (const float*)q,         \
      (const float*)k, (const float*)v, (float*)out, (float*)m_out,         \
      (float*)l_out, (float*)work, R, heads, group, mb, max_bpr, n_partial,  \
      s_q, s_kv, hd, scale, tiles, (cudaStream_t)stream
  if (hd <= 64) return stt::launch_flash<64, false>(STT_FLASH_ARGS);
  if (hd <= 128) return stt::launch_flash<128, false>(STT_FLASH_ARGS);
#undef STT_FLASH_ARGS
  return (int)cudaErrorInvalidValue;
}

// One ring step (B11a): q [R, mb * 64, hd] pre-scaled, k/v [R / group,
// s_kv, hd] (the band), the band's metadata (one mask for all replicas),
// and the carry acc [R, mb * 64, hd], m / l [R, mb * 64], advanced in place;
// work as flash_sparse_fwd_f32's.
extern "C" int flash_sparse_ring_fwd_f32(
    const void* block_cols, const void* nblocks, const void* mask_slot,
    const void* is_partial, const void* pmask, const void* q, const void* k,
    const void* v, void* acc, void* m, void* l, void* work, int R, int group,
    int mb, int max_bpr, int n_partial, int s_kv, int hd, int tiles,
    void* stream) {
#define STT_RING_ARGS                                                        \
  (const int*)block_cols, (const int*)nblocks, (const int*)mask_slot,        \
      (const int*)is_partial, (const float*)pmask, (const float*)q,          \
      (const float*)k, (const float*)v, (float*)acc, (float*)m, (float*)l,   \
      (float*)work, R, R, group, mb, max_bpr, n_partial, mb * stt::TILE,     \
      s_kv, hd, 1.f, tiles, (cudaStream_t)stream
  if (hd <= 64) return stt::launch_flash<64, true>(STT_RING_ARGS);
  if (hd <= 128) return stt::launch_flash<128, true>(STT_RING_ARGS);
#undef STT_RING_ARGS
  return (int)cudaErrorInvalidValue;
}
