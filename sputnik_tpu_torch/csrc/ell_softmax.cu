// Sparse softmax (B5): the masked row softmax and its backward, on two
// layouts of the same function, in one kernel body.
//
// Replaces the TPU kernel
// sputnik_tpu/ops/pallas/ell_softmax.py:ell_softmax_panel (the masked row
// softmax on an ELL panel), and the row-wise VJP p * (g - rowsum(p * g))
// that JAX takes in XLA (sputnik_tpu/ops/api.py _sparse_softmax_bwd,
// sputnik_tpu/ops/panel_api.py _softmax_bwd, sputnik_tpu/ops/
// batched_panel.py _sm_bh_bwd). Two address policies say where a row's
// slots lie:
//
//   CsrRows   values [R, nnz_pad]; row i of replica r is the slots
//             row_offsets[i] .. row_offsets[i + 1]; row m is the padding
//             nnz .. nnz_pad (no slot live: written 0 forward).
//   PanelRows a panel [R, mb, max_bpr, bm, bk]; row i of row block b is
//             max_bpr runs of bk contiguous floats, one tile apart; the
//             slots where mask[r / heads] (f32 [n_masks, mb, max_bpr, bm,
//             bk]) is nonzero are live; tiles t >= nblocks[r / heads, b]
//             are absent (mask 0 there) and are not read forward.
//
// Two modes: FORWARD p = exp(x - max) / max(sum, FLT_MIN) over the live
// slots (masked and absent scores are -inf by select, so they give exactly
// 0, and the row max is clamped at -1e30: a row of -inf scores, or with no
// live slot, gives zeros); BACKWARD dx = p * (g - sum_row p * g) over every
// slot of the row, masked ones included, as the plain versions sum it (a
// NaN cotangent at a masked slot reaches its row, as in JAX). expf (no
// __expf), and a product by the row's reciprocal 1 / sum, rounded once a
// row, where the plain versions divide each slot: within two ulp of their
// quotient, so the two agree slot by slot. A divide a slot was the
// forward's largest cost: its range check sends each zero numerator (a
// masked slot, a CSR chunk's element outside its row) to the slow path.
//
// What bounds it on an H100: bytes. Forward reads each live score once and
// writes each slot once; backward reads p and g once and writes dx once. A
// handful of operations a slot (max, exp, sum, divide).
//
// The design. A team of L lanes (8, 16 or 32, sized by the host to the
// row's length) owns a row, 256 / L rows a block, so a short row does not
// leave most of a warp idle. Every load and store is 16 bytes where the
// row allows it: a CSR row is cut into the 16-byte-aligned chunks that
// overlap it (the head and tail chunks partly outside the row, their
// outside elements selected away, and stored element by element); a panel
// run is aligned whenever bk % 4 == 0 (VEC = 4; else VEC = 1). A row of up
// to L * NV chunks stays in registers (one read, one write; NV = 4 where the
// row fits, for fewer registers and more rows in flight, else 8); a longer
// one folds max and sum online in one pass and writes in a second. Forward
// touches only the chunks a row has: no exp past the row's end, and an
// absent tile is written without a read. Team indices and a run's offsets
// are 32-bit, a power-of-two run length a shift. A team reduces with
// shuffles under its own lane mask, so teams of one warp may take
// different paths. One owner holds the whole row on both policies: no
// cross-block merge, no atomics, the same bits on every call.
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace stt_softmax {

constexpr int THREADS = 256;
constexpr float NEG_LARGE = -1e30f;  // the TPU kernel's row-max floor

template <int VEC>
struct Chunk {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Chunk<VEC> load(const float* p) {
  Chunk<VEC> c;
  if constexpr (VEC == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    c.v[0] = t.x, c.v[1] = t.y, c.v[2] = t.z, c.v[3] = t.w;
  } else {
    c.v[0] = __ldg(p);
  }
  return c;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Chunk<VEC>& c) {
  if constexpr (VEC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(c.v[0], c.v[1], c.v[2],
                                                c.v[3]);
  else
    *p = c.v[0];
}

template <int L>
__device__ __forceinline__ float team_max(float v, unsigned mask) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, o));
  return v;
}

template <int L>
__device__ __forceinline__ float team_sum(float v, unsigned mask) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o);
  return v;
}

// max(s, FLT_MIN) that keeps a NaN sum NaN, as torch.clamp does.
__device__ __forceinline__ float clamp_denom(float s) {
  return s < FLT_MIN ? FLT_MIN : s;
}

// CSR rows: chunk c of a row covers the elements 4c - mis .. 4c - mis + 3
// of the row (mis: the row start's offset in its 16-byte block), at
// element offset base + 4c. The outside elements of the head and tail
// chunks lie in the same 16-byte block as a row element, so the aligned
// load never leaves the buffer.
struct CsrRows {
  static constexpr int VEC = 4;
  const int* row_offsets;
  int m, nnz, nnz_pad;
  int teams;  // R * (m + 1)

  struct Row {
    long long base;  // the aligned element offset of chunk 0
    int mis, len, nch;
    bool live;       // a row of the topology (not the padding)
  };

  __device__ Row row(int team, const float* a) const {
    Row w{0, 0, 0, 0, false};
    if (team >= teams) return w;
    const int r = team / (m + 1), i = team - r * (m + 1);
    const int start = i < m ? row_offsets[i] : nnz;
    const int end = i < m ? row_offsets[i + 1] : nnz_pad;
    const long long e0 = (long long)r * nnz_pad + start;
    w.mis = (int)(((uintptr_t)(a + e0) >> 2) & 3);
    w.base = e0 - w.mis;
    w.len = end - start;
    w.nch = w.len > 0 ? (w.mis + w.len + 3) >> 2 : 0;
    w.live = i < m;
    return w;
  }
  __device__ __forceinline__ int off(const Row&, int c) const { return 4 * c; }
  // a chunk with live slots (none on the padding row)
  __device__ __forceinline__ bool present(const Row& w, int) const {
    return w.live;
  }
  __device__ __forceinline__ bool inside(const Row& w, int c, int k) const {
    const int e = 4 * c + k - w.mis;
    return e >= 0 && e < w.len;
  }
  // the scores of a present chunk, -inf outside the row
  __device__ __forceinline__ Chunk<4> scores(const Row& w, int c, int o,
                                             const float* a) const {
    Chunk<4> x = load<4>(a + w.base + o);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      x.v[k] = inside(w, c, k) ? x.v[k] : -INFINITY;
    return x;
  }
  // a chunk of an operand of the backward, 0 outside the row
  __device__ __forceinline__ Chunk<4> operand(const Row& w, int c, int o,
                                              const float* a) const {
    Chunk<4> x = load<4>(a + w.base + o);
#pragma unroll
    for (int k = 0; k < 4; ++k) x.v[k] = inside(w, c, k) ? x.v[k] : 0.f;
    return x;
  }
  __device__ __forceinline__ void put(const Row& w, int c, int o, float* out,
                                      const Chunk<4>& x) const {
    float* dst = out + w.base + o;
    if (4 * c - w.mis >= 0 && 4 * c - w.mis + 4 <= w.len) {
      store<4>(dst, x);
      return;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (inside(w, c, k)) dst[k] = x.v[k];
  }
};

// Panel rows: chunk c is element (c % per) * VEC of run c / per, per = bk /
// VEC; run t of row i of row block b of replica r starts at ((r * mb + b)
// * max_bpr + t) * bm * bk + i * bk, and the mask's at the same offset from
// its own row (mask r / heads).
template <int VEC_>
struct PanelRows {
  static constexpr int VEC = VEC_;
  const float* mask;  // null in the backward: every slot counts
  const int* nblocks;
  int mb, max_bpr, bm, bk, heads;
  int pshift;  // log2(bk / VEC) where that is a power of two, else -1
  int teams;   // R * mb * bm

  struct Row {
    long long base, mbase;  // element offsets of run 0 in the panel, mask
    int nch, live;          // live: chunks in present tiles
  };

  __device__ Row row(int team, const float*) const {
    const int per = bk / VEC;
    Row w{0, 0, 0, 0};
    if (team >= teams) return w;
    const int rb = team / bm;  // r * mb + b
    const int i = team - rb * bm;
    const int r = rb / mb, b = rb - r * mb;
    const int mrb = (r / heads) * mb + b;
    const long long tile = (long long)bm * bk;
    w.base = (long long)rb * max_bpr * tile + (long long)i * bk;
    w.mbase = (long long)mrb * max_bpr * tile + (long long)i * bk;
    w.nch = max_bpr * per;
    w.live = (mask != nullptr ? nblocks[mrb] : max_bpr) * per;
    return w;
  }
  __device__ __forceinline__ int off(const Row&, int c) const {
    const int per = bk / VEC;
    const int t = pshift >= 0 ? c >> pshift : c / per;
    return t * bm * bk + (c - t * per) * VEC;
  }
  // a chunk of a present tile (absent tiles are not read)
  __device__ __forceinline__ bool present(const Row& w, int c) const {
    return c < w.live;
  }
  __device__ __forceinline__ Chunk<VEC> scores(const Row& w, int, int o,
                                               const float* a) const {
    Chunk<VEC> x = load<VEC>(a + w.base + o);
    const Chunk<VEC> mk = load<VEC>(mask + w.mbase + o);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      x.v[k] = mk.v[k] != 0.f ? x.v[k] : -INFINITY;
    return x;
  }
  __device__ __forceinline__ Chunk<VEC> operand(const Row& w, int, int o,
                                                const float* a) const {
    return load<VEC>(a + w.base + o);
  }
  __device__ __forceinline__ void put(const Row& w, int, int o, float* out,
                                      const Chunk<VEC>& x) const {
    store<VEC>(out + w.base + o, x);
  }
};

template <int VEC>
__device__ __forceinline__ void fill(Chunk<VEC>& x, float v) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) x.v[k] = v;
}

// FORWARD: a = scores, out = p. BACKWARD: a = p, b = g, out = dx. A chunk
// that is not present (an absent tile, the CSR padding row) is not read
// and is written 0 * (1 / sum): 0, or NaN in a row whose sum is NaN, as
// the plain version's e / denom gives it.
template <class Pol, bool BWD, int L, int NV>
__global__ void __launch_bounds__(THREADS)
softmax_rows_kernel(Pol pol, const float* __restrict__ a,
                    const float* __restrict__ b, float* __restrict__ out) {
  constexpr int VEC = Pol::VEC;
  using C = Chunk<VEC>;
  const int lt = threadIdx.x % L;
  const unsigned tmask =
      L == 32 ? 0xffffffffu
              : ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
  const int team = blockIdx.x * (THREADS / L) + threadIdx.x / L;
  const typename Pol::Row w = pol.row(team, a);
  const int nch = w.nch;

  if (nch <= L * NV) {  // the row in registers: one read, one write
    int o[NV];
#pragma unroll
    for (int s = 0; s < NV; ++s)
      o[s] = lt + s * L < nch ? pol.off(w, lt + s * L) : 0;
    if constexpr (!BWD) {
      C x[NV];
      float mx = NEG_LARGE;
#pragma unroll
      for (int s = 0; s < NV; ++s) {
        const int c = lt + s * L;
        if (c < nch && pol.present(w, c)) {
          x[s] = pol.scores(w, c, o[s], a);
#pragma unroll
          for (int k = 0; k < VEC; ++k) mx = fmaxf(mx, x[s].v[k]);
        }
      }
      mx = team_max<L>(mx, tmask);
      float sum = 0.f;
#pragma unroll
      for (int s = 0; s < NV; ++s) {
        const int c = lt + s * L;
        if (c < nch && pol.present(w, c)) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            x[s].v[k] = expf(x[s].v[k] - mx);
            sum += x[s].v[k];
          }
        }
      }
      const float inv = 1.f / clamp_denom(team_sum<L>(sum, tmask));
      const float zero = 0.f * inv;
#pragma unroll
      for (int s = 0; s < NV; ++s) {
        const int c = lt + s * L;
        if (c < nch) {
          if (pol.present(w, c)) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) x[s].v[k] *= inv;
          } else {
            fill(x[s], zero);
          }
          pol.put(w, c, o[s], out, x[s]);
        }
      }
    } else {
      C p[NV], g[NV];
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < NV; ++s) {
        const int c = lt + s * L;
        if (c < nch) {
          p[s] = pol.operand(w, c, o[s], a);
          g[s] = pol.operand(w, c, o[s], b);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc += p[s].v[k] * g[s].v[k];
        }
      }
      const float rs = team_sum<L>(acc, tmask);
#pragma unroll
      for (int s = 0; s < NV; ++s) {
        const int c = lt + s * L;
        if (c < nch) {
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            p[s].v[k] = p[s].v[k] * (g[s].v[k] - rs);
          pol.put(w, c, o[s], out, p[s]);
        }
      }
    }
    return;
  }

  // a long row: one pass folding the statistics, one pass writing
  if constexpr (!BWD) {
    float m = NEG_LARGE, l = 0.f;
    for (int c = lt; c < nch && pol.present(w, c); c += L) {
      const C x = pol.scores(w, c, pol.off(w, c), a);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float v = x.v[k];
        if (v > m) {
          l = l * expf(m - v) + 1.f;
          m = v;
        } else {
          l += expf(v - m);
        }
      }
    }
    const float mx = team_max<L>(m, tmask);
    const float inv =
        1.f / clamp_denom(team_sum<L>(l * expf(m - mx), tmask));
    const float zero = 0.f * inv;
    for (int c = lt; c < nch; c += L) {
      const int o = pol.off(w, c);
      C x;
      if (pol.present(w, c)) {
        x = pol.scores(w, c, o, a);
#pragma unroll
        for (int k = 0; k < VEC; ++k) x.v[k] = expf(x.v[k] - mx) * inv;
      } else {
        fill(x, zero);
      }
      pol.put(w, c, o, out, x);
    }
  } else {
    float acc = 0.f;
    for (int c = lt; c < nch; c += L) {
      const int o = pol.off(w, c);
      const C p = pol.operand(w, c, o, a), g = pol.operand(w, c, o, b);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc += p.v[k] * g.v[k];
    }
    const float rs = team_sum<L>(acc, tmask);
    for (int c = lt; c < nch; c += L) {
      const int o = pol.off(w, c);
      C p = pol.operand(w, c, o, a);
      const C g = pol.operand(w, c, o, b);
#pragma unroll
      for (int k = 0; k < VEC; ++k) p.v[k] = p.v[k] * (g.v[k] - rs);
      pol.put(w, c, o, out, p);
    }
  }
}

// The team size for rows of about `slots` slots: 8 lanes up to 64, 16 up
// to 256, else 32. The chunks a lane holds in registers, `nv`: 4 where the
// row fits (fewer registers, more rows in flight), else 8.
inline int lanes_for(long long slots) {
  return slots <= 64 ? 8 : slots <= 256 ? 16 : 32;
}

template <class Pol, bool BWD>
int launch(const Pol& pol, const float* a, const float* b, float* out,
           int lanes, int nv, cudaStream_t stream) {
  if (pol.teams <= 0) return 0;
  const unsigned g = (unsigned)((pol.teams + THREADS / lanes - 1) /
                                (THREADS / lanes));
  auto go = [&](auto kernel) { kernel<<<g, THREADS, 0, stream>>>(pol, a, b,
                                                                   out); };
  switch (lanes * 16 + nv) {
    case 8 * 16 + 4: go(softmax_rows_kernel<Pol, BWD, 8, 4>); break;
    case 8 * 16 + 8: go(softmax_rows_kernel<Pol, BWD, 8, 8>); break;
    case 16 * 16 + 4: go(softmax_rows_kernel<Pol, BWD, 16, 4>); break;
    case 16 * 16 + 8: go(softmax_rows_kernel<Pol, BWD, 16, 8>); break;
    case 32 * 16 + 4: go(softmax_rows_kernel<Pol, BWD, 32, 4>); break;
    case 32 * 16 + 8: go(softmax_rows_kernel<Pol, BWD, 32, 8>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <class Pol>
int launch(const Pol& pol, const float* a, const float* b, float* out,
           int bwd, int lanes, int nv, cudaStream_t stream) {
  return bwd ? launch<Pol, true>(pol, a, b, out, lanes, nv, stream)
             : launch<Pol, false>(pol, a, b, out, lanes, nv, stream);
}

}  // namespace stt_softmax

// CsrRows. row_offsets i32[m + 1] (row_offsets[m] == nnz <= nnz_pad);
// forward: a = scores, out = p; backward (bwd = 1): a = p, b = g, out = dx;
// each f32 [R, nnz_pad], contiguous, 16-byte aligned. lanes (8, 16 or 32)
// and nv (4 or 8 chunks a lane in registers): 0 for the rule, lanes on the
// mean row length, nv 4 where rows up to 1/8 over the mean fit in 4 a
// lane, else 8 (a longer row takes the two-pass path).
extern "C" int softmax_csr_f32(const void* row_offsets, const void* a,
                               const void* b, void* out, int R, int m,
                               int nnz, int nnz_pad, int bwd, int lanes,
                               int nv, void* stream) {
  using namespace stt_softmax;
  const long long teams = (long long)R * (m + 1);
  if (teams > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  CsrRows pol{(const int*)row_offsets, m, nnz, nnz_pad, (int)teams};
  const long long mean = m > 0 ? nnz / m : 0;
  if (lanes == 0) lanes = lanes_for(mean);
  if (nv == 0) nv = (mean + mean / 8 + 3) / 4 + 1 <= 4 * lanes ? 4 : 8;
  return launch(pol, (const float*)a, (const float*)b, (float*)out, bwd,
                lanes, nv, (cudaStream_t)stream);
}

// PanelRows. mask f32[n_masks, mb, max_bpr, bm, bk] and nblocks
// i32[n_masks, mb], replica r reading mask r / heads; a, b, out f32[R, mb,
// max_bpr, bm, bk] as above (the mask and nblocks are read forward only).
// vec: 4 where bk % 4 == 0 and every operand is 16-byte aligned, else 1.
// lanes and nv: as above, 0 for the rule, lanes on the row's max_bpr * bk
// slots, nv 4 where the row fits in 4 chunks a lane, else 8.
extern "C" int softmax_panel_f32(const void* mask, const void* nblocks,
                                 const void* a, const void* b, void* out,
                                 int R, int heads, int mb, int max_bpr,
                                 int bm, int bk, int vec, int bwd, int lanes,
                                 int nv, void* stream) {
  using namespace stt_softmax;
  if (heads <= 0) return (int)cudaErrorInvalidValue;
  const long long teams = (long long)R * mb * bm;
  if (teams > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const int per = bk / vec;
  const int pshift = (per & (per - 1)) == 0 ? __builtin_ctz(per) : -1;
  const long long nch = (long long)max_bpr * per;
  if (lanes == 0) lanes = lanes_for((long long)max_bpr * bk);
  if (nv == 0) nv = nch <= 4 * lanes ? 4 : 8;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4) {
    PanelRows<4> pol{(const float*)mask, (const int*)nblocks, mb, max_bpr,
                     bm, bk, heads, pshift, (int)teams};
    return launch(pol, (const float*)a, (const float*)b, (float*)out, bwd,
                  lanes, nv, s);
  }
  PanelRows<1> pol{(const float*)mask, (const int*)nblocks, mb, max_bpr, bm,
                   bk, heads, pshift, (int)teams};
  return launch(pol, (const float*)a, (const float*)b, (float*)out, bwd,
                lanes, nv, s);
}
