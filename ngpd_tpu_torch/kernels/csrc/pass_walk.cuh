// The window walk of the pass kernels (CUDA C++ for sm_90a): their
// accumulations over walk_common.cuh's bit words, the staging of the
// window rows at a pitch of whole words, and the shared-memory budget.
//
// A block stages GR rows 0-17 of its window (pass A 0-14, pass C 0-3) at
// pitch wp = wt rounded up to 32 (zeros behind), then one thread a query:
//   nvt_pass   scans the window chunk by chunk into a feature and a step
//              bit word per 32 columns and walks the feature bits into the
//              NVT sums (NVT1 of pass A, NVT2 of passes B and BD; their
//              NvtSums and nvt_mean are walk_common.cuh's); with
//              KEEP the step words of the whole window are kept in shared
//              memory, one a (word, thread); without it only the feature
//              threshold is scanned;
//   walk_step_bits  visits the step bits, kept or scanned again chunk by
//              chunk against rk_step alone, with any body: pass B's
//              partials, pass C's max, or step_column's sums of one step
//              kind (step_pass, passes D and BD).
// Every sum is taken over a query's passing columns in ascending column
// order, as a walk over all columns with an early `continue` takes it, so
// the results equal that walk's bit for bit. The masks must match the
// plain versions bit for bit, so the distances run on the float32 pipes
// and there is no wgmma here (walk_common.cuh).
#pragma once

#include "passes_common.cuh"
#include "walk_common.cuh"

namespace ngpd {

// One passing column of the NVT2 accumulation.
__device__ __forceinline__ void nvt_column(const float* sm, int wp, int j,
                                           const float q[3], float qq,
                                           float cos_rho, NvtSums& a) {
  const float d = col_dist(sm, wp, j, q[0], q[1], q[2], qq);
  const float nj[3] = {sm[R_N * wp + j], sm[(R_N + 1) * wp + j], sm[(R_N + 2) * wp + j]};
  const float dotj = fsub(sm[R_PN * wp + j], dot(q, nj));
  const bool keep = keeps_angle(dotj, d, cos_rho);
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float s = sm[(R_SYM + c) * wp + j];
    a.all[c] = fadd(a.all[c], s);
    if (keep) a.kept[c] = fadd(a.kept[c], s);
  }
  a.n_all = fadd(a.n_all, 1.0f);
  if (keep) a.n_kept = fadd(a.n_kept, 1.0f);
}

// The first walk of one query: the scan of every chunk, its feature bits
// walked into the NVT2 sums at once and, with KEEP, its step bits kept in
// sbits (word w at sbits[w * blockDim.x]). cbits is the chunk's buffer of
// feature words. Without KEEP only the feature threshold is tested.
template <bool KEEP>
__device__ __forceinline__ NvtSums nvt_pass(const float* sm, int wp, int nwords,
                                            int jmax, unsigned* sbits,
                                            unsigned* cbits, const float q[3],
                                            float qq, float thr_f, float thr_s,
                                            float cos_rho) {
  NvtSums nvt{};  // every sum 0
  for (int w0 = 0; w0 < nwords; w0 += CHUNK_WORDS) {
    const int cw = min(CHUNK_WORDS, nwords - w0);
    unsigned nz = 0u;
    for (int wl = 0; wl < cw; ++wl) {
      const int w = w0 + wl;
      const unsigned valid = word_valid(jmax - (w << 5));
      unsigned bf;
      if constexpr (KEEP) {
        unsigned bs;
        scan_word(sm, wp, w << 5, q[0], q[1], q[2], qq, thr_f, thr_s, bf, bs);
        sbits[w * blockDim.x] = bs & valid;
      } else {
        bf = scan_word(sm, wp, w << 5, q[0], q[1], q[2], qq, thr_f);
      }
      bf &= valid;
      if (bf) {
        cbits[wl * blockDim.x] = bf;
        nz |= 1u << wl;
      }
    }
    walk_chunk(cbits, blockDim.x, nz, w0 << 5,
               [&](int j) { nvt_column(sm, wp, j, q, qq, cos_rho, nvt); });
  }
  return nvt;
}

// Visit one query's step bits chunk by chunk, body(j) on each from the
// lowest up: with KEEP the words nvt_pass kept in sbits, else each chunk
// scanned again against thr_s into cbits.
template <bool KEEP, typename Body>
__device__ __forceinline__ void walk_step_bits(const float* sm, int wp, int nwords,
                                               int jmax, const unsigned* sbits,
                                               unsigned* cbits, const float p[3],
                                               float qq, float thr_s, Body body) {
  for (int w0 = 0; w0 < nwords; w0 += CHUNK_WORDS) {
    const int cw = min(CHUNK_WORDS, nwords - w0);
    const unsigned* words = KEEP ? sbits + w0 * blockDim.x : cbits;
    unsigned nz = 0u;
    for (int wl = 0; wl < cw; ++wl) {
      unsigned bs;
      if constexpr (KEEP) {
        bs = words[wl * blockDim.x];
      } else {
        const int j0 = (w0 + wl) << 5;
        bs = scan_word(sm, wp, j0, p[0], p[1], p[2], qq, thr_s) & word_valid(jmax - j0);
        cbits[wl * blockDim.x] = bs;
      }
      if (bs) nz |= 1u << wl;
    }
    walk_chunk(words, blockDim.x, nz, w0 << 5, body);
  }
}

// One passing column of the step accumulation over d <= rk_step: the sums
// every step shares (deg, s6, b_nv, sv) and those of step `kind` (CORNER
// stands for every step that has none: corner, feature, dummy), with y the
// edge direction and d2 = max(delta^2, 1e-30) of the flat and new steps;
// with `centre`, mx also takes |p_j - cen|^2 = |p_j|^2 + (-2 p_j).cen + cc.
template <int kind>
__device__ __forceinline__ void step_column(const float* sm, int wp, int j,
                                            const float p[3], float qq,
                                            const float nrm[3], const float y[3],
                                            float d2, bool centre,
                                            const float cen[3], float cc,
                                            StepSums& s, float& mx) {
  const float nj[3] = {sm[R_N * wp + j], sm[(R_N + 1) * wp + j], sm[(R_N + 2) * wp + j]};
  const float pj[3] = {sm[R_P * wp + j], sm[(R_P + 1) * wp + j], sm[(R_P + 2) * wp + j]};
  const float pn = sm[R_PN * wp + j];
  const float nnv[3] = {fmul(nj[0], pn), fmul(nj[1], pn), fmul(nj[2], pn)};
  float sym[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) sym[c] = sm[(R_SYM + c) * wp + j];
  s.deg = fadd(s.deg, 1.0f);
#pragma unroll
  for (int c = 0; c < 6; ++c) s.s6[c] = fadd(s.s6[c], sym[c]);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.bnv[c] = fadd(s.bnv[c], nnv[c]);
    s.sv[c] = fadd(s.sv[c], pj[c]);
  }
  if (centre) {
    const float m2pj[3] = {sm[j], sm[wp + j], sm[2 * wp + j]};
    mx = fmaxf(mx, fadd(fadd(sm[R_PP * wp + j], dot(m2pj, cen)), cc));
  }
  const float dotj = fsub(pn, dot(p, nj));  // n_j.(p_j - p_i)
  if constexpr (kind == FLAT) {
    const float d = col_dist(sm, wp, j, p[0], p[1], p[2], qq);
    const float ninj = dot(nrm, nj);
    const float sim = expf(fdiv(fmul(-16.0f, fsub(2.0f, fmul(2.0f, ninj))), d2));
    const float close = expf(fdiv(fmul(-4.0f, d), d2));
    const float wb = fmul(sim, close);
    s.ext[0] = fadd(s.ext[0], fmul(wb, dotj));
    s.ext[1] = fadd(s.ext[1], wb);
  } else if constexpr (kind == EDGE) {
    const float w = fmul(dot(y, nj), dot(y, pj));
#pragma unroll
    for (int c = 0; c < 3; ++c) s.ext[c] = fadd(s.ext[c], fmul(w, nj[c]));
  } else if constexpr (kind == NEW) {
    const float like = expf(fdiv(fmul(fmul(-9.0f, dotj), dotj), d2));
#pragma unroll
    for (int c = 0; c < 6; ++c) s.ext[c] = fadd(s.ext[c], fmul(like, sym[c]));
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s.ext[6 + c] = fadd(s.ext[6 + c], fmul(like, nnv[c]));
      s.ext[9 + c] = fadd(s.ext[9 + c], fmul(like, pj[c]));
    }
  }
}

// The step accumulation of one query of step `kind` over its step bits.
template <int kind, bool KEEP>
__device__ __forceinline__ void step_pass(const float* sm, int wp, int nwords,
                                          int jmax, const unsigned* sbits,
                                          unsigned* cbits, const float p[3],
                                          float qq, float thr_s,
                                          const float nrm[3], const float y[3],
                                          float d2, bool centre,
                                          const float cen[3], float cc,
                                          StepSums& s, float& mx) {
  walk_step_bits<KEEP>(sm, wp, nwords, jmax, sbits, cbits, p, qq, thr_s, [&](int j) {
    step_column<kind>(sm, wp, j, p, qq, nrm, y, d2, centre, cen, cc, s, mx);
  });
}

// One loop a step kind, no branch on the kind inside it: step_pass of the
// kind named at run time (FEATURE and DUMMY walk as CORNER).
template <bool KEEP>
__device__ __forceinline__ void step_pass_of(int kind, const float* sm, int wp,
                                             int nwords, int jmax,
                                             const unsigned* sbits, unsigned* cbits,
                                             const float p[3], float qq, float thr_s,
                                             const float nrm[3], const float y[3],
                                             float d2, bool centre,
                                             const float cen[3], float cc,
                                             StepSums& s, float& mx) {
#define STEP_PASS(KIND)                                                        \
  step_pass<KIND, KEEP>(sm, wp, nwords, jmax, sbits, cbits, p, qq, thr_s, nrm, \
                        y, d2, centre, cen, cc, s, mx)
  if (kind == FLAT) STEP_PASS(FLAT);
  else if (kind == EDGE) STEP_PASS(EDGE);
  else if (kind == NEW) STEP_PASS(NEW);
  else STEP_PASS(CORNER);
#undef STEP_PASS
}

// Stage GR rows [0, ROWS) of the window columns [s, s + wt) at pitch wp,
// zeros in columns [wt, wp). A thread has up to six rows' loads in flight
// at a time (the last batch takes the rows left), 16 bytes each where the
// rows are 16-byte aligned in device memory.
template <int ROWS>
__device__ __forceinline__ void stage_rows_pitched(const float* __restrict__ gr,
                                                   int n, int s, int wt, int wp,
                                                   float* sm) {
  constexpr int BATCH = 6;
  const bool aligned =
      ((n | s | wt) & 3) == 0 && (reinterpret_cast<size_t>(gr) & 15) == 0;
  if (aligned) {
    for (int k = threadIdx.x; k < (wt >> 2); k += blockDim.x) {
#pragma unroll
      for (int r0 = 0; r0 < ROWS; r0 += BATCH) {
        float4 v[BATCH];
#pragma unroll
        for (int r = 0; r < BATCH; ++r)
          if (r0 + r < ROWS)
            v[r] = *reinterpret_cast<const float4*>(gr + (size_t)(r0 + r) * n + s + 4 * k);
#pragma unroll
        for (int r = 0; r < BATCH; ++r)
          if (r0 + r < ROWS) *reinterpret_cast<float4*>(sm + (r0 + r) * wp + 4 * k) = v[r];
      }
    }
  } else {
    for (int j = threadIdx.x; j < wt; j += blockDim.x) {
#pragma unroll
      for (int r0 = 0; r0 < ROWS; r0 += BATCH) {
        float v[BATCH];
#pragma unroll
        for (int r = 0; r < BATCH; ++r)
          if (r0 + r < ROWS) v[r] = gr[(size_t)(r0 + r) * n + s + j];
#pragma unroll
        for (int r = 0; r < BATCH; ++r)
          if (r0 + r < ROWS) sm[(r0 + r) * wp + j] = v[r];
      }
    }
  }
  for (int j = wt + threadIdx.x; j < wp; j += blockDim.x)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sm[r * wp + j] = 0.0f;
}

// ---- Launch ----------------------------------------------------------------

// Shared memory of one block: `rows` window rows, a chunk's bit words
// and, with `keep`, the window's step bit words, one a (word, thread).
__host__ inline size_t walk_smem(int tile, int wt, bool keep, int rows = D_ROWS) {
  const int wp = round_up32(wt), words = wp >> 5;
  return sizeof(float) * ((size_t)rows * wp +
                          (size_t)pass_threads(tile) * (CHUNK_WORDS + (keep ? words : 0)));
}

constexpr size_t SM_SMEM = 232448;  // bytes a block can use on sm_90

// Whether the step bits fit beside the window: above ~2,200 columns at 256
// threads they do not, and the step bits are scanned again.
__host__ inline bool walk_keeps(int tile, int wt) {
  return walk_smem(tile, wt, true) <= SM_SMEM;
}

}  // namespace ngpd
