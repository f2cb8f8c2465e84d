// Pass D of the four-pass denoise: the class-dispatched vertex update.
// Each point takes the step of its class (the strategy maps classes 0/1/2
// to flat, edge, corner, feature, new or dummy) from its window sums over
// the pairs d <= rk_step: the bilateral flat step along n_i, the edge,
// corner and three-term (feature/new) guarded 3x3 solves, each clamped
// to d_thr; it writes the new positions (3, n).
//
// Replaces: ngpd_tpu/core/pallas_fused.py:402, _make_pass_d (the
// pallas_call at l.1019 in pallas_denoise). The flat and new steps read
// their class's delta from scal[1 + delta_slot[class], 0] (l.485, 533),
// not from fixed rows. The reference computes every step and then
// selects by class (l.547-553); this kernel computes only the selected
// step, the same function. The flat clamp keeps a step of exactly d_thr
// (<=, l.497), the others need it shorter (<, l.451); the edge step's
// direction is the cls pack's rows 1-3 (l.501-503).
//
// What bounds it on the H100: operations. Every (query, column) pair
// needs its distance and threshold test; the ~step_k pairs that pass add
// 13 common sums and the step's own (the flat and new steps two and one
// exp each), and each point one guarded 3x3 solve. It reads the 40-row
// packs and 4 cls rows and writes 3 rows a point.
//
// Design: as pass A, one block per query tile with the window's GR rows
// 0-17 in shared memory and one thread per query; the accumulators of the
// widest step (new: 25) stay in registers. Threads of one warp whose
// points take different steps diverge only in the step's own sums.
#include "passes_common.cuh"

namespace ngpd {

constexpr int D_ROWS = R_P + 3;
enum Step { FLAT = 0, EDGE, CORNER, FEATURE, NEW, DUMMY };  // ops/steps.py STEP_NAMES

struct StepArgs {
  int kind[3];      // Step of classes 0, 1, 2
  float alpha[3];   // DenoiseConfig.alphas
  int slot[3];      // delta slot of each class, -1 if none
};

// p + alpha (opt - p) where the step is shorter than d_thr, else p.
__device__ __forceinline__ void clamp_step(const float opt[3], const float p[3],
                                           float alpha, float d_thr,
                                           float out[3]) {
  const float di[3] = {fmul(fsub(opt[0], p[0]), alpha),
                       fmul(fsub(opt[1], p[1]), alpha),
                       fmul(fsub(opt[2], p[2]), alpha)};
  const bool ok = __fsqrt_rn(fmaxf(dot(di, di), 0.0f)) < d_thr;
  for (int c = 0; c < 3; ++c) out[c] = ok ? fadd(p[c], di[c]) : p[c];
}

// The symmetric matrix of six sums (00 01 02 11 12 22).
__device__ __forceinline__ void srow(const float s6[6], float m[3][3]) {
  m[0][0] = s6[0]; m[0][1] = s6[1]; m[0][2] = s6[2];
  m[1][0] = s6[1]; m[1][1] = s6[3]; m[1][2] = s6[4];
  m[2][0] = s6[2]; m[2][1] = s6[4]; m[2][2] = s6[5];
}

// The feature/new system (Denoiser.py:144-162); deg stays raw.
__device__ __forceinline__ void three_term(const float n[3], const float p[3],
                                           float deg, const float s6[6],
                                           const float bnv[3], const float sv[3],
                                           float opt[3]) {
  float sr[3][3], m[3][3], nio[3][3];
  srow(s6, sr);
  const float deg1 = fadd(1.0f, deg);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      nio[a][b] = fmul(n[a < b ? a : b], n[a < b ? b : a]);
      m[a][b] = fadd(fadd(a == b ? 1.0f : 0.0f, fmul(nio[a][b], deg1)), sr[a][b]);
    }
  float rhs[3];
  for (int c = 0; c < 3; ++c)
    rhs[c] = fadd(fadd(fadd(p[c], dot(nio[c], p)), dot(nio[c], sv)), bnv[c]);
  solve3(m, rhs, p, opt);
}

// The edge system projected off the edge direction y.
__device__ __forceinline__ void edge_solve(const float y[3], const float s6[6],
                                           const float bnv[3],
                                           const float qyy[3], float deg,
                                           const float p[3], float opt[3]) {
  float sr[3][3], m[3][3];
  srow(s6, sr);
  const float sy[3] = {dot(sr[0], y), dot(sr[1], y), dot(sr[2], y)};
  const float ysy = dot(sy, y);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      m[a][b] = fadd(fadd(fsub(fsub(sr[a][b], fmul(y[a], sy[b])), fmul(sy[a], y[b])),
                          fmul(fmul(ysy, y[a]), y[b])),
                     fmul(fmul(deg, y[a]), y[b]));
  const float z[3] = {fsub(bnv[0], qyy[0]), fsub(bnv[1], qyy[1]), fsub(bnv[2], qyy[2])};
  const float yz = dot(y, z), yp = dot(y, p);
  float rhs[3];
  for (int c = 0; c < 3; ++c)
    rhs[c] = fadd(fsub(z[c], fmul(yz, y[c])), fmul(fmul(deg, yp), y[c]));
  solve3(m, rhs, p, opt);
}

__global__ void pass_d_kernel(const float* __restrict__ gq,
                              const float* __restrict__ gr,
                              const float* __restrict__ cls,
                              const float* __restrict__ scal,
                              const int* __restrict__ starts,
                              float* __restrict__ out, int n, int nv, int tile,
                              int wt, StepArgs args) {
  extern __shared__ float sm[];  // D_ROWS rows of wt
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_rows(gr, n, s, wt, D_ROWS, sm);
  __syncthreads();
  const float d_thr = scal[0];

  const int jmax = min(wt, nv - s);  // columns past nv are masked
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int i = blk * tile + r;
    const float p[3] = {gq[i], gq[n + i], gq[2 * n + i]};
    const float qq = gq[Q_PP * n + i], rk8 = gq[Q_RKS * n + i];
    const float nrm[3] = {gq[Q_N * n + i], gq[(Q_N + 1) * n + i], gq[(Q_N + 2) * n + i]};
    const float c_i = cls[i];
    const int cid = c_i == 0.0f ? 0 : (c_i == 1.0f ? 1 : 2);
    const int kind = args.kind[cid];
    if (kind == DUMMY) {
      for (int c = 0; c < 3; ++c) out[c * n + i] = p[c];
      continue;
    }
    const float y[3] = {cls[n + i], cls[2 * n + i], cls[3 * n + i]};
    float d2 = 1.0f;
    if (kind == FLAT || kind == NEW) {
      const float delta = scal[(1 + args.slot[cid]) * 128];
      d2 = fmaxf(fmul(delta, delta), 1e-30f);
    }

    float deg = 0.0f, s6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float bnv[3] = {0.f, 0.f, 0.f}, sv[3] = {0.f, 0.f, 0.f};
    float ext[12] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < jmax; ++j) {
      const float d = pack_dist(p[0], p[1], p[2], qq, sm, wt, j);
      if (!(d <= rk8 && d < MASKED)) continue;
      const float nj[3] = {sm[R_N * wt + j], sm[(R_N + 1) * wt + j], sm[(R_N + 2) * wt + j]};
      const float pj[3] = {sm[R_P * wt + j], sm[(R_P + 1) * wt + j], sm[(R_P + 2) * wt + j]};
      const float pn = sm[R_PN * wt + j];
      const float nnv[3] = {fmul(nj[0], pn), fmul(nj[1], pn), fmul(nj[2], pn)};
      float sym[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) sym[c] = sm[(R_SYM + c) * wt + j];
      deg = fadd(deg, 1.0f);
#pragma unroll
      for (int c = 0; c < 6; ++c) s6[c] = fadd(s6[c], sym[c]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        bnv[c] = fadd(bnv[c], nnv[c]);
        sv[c] = fadd(sv[c], pj[c]);
      }
      const float dotj = fsub(pn, dot(p, nj));  // n_j.(p_j - p_i)
      if (kind == FLAT) {
        const float ninj = dot(nrm, nj);
        const float sim = expf(fdiv(fmul(-16.0f, fsub(2.0f, fmul(2.0f, ninj))), d2));
        const float close = expf(fdiv(fmul(-4.0f, d), d2));
        const float wb = fmul(sim, close);
        ext[0] = fadd(ext[0], fmul(wb, dotj));
        ext[1] = fadd(ext[1], wb);
      } else if (kind == EDGE) {
        const float w = fmul(dot(y, nj), dot(y, pj));
#pragma unroll
        for (int c = 0; c < 3; ++c) ext[c] = fadd(ext[c], fmul(w, nj[c]));
      } else if (kind == NEW) {
        const float like = expf(fdiv(fmul(fmul(-9.0f, dotj), dotj), d2));
#pragma unroll
        for (int c = 0; c < 6; ++c) ext[c] = fadd(ext[c], fmul(like, sym[c]));
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          ext[6 + c] = fadd(ext[6 + c], fmul(like, nnv[c]));
          ext[9 + c] = fadd(ext[9 + c], fmul(like, pj[c]));
        }
      }
    }

    const float alpha = args.alpha[cid];
    float opt[3], res[3];
    if (kind == FLAT) {
      const float scalef = fmul(fdiv(ext[0], fmaxf(ext[1], 1e-30f)), alpha);
      const float di[3] = {fmul(scalef, nrm[0]), fmul(scalef, nrm[1]), fmul(scalef, nrm[2])};
      const bool ok = __fsqrt_rn(fmaxf(dot(di, di), 0.0f)) <= d_thr;
      for (int c = 0; c < 3; ++c) res[c] = ok ? fadd(p[c], di[c]) : p[c];
    } else {
      if (kind == EDGE) {
        edge_solve(y, s6, bnv, ext, deg, p, opt);
      } else if (kind == CORNER) {
        float m[3][3];
        srow(s6, m);
        solve3(m, bnv, p, opt);
      } else if (kind == FEATURE) {
        three_term(nrm, p, deg, s6, bnv, sv, opt);
      } else {  // NEW
        three_term(nrm, p, deg, ext, ext + 6, ext + 9, opt);
      }
      clamp_step(opt, p, alpha, d_thr, res);
    }
    for (int c = 0; c < 3; ++c) out[c * n + i] = res[c];
  }
}

}  // namespace ngpd

// gq, gr: (16, n), (24, n) post-pass-A packs; cls: (4, n) from pass B;
// scal: (8, 128) with d_thr and the deltas; starts: (n / tile,) int32;
// out: (3, n). kind0-2: the step of classes 0-2 as indices of STEP_NAMES
// (flat, edge, corner, feature, new, dummy); alpha0-2: the step sizes;
// slot0-2: each class's row of deltas in scal, -1 if it has none.
extern "C" int ngpd_pass_d_launch(const void* gq, const void* gr,
                                  const void* cls, const void* scal,
                                  const void* starts, void* out, int n, int nv,
                                  int tile, int wt, int kind0, int kind1,
                                  int kind2, float alpha0, float alpha1,
                                  float alpha2, int slot0, int slot1,
                                  int slot2, void* stream) {
  using namespace ngpd;
  const StepArgs args = {{kind0, kind1, kind2}, {alpha0, alpha1, alpha2},
                         {slot0, slot1, slot2}};
  const size_t smem = prepare_launch(pass_d_kernel, D_ROWS, wt);
  pass_d_kernel<<<n / tile, pass_threads(tile), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gq), static_cast<const float*>(gr),
      static_cast<const float*>(cls), static_cast<const float*>(scal),
      static_cast<const int*>(starts), static_cast<float*>(out), n, nv, tile,
      wt, args);
  return (int)cudaGetLastError();
}
