// Shared pieces of the pass kernels A-D and BD (CUDA C++ for sm_90a).
//
// Geometry, identical to ngpd_tpu/core/pallas_fused.py:874-884: the padded
// cloud has n points in Morton order; query tile b (one CUDA block) holds
// the `tile` queries [b*tile, (b+1)*tile) and reads the window columns
// [starts[b], starts[b] + wt); columns at or past nv are masked.
//
// Packs, the reference's layout (pallas_fused.py:16-22):
//   GQ (16, n): 0-2 p | 3 one | 4 |p|^2 | 5-7 n | 8 rk_feat | 9 rk_step
//   GR (24, n): 0-2 -2p | 3 |p|^2 | 4 one | 5-7 n | 8 p.n | 9-14 sym6(n)
//               | 15-17 p
//   cls (4, n): 0 class (0./1./2.) | 1-3 edge direction
//
// Numerics: every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn; the sources are also built with -fmad=false) in the order of
// the reference's expressions, so that the threshold masks agree with the
// plain PyTorch versions (kernels/passes.py) bit for bit. The per-point
// math (eigh, VU smoothing, classes, the 3x3 solves) mirrors
// ngpd_tpu_torch/ops/eigh3.py, ops/solve3.py and core/hybrid_stages.py
// branch for branch; only cosf and expf differ from torch by ulps. The
// hybrid engine's stage kernels (hybrid_vu.cu, hybrid_update.cu) share it
// with the roots in PyTorch's CUDA arithmetic (eigen_roots).
#pragma once

#include "window_common.cuh"

namespace ngpd {

enum GqRow { Q_ONE = 3, Q_PP = 4, Q_N = 5, Q_RKF = 8, Q_RKS = 9, GQ_ROWS = 16 };
enum GrRow { R_PP = 3, R_N = 5, R_PN = 8, R_SYM = 9, R_P = 15, GR_ROWS = 24 };

constexpr float EPS = 1e-12f;

__device__ __forceinline__ float fadd(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fsub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fmul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fdiv(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float dot(const float a[3], const float b[3]) {
  return fadd(fadd(fmul(a[0], b[0]), fmul(a[1], b[1])), fmul(a[2], b[2]));
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float o[3]) {
  o[0] = fsub(fmul(a[1], b[2]), fmul(a[2], b[1]));
  o[1] = fsub(fmul(a[2], b[0]), fmul(a[0], b[2]));
  o[2] = fsub(fmul(a[0], b[1]), fmul(a[1], b[0]));
}

// ngpd_tpu/ops/fastmath.py::acos_poly, the same coefficients (float32
// values) in the same Horner order.
__device__ __forceinline__ float acos_poly(float x) {
  const float xc = fminf(fmaxf(x, -1.0f), 1.0f);
  const float ax = fabsf(xc);
  float p = -0.0012624911f;
  p = fadd(fmul(p, ax), 0.00667009f);
  p = fadd(fmul(p, ax), -0.017088126f);
  p = fadd(fmul(p, ax), 0.03089188f);
  p = fadd(fmul(p, ax), -0.050174303f);
  p = fadd(fmul(p, ax), 0.08897899f);
  p = fadd(fmul(p, ax), -0.2145988f);
  p = fadd(fmul(p, ax), 1.5707963f);
  const float r = fmul(p, __fsqrt_rn(fmaxf(fsub(1.0f, ax), 0.0f)));
  return xc < 0.0f ? fsub(3.1415927f, r) : r;
}

__device__ __forceinline__ void normalize(float v[3]) {
  const float inv = fdiv(1.0f, __fsqrt_rn(fmaxf(dot(v, v), EPS)));
  for (int c = 0; c < 3; ++c) v[c] = fmul(v[c], inv);
}

// Eigenvector of lam from the largest cross product of rows of B - lam I.
__device__ __forceinline__ void evec_from_cross(const float b[3][3], float lam,
                                                float v[3]) {
  const float r0[3] = {fsub(b[0][0], lam), b[0][1], b[0][2]};
  const float r1[3] = {b[1][0], fsub(b[1][1], lam), b[1][2]};
  const float r2[3] = {b[2][0], b[2][1], fsub(b[2][2], lam)};
  float c01[3], c02[3], c12[3];
  cross(r0, r1, c01);
  cross(r0, r2, c02);
  cross(r1, r2, c12);
  const float n01 = dot(c01, c01), n02 = dot(c02, c02), n12 = dot(c12, c12);
  const bool pick12 = n12 >= n02;
  const float nbest12 = fmaxf(n12, n02);
  const bool pick01 = n01 >= nbest12;
  for (int c = 0; c < 3; ++c) v[c] = pick01 ? c01[c] : (pick12 ? c12[c] : c02[c]);
  const float nv = fmaxf(n01, nbest12);
  normalize(v);
  if (!(nv > EPS)) {
    v[0] = 1.0f;
    v[1] = 0.0f;
    v[2] = 0.0f;
  }
}

// Eigenvector of lam in the plane orthogonal to w.
__device__ __forceinline__ void evec_deflated(const float b[3][3], float lam,
                                              const float w[3], float out[3]) {
  const bool swap = fabsf(w[0]) > fabsf(w[1]);
  const float inv_xz = fdiv(1.0f, __fsqrt_rn(fmaxf(fadd(fmul(w[0], w[0]), fmul(w[2], w[2])), EPS)));
  const float inv_yz = fdiv(1.0f, __fsqrt_rn(fmaxf(fadd(fmul(w[1], w[1]), fmul(w[2], w[2])), EPS)));
  float u[3], v[3];
  if (swap) {
    u[0] = fmul(-w[2], inv_xz);
    u[1] = 0.0f;
    u[2] = fmul(w[0], inv_xz);
  } else {
    u[0] = 0.0f;
    u[1] = fmul(w[2], inv_yz);
    u[2] = fmul(-w[1], inv_yz);
  }
  cross(w, u, v);
  const float bu[3] = {dot(b[0], u), dot(b[1], u), dot(b[2], u)};
  const float bv[3] = {dot(b[0], v), dot(b[1], v), dot(b[2], v)};
  const float m00 = fsub(dot(u, bu), lam);
  const float m01 = dot(u, bv);
  const float m11 = fsub(dot(v, bv), lam);
  const bool use0 = fabsf(m00) >= fabsf(m11);
  float c0 = use0 ? m01 : m11;
  float c1 = use0 ? -m00 : -m01;
  const float norm = __fsqrt_rn(fadd(fmul(c0, c0), fmul(c1, c1)));
  if (norm > EPS) {
    c0 = fdiv(c0, fmaxf(norm, EPS));
    c1 = fdiv(c1, fmaxf(norm, EPS));
  } else {
    c0 = 1.0f;
    c1 = 0.0f;
  }
  for (int c = 0; c < 3; ++c) out[c] = fadd(fmul(c0, u[c]), fmul(c1, v[c]));
}

// The scaled trigonometric roots of ops/eigh3.py::_roots: the matrix over
// its largest |entry| (b), that scale, p and the roots in ascending order.
// TORCH false: acos_poly and true division by the constants 3 and 6, the
// pass kernels' arithmetic. TORCH true: acosf, and each division by a
// constant as a product with its float32 reciprocal, which is what
// PyTorch's CUDA kernels compute for a tensor over a Python scalar
// (``x / 3.0``), so the hybrid engine's kernels give the eager stages'
// bits on the card. Division by 2 is exact either way.
struct Roots {
  float b[3][3];
  float scale, safe, p, lo, mid, hi;
};

template <bool TORCH>
__device__ __forceinline__ float div_const(float x, float c) {
  return TORCH ? fmul(x, 1.0f / c) : fdiv(x, c);
}

template <bool TORCH>
__device__ __forceinline__ Roots eigen_roots(const float a[6]) {
  Roots r;
  r.scale =
      fmaxf(fmaxf(fmaxf(fabsf(a[0]), fabsf(a[3])), fmaxf(fabsf(a[5]), fabsf(a[1]))),
            fmaxf(fabsf(a[2]), fabsf(a[4])));
  r.safe = fmaxf(r.scale, EPS);
  const float b00 = fdiv(a[0], r.safe), b01 = fdiv(a[1], r.safe), b02 = fdiv(a[2], r.safe);
  const float b11 = fdiv(a[3], r.safe), b12 = fdiv(a[4], r.safe), b22 = fdiv(a[5], r.safe);
  r.b[0][0] = b00; r.b[0][1] = b01; r.b[0][2] = b02;
  r.b[1][0] = b01; r.b[1][1] = b11; r.b[1][2] = b12;
  r.b[2][0] = b02; r.b[2][1] = b12; r.b[2][2] = b22;
  const float q = div_const<TORCH>(fadd(fadd(b00, b11), b22), 3.0f);
  const float d00 = fsub(b00, q), d11 = fsub(b11, q), d22 = fsub(b22, q);
  const float p1 = fadd(fadd(fmul(b01, b01), fmul(b02, b02)), fmul(b12, b12));
  const float p2 = fadd(fadd(fadd(fmul(d00, d00), fmul(d11, d11)), fmul(d22, d22)),
                        fmul(2.0f, p1));
  r.p = __fsqrt_rn(fmaxf(div_const<TORCH>(p2, 6.0f), 0.0f));
  const float sp = fmaxf(r.p, EPS);
  const float c00 = fdiv(d00, sp), c11 = fdiv(d11, sp), c22 = fdiv(d22, sp);
  const float c01 = fdiv(b01, sp), c02 = fdiv(b02, sp), c12 = fdiv(b12, sp);
  const float det_c =
      fadd(fsub(fmul(c00, fsub(fmul(c11, c22), fmul(c12, c12))),
                fmul(c01, fsub(fmul(c01, c22), fmul(c12, c02)))),
           fmul(c02, fsub(fmul(c01, c12), fmul(c11, c02))));
  const float rc = fminf(fmaxf(fdiv(det_c, 2.0f), -1.0f), 1.0f);
  const float phi = div_const<TORCH>(TORCH ? acosf(rc) : acos_poly(rc), 3.0f);
  r.hi = fadd(q, fmul(fmul(2.0f, r.p), cosf(phi)));
  r.lo = fadd(q, fmul(fmul(2.0f, r.p), cosf(fadd(phi, 2.0943952f))));
  r.mid = fsub(fsub(fmul(3.0f, q), r.hi), r.lo);
  return r;
}

// The roots unscaled: the eigenvalues, ascending (ops/eigh3.py::_unscale).
__device__ __forceinline__ void unscale(const Roots& r, float w[3]) {
  const bool nonzero = r.scale > 0.0f;
  w[0] = nonzero ? fmul(r.lo, r.safe) : 0.0f;
  w[1] = nonzero ? fmul(r.mid, r.safe) : 0.0f;
  w[2] = nonzero ? fmul(r.hi, r.safe) : 0.0f;
}

// ops/eigh3.py::eigh3x3_components (acos_fn=acos_poly unless TORCH, see
// eigen_roots): w ascending, v[i] the eigenvector of w[i].
template <bool TORCH = false>
__device__ __forceinline__ void eigh3(const float a[6], float w[3],
                                      float v[3][3]) {
  const Roots r = eigen_roots<TORCH>(a);
  const bool from_hi = fsub(r.hi, r.mid) >= fsub(r.mid, r.lo);
  float v_first[3], v_mid[3], v_third[3];
  evec_from_cross(r.b, from_hi ? r.hi : r.lo, v_first);
  evec_deflated(r.b, r.mid, v_first, v_mid);
  cross(v_first, v_mid, v_third);
  const bool iso = r.p < 1e-6f;
  for (int c = 0; c < 3; ++c) {
    v[0][c] = iso ? (c == 0 ? 1.0f : 0.0f) : (from_hi ? v_third[c] : v_first[c]);
    v[1][c] = iso ? (c == 1 ? 1.0f : 0.0f) : v_mid[c];
    v[2][c] = iso ? (c == 2 ? 1.0f : 0.0f) : (from_hi ? v_first[c] : v_third[c]);
  }
  unscale(r, w);
}

// VU-smoothed normal from the eigenpairs (pallas_fused.py:61-70).
__device__ __forceinline__ void vu_smooth(const float w[3], const float v[3][3],
                                          const float n[3], float tau,
                                          float damping, float f[3]) {
  float acc[3] = {fmul(damping, n[0]), fmul(damping, n[1]), fmul(damping, n[2])};
  for (int i = 0; i < 3; ++i) {
    const bool keep = w[i] > tau;
    const float proj = dot(v[i], n);
    for (int c = 0; c < 3; ++c) acc[c] = fadd(acc[c], keep ? fmul(proj, v[i][c]) : 0.0f);
  }
  const float inv = fdiv(1.0f, fmaxf(__fsqrt_rn(fmaxf(dot(acc, acc), 0.0f)), EPS));
  for (int c = 0; c < 3; ++c) f[c] = fmul(acc[c], inv);
}

// argmax of [scale * planarity, linearity, sphericity], first max wins
// (pallas_fused.py:73-86).
__device__ __forceinline__ float classify(const float w[3], float scale) {
  const float lam1 = w[2], lam2 = w[1], lam3 = w[0];
  const float safe = fabsf(lam1) > 1e-30f ? lam1 : 1e-30f;
  const float plan = fmul(fdiv(fsub(lam1, lam2), safe), scale);
  const float lin = fdiv(fsub(lam2, lam3), safe);
  const float sph = fdiv(lam3, safe);
  float cls = lin > plan ? 1.0f : 0.0f;
  if (sph > fmaxf(plan, lin)) cls = 2.0f;
  return cls;
}

// ops/solve3.py::solve3x3_components (rcond 1e-7): x = A^-1 b, or the
// fallback where A is (near-)singular.
__device__ __forceinline__ void solve3(const float m[3][3], const float b[3],
                                       const float fb[3], float x[3]) {
  const float a = m[0][0], bb = m[0][1], c = m[0][2];
  const float d = m[1][0], e = m[1][1], f = m[1][2];
  const float g = m[2][0], h = m[2][1], i = m[2][2];
  const float det = fadd(fsub(fmul(a, fsub(fmul(e, i), fmul(f, h))),
                              fmul(bb, fsub(fmul(d, i), fmul(f, g)))),
                         fmul(c, fsub(fmul(d, h), fmul(e, g))));
  float scale = fabsf(a);
  const float rest[8] = {bb, c, d, e, f, g, h, i};
  for (int k = 0; k < 8; ++k) scale = fmaxf(scale, fabsf(rest[k]));
  const float s = fmaxf(scale, 1e-30f);
  const bool ok = fabsf(det) > fmul(1e-7f, fmul(fmul(s, s), s));
  const float inv_det = fdiv(1.0f, ok ? det : 1.0f);
  const float adj[3][3] = {
      {fsub(fmul(e, i), fmul(f, h)), fsub(fmul(c, h), fmul(bb, i)), fsub(fmul(bb, f), fmul(c, e))},
      {fsub(fmul(f, g), fmul(d, i)), fsub(fmul(a, i), fmul(c, g)), fsub(fmul(c, d), fmul(a, f))},
      {fsub(fmul(d, h), fmul(e, g)), fsub(fmul(bb, g), fmul(a, h)), fsub(fmul(a, e), fmul(bb, d))}};
  for (int r = 0; r < 3; ++r) x[r] = ok ? fmul(dot(adj[r], b), inv_det) : fb[r];
}

// GR rows 0-17, staged by passes B, D and BD.
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

// The window sums of one query's update over the pairs d <= rk_step.
struct StepSums {
  float deg, s6[6], bnv[3], sv[3];
  float ext[12];  // the step's own: flat 2, edge 3 (q_yy), new 12
};

// The new position of a query of step `kind` (not DUMMY) from its sums:
// the flat step's clamp keeps a step of exactly d_thr (<=), the solves'
// needs it shorter (<).
__device__ __forceinline__ void step_result(int kind, const StepSums& s,
                                            const float p[3], const float nrm[3],
                                            const float y[3], float alpha,
                                            float d_thr, float res[3]) {
  if (kind == FLAT) {
    const float scalef = fmul(fdiv(s.ext[0], fmaxf(s.ext[1], 1e-30f)), alpha);
    const float di[3] = {fmul(scalef, nrm[0]), fmul(scalef, nrm[1]), fmul(scalef, nrm[2])};
    const bool ok = __fsqrt_rn(fmaxf(dot(di, di), 0.0f)) <= d_thr;
    for (int c = 0; c < 3; ++c) res[c] = ok ? fadd(p[c], di[c]) : p[c];
    return;
  }
  float opt[3];
  if (kind == EDGE) {
    edge_solve(y, s.s6, s.bnv, s.ext, s.deg, p, opt);
  } else if (kind == CORNER) {
    float m[3][3];
    srow(s.s6, m);
    solve3(m, s.bnv, p, opt);
  } else if (kind == FEATURE) {
    three_term(nrm, p, s.deg, s.s6, s.bnv, s.sv, opt);
  } else {  // NEW
    three_term(nrm, p, s.deg, s.ext, s.ext + 6, s.ext + 9, opt);
  }
  clamp_step(opt, p, alpha, d_thr, res);
}

// d2 of the flat and new steps of class `cid`: its delta by slot.
__device__ __forceinline__ float step_d2(const float* scal, const StepArgs& args,
                                         int cid, int kind) {
  if (kind != FLAT && kind != NEW) return 1.0f;
  const float delta = scal[(1 + args.slot[cid]) * 128];
  return fmaxf(fmul(delta, delta), 1e-30f);
}

// Sum (or max) of one value a thread over the block, in a fixed order
// (warp shuffles, then the warps in turn), so a rerun gives the same
// bits. Every thread of the block must call it; the result is valid in
// thread 0. blockDim.x is a multiple of 32.
__device__ __forceinline__ float block_reduce(float v, bool take_max, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    const float other = __shfl_down_sync(0xffffffffu, v, o);
    v = take_max ? fmaxf(v, other) : fadd(v, other);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float tot = red[0];
  if (threadIdx.x == 0)
    for (int k = 1; k < (int)(blockDim.x >> 5); ++k)
      tot = take_max ? fmaxf(tot, red[k]) : fadd(tot, red[k]);
  __syncthreads();
  return tot;
}

// Threads of a pass block: one a query, up to 256 (tile is a multiple of
// 32); at tile 512 a thread takes two queries.
__host__ inline int pass_threads(int tile) { return tile < 256 ? tile : 256; }

}  // namespace ngpd
