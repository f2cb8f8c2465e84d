// The dense pipeline's update: per point, only the step of its class over
// its step neighbours (flat with the class delta, edge with the edge
// direction, corner, feature, new with the class delta, or dummy), then the
// clamp, and the new position. One thread a point.
//
// Replaces: no TPU kernel; the reference is the XLA program of
// ngpd_tpu/core/pipeline.py::denoise_iteration's steps. Its plain version
// is ngpd_tpu_torch/core/denoise.py's steps, each over every point, and the
// select by class (core/denoise.py::class_step, ::pick_by_class), which
// the CPU runs; eagerly on the card that is some 900 kernels of one
// operation each.
//
// What bounds it on the H100: latency. At 32,768 points and step_k 8 the
// rows read once (positions, normals, classes, edge directions, 8 indices
// and mask bytes a point, the new positions written) are 4.2 MB, 1.3 us of
// traffic; the 262k neighbour gathers come from L2. A solve is a few
// hundred operations a point.
//
// Design: one thread a point; the class deltas are the largest of each
// row of dense_delta.cu's per-block maxima (exact in any order), taken
// once a block into shared memory. The sums over the neighbours and the
// 3x3 solves run in PyTorch's order and rounding (dense_common.cuh), so a
// point's new position equals the eager stage's bit for bit given the same
// delta. No wgmma: no product of matrices.
#include "dense_common.cuh"

namespace ngpd {
namespace dense {

// A point's step neighbours: rows of the source positions and smoothed
// normals that its indices name.
struct Rows {
  const float* pts;
  const float* nrm;
  const int64_t* idx;
  const bool* valid;
  int k;
};

// ops/solve3.py::solve3x3_guarded: (adj(A) b) / det where |det| exceeds
// 1e-7 max|A|^3 and is finite, else the fallback.
__device__ __forceinline__ void solve_guarded(const float m[3][3], const float b[3],
                                              const float fb[3], float x[3]) {
  const float a = m[0][0], bb = m[0][1], c = m[0][2];
  const float d = m[1][0], e = m[1][1], f = m[1][2];
  const float g = m[2][0], h = m[2][1], i = m[2][2];
  const float det = fadd(fsub(fmul(a, fsub(fmul(e, i), fmul(f, h))),
                              fmul(bb, fsub(fmul(d, i), fmul(f, g)))),
                         fmul(c, fsub(fmul(d, h), fmul(e, g))));
  float scale = fabsf(a);
  const float rest[8] = {bb, c, d, e, f, g, h, i};
  for (int q = 0; q < 8; ++q) scale = fmaxf(scale, fabsf(rest[q]));
  const float s = clamp_min(scale, 1e-30f);
  const bool ok = fabsf(det) > fmul(fmul(fmul(s, s), s), 1e-7f) && isfinite(det);
  const float adj[3][3] = {
      {fsub(fmul(e, i), fmul(f, h)), fsub(fmul(c, h), fmul(bb, i)), fsub(fmul(bb, f), fmul(c, e))},
      {fsub(fmul(f, g), fmul(d, i)), fsub(fmul(a, i), fmul(c, g)), fsub(fmul(c, d), fmul(a, f))},
      {fsub(fmul(d, h), fmul(e, g)), fsub(fmul(bb, g), fmul(a, h)), fsub(fmul(a, e), fmul(bb, d))}};
  const float den = ok ? det : 1.0f;
  for (int r = 0; r < 3; ++r) x[r] = ok ? fdiv(bmm_row(adj[r], b), den) : fb[r];
}

// core/denoise.py::_clamp_step with strict=True.
__device__ __forceinline__ void clamp_dense(const float opt[3], const float p[3], float alpha,
                                            float d, float res[3]) {
  const float di[3] = {fmul(fsub(opt[0], p[0]), alpha), fmul(fsub(opt[1], p[1]), alpha),
                       fmul(fsub(opt[2], p[2]), alpha)};
  const bool ok = norm3(di) < d;
  for (int c = 0; c < 3; ++c) res[c] = ok ? fadd(p[c], di[c]) : p[c];
}

// core/denoise.py::flat_step at one point. The weights of the first MAX_K
// slots are kept for their sum; past those a weight is computed again.
__device__ __forceinline__ void flat_dense(const Rows& nb, const float p[3], const float nv[3],
                                           float d2, float alpha, float d, float res[3]) {
  float wv[MAX_K];
  float summed[3];
  auto weight = [&](int e, float nj[3], float dist[3]) {
    float vj[3];
    load3(nb.pts, nb.idx[e], vj);
    load3(nb.nrm, nb.idx[e], nj);
    for (int q = 0; q < 3; ++q) dist[q] = fsub(vj[q], p[q]);
    const float dn[3] = {fsub(nv[0], nj[0]), fsub(nv[1], nj[1]), fsub(nv[2], nj[2])};
    const float sim = expf(fdiv(fmul(dot3(dn, dn), -16.0f), d2));
    const float clo = expf(fdiv(fmul(dot3(dist, dist), -4.0f), d2));
    return nb.valid[e] ? fmul(sim, clo) : 0.0f;
  };
  auto term = [&](int e, float t[3]) {
    float nj[3], dist[3];
    const float wij = weight(e, nj, dist);
    if (e < MAX_K) wv[e] = wij;
    const float tw = fmul(wij, dot3(nj, dist));
    for (int q = 0; q < 3; ++q) t[q] = fmul(tw, nv[q]);
  };
  axis_sum<3>(nb.k, term, summed);
  auto kept = [&](int e) {
    float nj[3], dist[3];
    return e < MAX_K ? wv[e] : weight(e, nj, dist);
  };
  const float wsum = clamp_min(row_sum(nb.k, kept), 1e-30f);
  float di[3];
  for (int q = 0; q < 3; ++q) di[q] = fmul(fdiv(summed[q], wsum), alpha);
  const bool ok = norm3(di) <= d;
  for (int q = 0; q < 3; ++q) res[q] = fadd(p[q], ok ? di[q] : 0.0f);
}

// core/denoise.py::_three_term_system and its solve: the feature step
// (weights 1 on valid slots) or the new step (the likeliness weights).
__device__ __forceinline__ void three_term_dense(const Rows& nb, const float p[3],
                                                 const float nv[3], bool likeliness,
                                                 float d2, float opt[3]) {
  float s[15];  // sum w nj nj^T (9), sum w nj (nj . vj) (3), sum w vj (3)
  int deg = 0;
  auto term = [&](int e, float t[15]) {
    float vj[3], nj[3];
    load3(nb.pts, nb.idx[e], vj);
    load3(nb.nrm, nb.idx[e], nj);
    float w = nb.valid[e] ? 1.0f : 0.0f;
    if (likeliness) {
      const float dvp[3] = {fsub(vj[0], p[0]), fsub(vj[1], p[1]), fsub(vj[2], p[2])};
      const float pd = dot3(nj, dvp);
      w = nb.valid[e] ? expf(fdiv(fmul(fmul(pd, pd), -9.0f), d2)) : 0.0f;
    }
    deg += nb.valid[e];
    const float nw[3] = {fmul(nj[0], w), fmul(nj[1], w), fmul(nj[2], w)};
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) t[3 * a + b] = fmul(nw[a], nj[b]);
    const float inner = dot3(nj, vj);
    for (int c = 0; c < 3; ++c) {
      t[9 + c] = fmul(nw[c], inner);
      t[12 + c] = fmul(w, vj[c]);
    }
  };
  axis_sum<15>(nb.k, term, s);
  const float degf = (float)deg;
  float nio[3][3], m[3][3], rhs[3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) nio[a][b] = fmul(nv[a], nv[b]);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      m[a][b] = fadd(fadd(fadd(a == b ? 1.0f : 0.0f, nio[a][b]), s[3 * a + b]),
                     fmul(degf, nio[a][b]));
  for (int r = 0; r < 3; ++r) {
    const float mv1 = sum3(fmul(nio[r][0], p[0]), fmul(nio[r][1], p[1]), fmul(nio[r][2], p[2]));
    const float mv2 =
        sum3(fmul(nio[r][0], s[12]), fmul(nio[r][1], s[13]), fmul(nio[r][2], s[14]));
    rhs[r] = fadd(fadd(fadd(p[r], mv1), mv2), s[9 + r]);
  }
  solve_guarded(m, rhs, p, opt);
}

// core/denoise.py::corner_step's solve.
__device__ __forceinline__ void corner_dense(const Rows& nb, const float p[3], float opt[3]) {
  float s[12];
  auto term = [&](int e, float t[12]) {
    float vj[3], nj[3];
    load3(nb.pts, nb.idx[e], vj);
    load3(nb.nrm, nb.idx[e], nj);
    const float w = nb.valid[e] ? 1.0f : 0.0f;
    const float nw[3] = {fmul(nj[0], w), fmul(nj[1], w), fmul(nj[2], w)};
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) t[3 * a + b] = fmul(nw[a], nj[b]);
    const float inner = dot3(nj, vj);
    for (int c = 0; c < 3; ++c) t[9 + c] = fmul(nw[c], inner);
  };
  axis_sum<12>(nb.k, term, s);
  const float m[3][3] = {{s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]}};
  solve_guarded(m, s + 9, p, opt);
}

// core/denoise.py::edge_step's solve, y the edge direction.
__device__ __forceinline__ void edge_dense(const Rows& nb, const float p[3], const float y[3],
                                           float opt[3]) {
  float s[12];
  int deg = 0;
  auto term = [&](int e, float t[12]) {
    float vj[3], nj[3];
    load3(nb.pts, nb.idx[e], vj);
    load3(nb.nrm, nb.idx[e], nj);
    const float dvp[3] = {fsub(vj[0], p[0]), fsub(vj[1], p[1]), fsub(vj[2], p[2])};
    const float s1 = dot3(dvp, y), s2 = dot3(nj, y);
    float vp[3], np[3];
    for (int c = 0; c < 3; ++c) {
      vp[c] = fsub(vj[c], fmul(s1, y[c]));
      np[c] = fsub(nj[c], fmul(s2, y[c]));
    }
    const float w = nb.valid[e] ? 1.0f : 0.0f;
    deg += nb.valid[e];
    const float nw[3] = {fmul(np[0], w), fmul(np[1], w), fmul(np[2], w)};
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) t[3 * a + b] = fmul(nw[a], np[b]);
    const float inner = dot3(np, vp);
    for (int c = 0; c < 3; ++c) t[9 + c] = fmul(nw[c], inner);
  };
  axis_sum<12>(nb.k, term, s);
  const float degf = (float)deg;
  float m[3][3], rhs[3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) m[a][b] = fadd(s[3 * a + b], fmul(degf, fmul(y[a], y[b])));
  for (int r = 0; r < 3; ++r) {
    const float yo[3] = {fmul(y[r], y[0]), fmul(y[r], y[1]), fmul(y[r], y[2])};
    const float mv = sum3(fmul(yo[0], p[0]), fmul(yo[1], p[1]), fmul(yo[2], p[2]));
    rhs[r] = fadd(s[9 + r], fmul(degf, mv));
  }
  solve_guarded(m, rhs, p, opt);
}

__global__ void __launch_bounds__(THREADS)
dense_update_kernel(const float* __restrict__ pts, const float* __restrict__ f_n,
                    const float* __restrict__ src_pts, const float* __restrict__ src_f_n,
                    const int64_t* __restrict__ idx, const bool* __restrict__ mask, int k,
                    const int* __restrict__ cls, const float* __restrict__ edge,
                    const float* __restrict__ deltas, int delta_cols, int dmask,
                    const float* __restrict__ d_ptr, float d_val, StepArgs args, int n,
                    float* __restrict__ out) {
  __shared__ float red[THREADS / 32];
  __shared__ float delta[3];
  for (int c = 0; c < 3; ++c) {  // dmask is the same in every thread
    if (!((dmask >> c) & 1)) continue;
    float far = 0.0f;
    for (int b = threadIdx.x; b < delta_cols; b += blockDim.x)
      far = fmaxf(far, deltas[(int64_t)c * delta_cols + b]);
    const float tot = block_reduce(far, true, red);
    if (threadIdx.x == 0) delta[c] = tot;
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int c = cls[i];
  // Selects, not an index into the arguments, which would copy them to
  // local memory.
  const int kind = c == 0 ? args.kind[0] : (c == 1 ? args.kind[1] : args.kind[2]);
  const float alpha = c == 0 ? args.alpha[0] : (c == 1 ? args.alpha[1] : args.alpha[2]);
  const float d = d_ptr != nullptr ? *d_ptr : d_val;
  float p[3], res[3];
  load3(pts, i, p);
  const Rows nb = {src_pts, src_f_n, idx + (int64_t)i * k, mask + (int64_t)i * k, k};
  if (kind == FLAT || kind == NEW) {
    const float dc = c == 0 ? delta[0] : (c == 1 ? delta[1] : delta[2]);
    const float d2 = clamp_min(fmul(dc, dc), 1e-30f);
    float nv[3];
    load3(f_n, i, nv);
    if (kind == FLAT) {
      flat_dense(nb, p, nv, d2, alpha, d, res);
    } else {
      float opt[3];
      three_term_dense(nb, p, nv, true, d2, opt);
      clamp_dense(opt, p, alpha, d, res);
    }
  } else if (kind == DUMMY) {
    for (int q = 0; q < 3; ++q) res[q] = p[q];
  } else {
    float opt[3];
    if (kind == EDGE) {
      float y[3];
      load3(edge, i, y);
      edge_dense(nb, p, y, opt);
    } else if (kind == CORNER) {
      corner_dense(nb, p, opt);
    } else {  // FEATURE
      float nv[3];
      load3(f_n, i, nv);
      three_term_dense(nb, p, nv, false, 1.0f, opt);
    }
    clamp_dense(opt, p, alpha, d, res);
  }
  for (int q = 0; q < 3; ++q) out[3 * (int64_t)i + q] = res[q];
}

}  // namespace dense
}  // namespace ngpd

// pts, f_n: the query rows (n, 3) float32; src_pts, src_f_n: the rows (m,
// 3) that idx names (pts and f_n on one device); idx, mask: the step
// neighbourhood (n, k); cls: (n,) int32; edge: (n, 3); deltas: (3, delta_cols), class c's delta the
// largest of row c, read for the classes of dmask; d: the step threshold,
// one float on the card (d_ptr) or d_val where d_ptr is null; kind0-2 the
// steps of classes 0-2 as indices of STEP_NAMES, alpha0-2 their sizes; out:
// (n, 3), a buffer of its own.
extern "C" int ngpd_dense_update_launch(const void* pts, const void* f_n,
                                        const void* src_pts, const void* src_f_n,
                                        const void* idx, const void* mask, int k, const void* cls,
                                        const void* edge, const void* deltas, int delta_cols,
                                        int dmask, const void* d_ptr, float d_val, int kind0,
                                        int kind1, int kind2, float alpha0, float alpha1,
                                        float alpha2, int n, void* out, void* stream) {
  using namespace ngpd;
  using namespace ngpd::dense;
  if (n <= 0) return 0;
  const StepArgs args = {{kind0, kind1, kind2}, {alpha0, alpha1, alpha2}, {-1, -1, -1}};
  dense_update_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(f_n),
      static_cast<const float*>(src_pts), static_cast<const float*>(src_f_n),
      static_cast<const int64_t*>(idx), static_cast<const bool*>(mask), k,
      static_cast<const int*>(cls), static_cast<const float*>(edge),
      static_cast<const float*>(deltas), delta_cols, dmask, static_cast<const float*>(d_ptr),
      d_val, args, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds, as the runtime counts them.
extern "C" int ngpd_dense_update_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ngpd::dense::dense_update_kernel,
                                                ngpd::dense::THREADS, 0);
  return blocks;
}
