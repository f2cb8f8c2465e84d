// The hybrid engine's update stage: K2's window sums and the post-VU pack
// in; the next slim pack, the classes and the next lag state's per-tile
// partials out, one thread a point.
//
// Replaces: ngpd_tpu/core/pallas_fused.py, _xla_update_stage (the XLA
// fusion after K2 of pallas_denoise_hybrid). Its plain version is
// ngpd_tpu_torch/core/hybrid_stages.py::update_stage, which the CPU runs.
//
// Per point: the eigendecomposition of K2's filtered NVT2 (t6 rows), the
// class (classify), then the step of that class alone through
// step_result: flat from its two rows, edge from the q18 rows contracted
// with the edge direction y (update_stage's q_yy), corner and feature
// from s6, b_nv and sv, new from its 12 rows; dummy keeps p. Rows at or
// past nv keep p. The next pack carries the normals and both threshold
// rows. Per block of 256 points and per lagged-delta class ci (pass BD's
// parts layout, (5 nd, blocks)): sum of jp (the sv rows) and of deg over
// the points of that class below nv, and the largest of their maxd row,
// each reduced in a fixed order (block_reduce); kernels/passes.py::lag_scal
// turns them into the next scal.
//
// What bounds it on the H100: bytes. A point reads K2's t6 rows, the rows
// of its class's step (flat 2, edge 28, new 13, ...), for a class with a
// lagged delta its jp, deg and maxd rows, and 8 rows of the pack, and
// writes 8 rows and its class: 120 bytes a flat point of the default
// strategy, 0.036 ms for the 1M-point roof. Eager torch ran it as some
// 900 kernels of one operation each, every step on every point.
//
// Numerics: every product and sum rounded on its own in the order of the
// plain functions (ops/eigh3.py, ops/steps.py, ops/solve3.py), the
// eigenvalues with acosf and PyTorch's CUDA division by a constant
// (eigen_roots<true>), so the pack and classes equal the eager stage's on
// the card. Only the sums behind the centres run in another order: per
// block, then over the blocks, where update_stage sums over all points at
// once. The tensor cores have nothing to do here (no product of
// matrices), so no wgmma.
#include "passes_common.cuh"

namespace ngpd {

constexpr int UPDATE_THREADS = 256;

// Row offsets of K2's output (kernels/window.py::k2_layout), -1 where the
// strategy leaves a group out.
struct K2Rows {
  int t6, s6, b_nv, sv, q18, flat, nw, deg, maxd;
};

// update_stage's q_yy: q_yy[c] = sum over a, b of Q[(c, a), b] y_a y_b, in
// Python's sum order (from 0, a then b).
__device__ __forceinline__ void contract_q(const float* __restrict__ col, int n,
                                           int q18, const float y[3], float qyy[3]) {
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
    for (int a = 0; a < 3; ++a) {
      const int lo = c < a ? c : a, hi = c < a ? a : c;
      const int pair = lo == 0 ? hi : (lo == 1 ? 2 + hi : 5);  // (00 01 02 11 12 22)
      for (int b = 0; b < 3; ++b)
        acc = fadd(acc, fmul(fmul(col[(size_t)(q18 + 3 * pair + b) * n], y[a]), y[b]));
    }
    qyy[c] = acc;
  }
}

__global__ void __launch_bounds__(UPDATE_THREADS)
hybrid_update_kernel(const float* __restrict__ k2, const float* __restrict__ pack2,
                     const float* __restrict__ d_thr_p, float* __restrict__ pack_out,
                     float* __restrict__ cls_out, float* __restrict__ parts, int n,
                     int nv, float class_scale, StepArgs args, int nd, int dc0,
                     int dc1, int dc2, K2Rows rows) {
  __shared__ float red[UPDATE_THREADS / 32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int dc[3] = {dc0, dc1, dc2};
  float acc[3][5] = {};
  if (i < n) {
    const float* col = k2 + i;
    float t6[6], w[3], v[3][3], p[3], nrm[3];
#pragma unroll
    for (int r = 0; r < 6; ++r) t6[r] = col[(size_t)(rows.t6 + r) * n];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      p[c] = pack2[(size_t)c * n + i];
      nrm[c] = pack2[(size_t)(3 + c) * n + i];
    }
    eigh3<true>(t6, w, v);
    const float cls = classify(w, class_scale);
    // Selects, not an index into the arguments, which would copy them to
    // local memory.
    const int kind = cls == 0.0f ? args.kind[0] : (cls == 1.0f ? args.kind[1] : args.kind[2]);
    const float alpha =
        cls == 0.0f ? args.alpha[0] : (cls == 1.0f ? args.alpha[1] : args.alpha[2]);
    float res[3] = {p[0], p[1], p[2]};
    if (kind != DUMMY) {
      // Only the rows the class's step reads (step_result): the flat step
      // its two, the others their sums.
      StepSums s;
      if (kind == EDGE || kind == CORNER || kind == FEATURE) {
#pragma unroll
        for (int r = 0; r < 6; ++r) s.s6[r] = col[(size_t)(rows.s6 + r) * n];
#pragma unroll
        for (int c = 0; c < 3; ++c) s.bnv[c] = col[(size_t)(rows.b_nv + c) * n];
      }
      if (kind == EDGE || kind == FEATURE || kind == NEW) s.deg = col[(size_t)rows.deg * n];
      if (kind == FEATURE) {
#pragma unroll
        for (int c = 0; c < 3; ++c) s.sv[c] = col[(size_t)(rows.sv + c) * n];
      }
      if (kind == EDGE) {
        contract_q(col, n, rows.q18, v[0], s.ext);
      } else if (kind == FLAT) {
        s.ext[0] = col[(size_t)rows.flat * n];
        s.ext[1] = col[(size_t)(rows.flat + 1) * n];
      } else if (kind == NEW) {
        for (int r = 0; r < 12; ++r) s.ext[r] = col[(size_t)(rows.nw + r) * n];
      }
      step_result(kind, s, p, nrm, v[0], alpha, *d_thr_p, res);
    }
    const bool valid = i < nv;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pack_out[(size_t)c * n + i] = valid ? res[c] : p[c];
      pack_out[(size_t)(3 + c) * n + i] = nrm[c];
    }
    pack_out[(size_t)6 * n + i] = pack2[(size_t)6 * n + i];
    pack_out[(size_t)7 * n + i] = pack2[(size_t)7 * n + i];
    cls_out[i] = cls;

#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k >= nd || !valid || cls != (float)dc[k]) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) acc[k][c] = col[(size_t)(rows.sv + c) * n];
      acc[k][3] = col[(size_t)rows.deg * n];
      acc[k][4] = col[(size_t)(rows.maxd + k) * n];
    }
  }

  // Every thread of the block reduces, those past n with zeros (the value
  // of a point outside the class, for the sums and for the max alike).
  const int blocks = gridDim.x;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k >= nd) break;  // nd is the same in every thread
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float tot = block_reduce(acc[k][c], c == 4, red);
      if (threadIdx.x == 0) parts[(size_t)(5 * k + c) * blocks + blockIdx.x] = tot;
    }
  }
}

}  // namespace ngpd

// k2: K2's output, rows at the offsets given; pack2: (8, n) post-VU pack;
// d_thr: one float on the card; pack_out: (8, n) next slim pack, a buffer of
// its own; cls_out: (n,); parts: (5 nd, ceil(n / 256)). kind0-2: the step of
// classes 0-2 as indices of STEP_NAMES; alpha0-2: the step sizes; dc0-dc2:
// the delta classes, -1 past nd; row_*: k2_layout's offsets, -1 if absent.
extern "C" int ngpd_hybrid_update_launch(
    const void* k2, const void* pack2, const void* d_thr, void* pack_out,
    void* cls_out, void* parts, int n, int nv, float class_scale, int kind0,
    int kind1, int kind2, float alpha0, float alpha1, float alpha2, int nd,
    int dc0, int dc1, int dc2, int row_t6, int row_s6, int row_b_nv, int row_sv,
    int row_q18, int row_flat, int row_new, int row_deg, int row_maxd,
    void* stream) {
  using namespace ngpd;
  if (n <= 0) return 0;
  const StepArgs args = {{kind0, kind1, kind2}, {alpha0, alpha1, alpha2}, {-1, -1, -1}};
  const K2Rows rows = {row_t6, row_s6, row_b_nv, row_sv, row_q18,
                       row_flat, row_new, row_deg, row_maxd};
  hybrid_update_kernel<<<(n + UPDATE_THREADS - 1) / UPDATE_THREADS, UPDATE_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(k2), static_cast<const float*>(pack2),
      static_cast<const float*>(d_thr), static_cast<float*>(pack_out),
      static_cast<float*>(cls_out), static_cast<float*>(parts), n, nv, class_scale,
      args, nd, dc0, dc1, dc2, rows);
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds, as the runtime counts them.
extern "C" int ngpd_hybrid_update_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ngpd::hybrid_update_kernel,
                                                ngpd::UPDATE_THREADS, 0);
  return blocks;
}
