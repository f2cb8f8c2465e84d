// Pass B of the four-pass denoise: per point, the filtered NVT2 of the
// smoothed normals over d <= rk_feat and its eigendecomposition give the
// class (argmax of planarity, linearity, sphericity) and the edge
// direction (the smallest eigenvalue's eigenvector); per tile and per
// delta class, the sum of p_j and the count over the pairs d <= rk_step
// of that class's valid rows, the centre partials of the exact delta.
//
// Replaces: ngpd_tpu/core/pallas_fused.py:281, _make_pass_b (the
// pallas_call at l.978 in pallas_denoise). Only its exact-delta form:
// lagged=True (l.335-348) is never launched, since lagged mode runs the
// fused pass BD instead (l.1067-1070), so this kernel has no lagged
// branch and reads no lag state.
//
// What bounds it on the H100: operations. Every (query, column) pair
// needs its distance and threshold test, the ~feature_k pairs the angle
// test and twelve sums, and each point one eigendecomposition; it reads
// the 40-row packs and writes 4 rows a point.
//
// Design: as pass A, one block per query tile with the window's GR rows
// 0-17 in shared memory and one thread per query. A thread whose point
// is valid and of a delta class walks the window a second time for the
// step-mask sums (the class needs the eigensolver, which needs the first
// walk). The per-tile partials are reduced over the block in a fixed
// order (warp shuffles, then warps in turn), without atomics, and
// written compactly as (4 nd, num_tiles).
#include "passes_common.cuh"

namespace ngpd {

constexpr int B_ROWS = R_P + 3;

__global__ void pass_b_kernel(const float* __restrict__ gq,
                              const float* __restrict__ gr,
                              const int* __restrict__ starts,
                              float* __restrict__ cls_out,
                              float* __restrict__ parts, int n, int nv,
                              int tile, int wt, float cos_rho,
                              float class_scale, int nd, int dc0, int dc1,
                              int dc2) {
  extern __shared__ float sm[];  // B_ROWS rows of wt
  __shared__ float red[32];
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_rows(gr, n, s, wt, B_ROWS, sm);
  __syncthreads();

  const int dcls[3] = {dc0, dc1, dc2};
  float acc[3][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const int jmax = min(wt, nv - s);  // columns past nv are masked
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int i = blk * tile + r;
    const float q[3] = {gq[i], gq[n + i], gq[2 * n + i]};
    const float qq = gq[Q_PP * n + i];
    float t6[6], w[3], v[3][3];
    nvt_t6(sm, wt, jmax, q, qq, gq[Q_RKF * n + i], cos_rho, t6);
    eigh3(t6, w, v);
    const float cls = classify(w, class_scale);
    cls_out[i] = cls;
    cls_out[n + i] = v[0][0];
    cls_out[2 * n + i] = v[0][1];
    cls_out[3 * n + i] = v[0][2];

    int ci = -1;
    for (int k = 0; k < nd; ++k)
      if (cls == (float)dcls[k]) ci = k;
    if (ci < 0 || i >= nv) continue;
    const float rk8 = gq[Q_RKS * n + i];
    float sp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < jmax; ++j) {
      const float d = pack_dist(q[0], q[1], q[2], qq, sm, wt, j);
      if (!(d <= rk8 && d < MASKED)) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) sp[c] = fadd(sp[c], sm[(R_P + c) * wt + j]);
      sp[3] = fadd(sp[3], 1.0f);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k == ci)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[k][c] = fadd(acc[k][c], sp[c]);
  }

  const int num_tiles = n / tile;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k >= nd) break;  // nd is the same in every thread
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float tot = block_reduce(acc[k][c], false, red);
      if (threadIdx.x == 0) parts[(4 * k + c) * num_tiles + blk] = tot;
    }
  }
}

}  // namespace ngpd

// gq, gr: (16, n), (24, n) post-pass-A packs; starts: (n / tile,) int32;
// cls_out: (4, n); parts: (4 nd, n / tile); dc0-dc2: the delta classes,
// -1 past nd.
extern "C" int ngpd_pass_b_launch(const void* gq, const void* gr,
                                  const void* starts, void* cls_out,
                                  void* parts, int n, int nv, int tile, int wt,
                                  float cos_rho, float class_scale, int nd,
                                  int dc0, int dc1, int dc2, void* stream) {
  using namespace ngpd;
  const size_t smem = prepare_launch(pass_b_kernel, B_ROWS, wt);
  pass_b_kernel<<<n / tile, pass_threads(tile), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gq), static_cast<const float*>(gr),
      static_cast<const int*>(starts), static_cast<float*>(cls_out),
      static_cast<float*>(parts), n, nv, tile, wt, cos_rho, class_scale, nd,
      dc0, dc1, dc2);
  return (int)cudaGetLastError();
}
