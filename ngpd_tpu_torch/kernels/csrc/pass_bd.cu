// Pass BD of the lagged-delta denoise: passes B and D fused. Per point,
// the filtered NVT2 of the smoothed normals over d <= rk_feat and its
// eigendecomposition give the class and the edge direction; the point
// then takes the step of its class from its window sums over d <= rk_step
// (as pass D, with the edge direction this kernel just found), the flat
// and new steps reading the PREVIOUS iteration's delta. It writes the
// next iteration's packs (positions moved, normals = the smoothed normals
// this iteration ran with, thresholds carried over), the classes, and per
// tile and delta class the partials of the next lag state: the sum of
// p_j, the pair count, and the max |p_j - previous centre|^2 over the
// step-mask pairs of that class's valid rows.
//
// Replaces: ngpd_tpu/core/pallas_fused.py:565, _make_pass_bd (the
// pallas_call at l.953 in pallas_denoise, delta_mode="lagged"). Deltas
// are read by slot, scal[1 + delta_slot[class], 0] (l.661, 704), the
// previous centres from scal[4 + ci, 0:3] (l.772-774). Padding rows keep
// their position (l.724-729) and contribute no partial (l.759-767). The
// max keeps the reference's "0 where masked" (max(mc * dist2), l.780).
//
// What bounds it on the H100: operations. Every (query, column) pair
// needs its distance and two threshold tests, the ~feature_k pairs the
// angle test and twelve sums, the ~step_k pairs 13 common sums and the
// step's own, and each point one eigendecomposition and one guarded 3x3
// solve. It reads the 40-row packs and writes 40 rows a point plus one
// class row and 5 nd scalars a tile.
//
// Design: one block per query tile with the window's GR rows 0-17 in
// shared memory, one thread per query, two walks over the window. The
// class and the edge direction come out of the first walk (NVT2, then the
// eigensolver); the second walk is pass D's (step_walk) with the class
// known, so only the selected step's sums are taken and the numbers are
// pass D's. Its common sums sv and deg are the centre partials of the
// row, and the running max to the row's own class centre rides along, so
// the partials cost no third walk. The next packs go to separate buffers:
// neighbouring tiles still read this iteration's window rows. Per-tile
// partials are reduced over the block in a fixed order, without atomics,
// and written compactly as (5 nd, num_tiles).
//
// Registers: both walks are chains of dependent shared-memory loads and
// adds, so the time follows the warps in flight. Left alone ptxas takes
// 104 registers (two blocks of 256 threads an SM); bounded to three
// blocks it takes 80 and spills 192 bytes around the eigensolver, once a
// point, and the launch is a sixth shorter (3.12 -> 2.64 ms at 1M points,
// chip_smoke.py phase pass_kernels, NVIDIA H100 80GB HBM3 at 700 W) with
// bit-equal output.
#include "passes_common.cuh"

namespace ngpd {

__global__ void __launch_bounds__(256, 3)
pass_bd_kernel(const float* __restrict__ gq, const float* __restrict__ gr,
               const float* __restrict__ scal, const int* __restrict__ starts,
               float* __restrict__ gq_out, float* __restrict__ gr_out,
               float* __restrict__ cls_out, float* __restrict__ parts, int n,
               int nv, int tile, int wt, float cos_rho, float class_scale,
               StepArgs args, int nd, int dc0, int dc1, int dc2) {
  extern __shared__ float sm[];  // D_ROWS rows of wt
  __shared__ float red[32];
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_rows(gr, n, s, wt, D_ROWS, sm);
  __syncthreads();
  const float d_thr = scal[0];
  const int dcls[3] = {dc0, dc1, dc2};

  // Per delta class: sum p_j (3), count, max dist^2 of this thread's rows.
  float acc[3][5] = {{0.f, 0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f, 0.f},
                     {0.f, 0.f, 0.f, 0.f, 0.f}};
  const int jmax = min(wt, nv - s);  // columns past nv are masked
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int i = blk * tile + r;
    const float p[3] = {gq[i], gq[n + i], gq[2 * n + i]};
    const float one = gq[Q_ONE * n + i], qq = gq[Q_PP * n + i];
    const float nrm[3] = {gq[Q_N * n + i], gq[(Q_N + 1) * n + i], gq[(Q_N + 2) * n + i]};

    // B: NVT2 -> class and edge direction.
    float t6[6], w[3], v[3][3];
    nvt_t6(sm, wt, jmax, p, qq, gq[Q_RKF * n + i], cos_rho, t6);
    eigh3(t6, w, v);
    const float cls = classify(w, class_scale);
    const float y[3] = {v[0][0], v[0][1], v[0][2]};
    cls_out[i] = cls;

    // D: the step of the class; padding rows keep their position and
    // give no partial. A dummy class that is a delta class still walks,
    // for its partials.
    const int cid = cls == 0.0f ? 0 : (cls == 1.0f ? 1 : 2);
    const int kind = args.kind[cid];
    int ci = -1;
    for (int k = 0; k < nd; ++k)
      if (cid == dcls[k]) ci = k;
    float res[3] = {p[0], p[1], p[2]};
    if (i < nv && (kind != DUMMY || ci >= 0)) {
      StepSums sums;
      if (ci >= 0) {
        const float cen[3] = {scal[(4 + ci) * 128], scal[(4 + ci) * 128 + 1],
                              scal[(4 + ci) * 128 + 2]};
        const float cc = fadd(fadd(fmul(cen[0], cen[0]), fmul(cen[1], cen[1])),
                              fmul(cen[2], cen[2]));
        const float mx = step_walk<true>(sm, wt, jmax, p, qq, gq[Q_RKS * n + i], nrm, y,
                                         kind, step_d2(scal, args, cid, kind), cen, cc,
                                         sums);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (k == ci) {
#pragma unroll
            for (int c = 0; c < 3; ++c) acc[k][c] = fadd(acc[k][c], sums.sv[c]);
            acc[k][3] = fadd(acc[k][3], sums.deg);
            acc[k][4] = fmaxf(acc[k][4], mx);
          }
      } else {
        const float none[3] = {0.f, 0.f, 0.f};
        step_walk<false>(sm, wt, jmax, p, qq, gq[Q_RKS * n + i], nrm, y, kind,
                         step_d2(scal, args, cid, kind), none, 0.0f, sums);
      }
      if (kind != DUMMY) step_result(kind, sums, p, nrm, y, args.alpha[cid], d_thr, res);
    }

    // The next packs: pos = res, normals = nrm, rows 8-15 of GQ carried.
    const float np2 = fadd(fadd(fmul(res[0], res[0]), fmul(res[1], res[1])),
                           fmul(res[2], res[2]));
    const float pn = dot(res, nrm);
    const float sym[6] = {fmul(nrm[0], nrm[0]), fmul(nrm[0], nrm[1]), fmul(nrm[0], nrm[2]),
                          fmul(nrm[1], nrm[1]), fmul(nrm[1], nrm[2]), fmul(nrm[2], nrm[2])};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gq_out[c * n + i] = res[c];
      gq_out[(Q_N + c) * n + i] = nrm[c];
      gr_out[c * n + i] = fmul(-2.0f, res[c]);
      gr_out[(R_N + c) * n + i] = nrm[c];
      gr_out[(R_P + c) * n + i] = res[c];
    }
    gq_out[Q_ONE * n + i] = one;
    gq_out[Q_PP * n + i] = np2;
    for (int c = Q_RKF; c < GQ_ROWS; ++c) gq_out[c * n + i] = gq[c * n + i];
    gr_out[R_PP * n + i] = np2;
    gr_out[(R_PP + 1) * n + i] = one;
    gr_out[R_PN * n + i] = pn;
#pragma unroll
    for (int c = 0; c < 6; ++c) gr_out[(R_SYM + c) * n + i] = sym[c];
    for (int c = D_ROWS; c < GR_ROWS; ++c) gr_out[c * n + i] = 0.0f;
  }

  const int num_tiles = n / tile;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k >= nd) break;  // nd is the same in every thread
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float tot = block_reduce(acc[k][c], c == 4, red);
      if (threadIdx.x == 0) parts[(5 * k + c) * num_tiles + blk] = tot;
    }
  }
}

}  // namespace ngpd

// gq, gr: (16, n), (24, n) post-pass-A packs; scal: (8, 128) previous lag
// state (d_thr, deltas, centres); starts: (n / tile,) int32; gq_out,
// gr_out: the next packs, buffers of their own; cls_out: (n,); parts:
// (5 nd, n / tile). kind0-2: the step of classes 0-2 as indices of
// STEP_NAMES; alpha0-2: the step sizes; slot0-2: each class's row of
// deltas in scal, -1 if none; dc0-dc2: the delta classes, -1 past nd.
extern "C" int ngpd_pass_bd_launch(const void* gq, const void* gr,
                                   const void* scal, const void* starts,
                                   void* gq_out, void* gr_out, void* cls_out,
                                   void* parts, int n, int nv, int tile, int wt,
                                   float cos_rho, float class_scale, int kind0,
                                   int kind1, int kind2, float alpha0,
                                   float alpha1, float alpha2, int slot0,
                                   int slot1, int slot2, int nd, int dc0,
                                   int dc1, int dc2, void* stream) {
  using namespace ngpd;
  const StepArgs args = {{kind0, kind1, kind2}, {alpha0, alpha1, alpha2},
                         {slot0, slot1, slot2}};
  const size_t smem = prepare_launch(pass_bd_kernel, D_ROWS, wt);
  pass_bd_kernel<<<n / tile, pass_threads(tile), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gq), static_cast<const float*>(gr),
      static_cast<const float*>(scal), static_cast<const int*>(starts),
      static_cast<float*>(gq_out), static_cast<float*>(gr_out),
      static_cast<float*>(cls_out), static_cast<float*>(parts), n, nv, tile,
      wt, cos_rho, class_scale, args, nd, dc0, dc1, dc2);
  return (int)cudaGetLastError();
}
