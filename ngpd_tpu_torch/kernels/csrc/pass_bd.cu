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
// shared memory and one thread per query; a query's window distances are
// computed once. The walk is walk_common.cuh's and its accumulations
// pass_walk.cuh's, shared with passes B and D; in chunks of 16 words of
// 32 columns: each lane computes a word's 32 distances branch-free into a
// feature and a step bit word. The feature words of the chunk feed the
// NVT2 sums at once, the lane visiting its own set bits in one flat loop
// (the angle filter on a recomputed distance). The step words of the whole
// window are kept in shared memory behind the window rows, one a (word,
// thread), for the second accumulation, which runs after the eigensolver
// with the class and the edge direction known: pass D's step body
// operation for operation over the set bits from the lowest up, one loop a
// step kind, so only the selected step's sums are taken, in ascending
// column order, and the numbers are pass D's. Its common sums sv and deg
// are the centre partials of the row, and the running max to the row's own
// class centre rides along. The next packs go to separate buffers:
// neighbouring tiles still read this iteration's window rows. Per-tile
// partials are reduced over the block in a fixed order, without atomics,
// and written compactly as (5 nd, num_tiles). The distances must match the
// plain version bit for bit, so there is no wgmma here (walk_common.cuh).
//
// A window too wide for its step bits to fit beside it in the SM's 227 KB
// (above ~2,200 columns at 256 threads) takes the KEEP = false variant,
// which scans each chunk again in the second accumulation.
//
// Measured at 1M points, tile 256, 512 columns (kernel_lab.py, NVIDIA H100
// 80GB HBM3 at 700 W): 0.66 ms a launch where two walks over all columns
// took 2.57 ms; the per-word bit walk 1.16 ms, the flat chunk walk 0.76
// ms, staging six rows at a time in 16-byte loads 0.66 ms. The word skip
// that K2 keeps gained nothing here (0.665 ms with, 0.640 without, in one
// call) and is not used. The scan takes ~0.23 ms, the two accumulations
// ~0.23 ms, the per-point math and the 41 output rows 0.15 ms, staging
// 0.04 ms. ptxas: bounded to three blocks of 256 threads an SM it takes 80
// registers and spills 160 bytes around the eigensolver; two blocks (119
// registers, no spill) and four (64 registers, 312 bytes spilled) are both
// slower (0.74 ms).
#include "pass_walk.cuh"

namespace ngpd {

constexpr int BD_MIN_BLOCKS = 3;  // blocks an SM

template <bool KEEP>
__global__ void __launch_bounds__(256, BD_MIN_BLOCKS)
pass_bd_kernel(const float* __restrict__ gq, const float* __restrict__ gr,
               const float* __restrict__ scal, const int* __restrict__ starts,
               float* __restrict__ gq_out, float* __restrict__ gr_out,
               float* __restrict__ cls_out, float* __restrict__ parts, int n,
               int nv, int tile, int wt, int wp, float cos_rho,
               float class_scale, StepArgs args, int nd, int dc0, int dc1,
               int dc2) {
  // D_ROWS rows of wp, one chunk's bit words and, with KEEP, the step bit
  // words of the whole window, one a (word, thread).
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  unsigned* cbits = reinterpret_cast<unsigned*>(sm + D_ROWS * wp) + threadIdx.x;
  unsigned* sbits = cbits + CHUNK_WORDS * blockDim.x;
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_rows_pitched<D_ROWS>(gr, n, s, wt, wp, sm);
  __syncthreads();
  const float d_thr = scal[0];
  const int dcls[3] = {dc0, dc1, dc2};

  // Per delta class: sum p_j (3), count, max dist^2 of this thread's rows.
  float acc[3][5] = {{0.f, 0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f, 0.f},
                     {0.f, 0.f, 0.f, 0.f, 0.f}};
  const int jmax = min(wt, nv - s);  // columns past nv are masked
  const int nwords = jmax > 0 ? (jmax + 31) >> 5 : 0;
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int i = blk * tile + r;
    const float p[3] = {gq[i], gq[n + i], gq[2 * n + i]};
    const float one = gq[Q_ONE * n + i], qq = gq[Q_PP * n + i];
    const float nrm[3] = {gq[Q_N * n + i], gq[(Q_N + 1) * n + i], gq[(Q_N + 2) * n + i]};
    const float thr_f = mask_threshold(gq[Q_RKF * n + i]);
    const float thr_s = mask_threshold(gq[Q_RKS * n + i]);

    // The one scan, chunk by chunk: feature bits into the NVT2 sums, step
    // bits kept.
    const NvtSums nvt =
        nvt_pass<KEEP>(sm, wp, nwords, jmax, sbits, cbits, p, qq, thr_f, thr_s, cos_rho);

    // B: NVT2 -> class and edge direction.
    float t6[6], w[3], v[3][3];
    nvt_mean(nvt, t6);
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
      StepSums sums{};  // every sum 0
      float cen[3] = {0.f, 0.f, 0.f}, cc = 0.0f, mx = 0.0f;
      if (ci >= 0) {
#pragma unroll
        for (int c = 0; c < 3; ++c) cen[c] = scal[(4 + ci) * 128 + c];
        cc = fadd(fadd(fmul(cen[0], cen[0]), fmul(cen[1], cen[1])), fmul(cen[2], cen[2]));
      }
      const float d2 = step_d2(scal, args, cid, kind);
      step_pass_of<KEEP>(kind, sm, wp, nwords, jmax, sbits, cbits, p, qq, thr_s, nrm, y,
                         d2, ci >= 0, cen, cc, sums, mx);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (k == ci) {
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[k][c] = fadd(acc[k][c], sums.sv[c]);
          acc[k][3] = fadd(acc[k][3], sums.deg);
          acc[k][4] = fmaxf(acc[k][4], mx);
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

template <bool KEEP>
static void bd_allow(size_t smem) {
  static size_t allowed = 0;
  allow_smem(pass_bd_kernel<KEEP>, smem, allowed);
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
  const bool keep = walk_keeps(tile, wt);
  const size_t smem = walk_smem(tile, wt, keep);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define BD_LAUNCH(KEEP)                                                        \
  bd_allow<KEEP>(smem);                                                        \
  pass_bd_kernel<KEEP><<<n / tile, pass_threads(tile), smem, cs>>>(            \
      static_cast<const float*>(gq), static_cast<const float*>(gr),            \
      static_cast<const float*>(scal), static_cast<const int*>(starts),        \
      static_cast<float*>(gq_out), static_cast<float*>(gr_out),                \
      static_cast<float*>(cls_out), static_cast<float*>(parts), n, nv, tile,   \
      wt, round_up32(wt), cos_rho, class_scale, args, nd, dc0, dc1, dc2);
  if (keep) {
    BD_LAUNCH(true)
  } else {
    BD_LAUNCH(false)
  }
#undef BD_LAUNCH
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds at this geometry, as the runtime
// counts them from its registers and shared memory.
extern "C" int ngpd_pass_bd_blocks_per_sm(int tile, int wt) {
  using namespace ngpd;
  int blocks = 0;
  const bool keep = walk_keeps(tile, wt);
  const size_t smem = walk_smem(tile, wt, keep);
  if (keep) {
    bd_allow<true>(smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pass_bd_kernel<true>,
                                                  pass_threads(tile), smem);
  } else {
    bd_allow<false>(smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pass_bd_kernel<false>,
                                                  pass_threads(tile), smem);
  }
  return blocks;
}
