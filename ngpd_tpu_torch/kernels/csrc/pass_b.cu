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
// Design: the first half of pass BD, on its walk (pass_walk.cuh). One
// block per query tile with the window's GR rows 0-17 in shared memory at
// a pitch of whole 32-column words, one thread a query. One scan, chunk by
// chunk, computes each distance once into a feature and a step bit word;
// the feature bits feed the NVT2 sums at once, the step words of the whole
// window stay in shared memory (one a (word, thread)). After the
// eigensolver only a valid row of a delta class walks its step bits, from
// the lowest up, for sum p_j and the count: ascending column order, then
// added into the thread's partials row by row, the order of one walk over
// all columns, so the numbers are that walk's. The per-tile partials are
// reduced over the block in a fixed order (warp shuffles, then warps in
// turn), without atomics, and written compactly as (4 nd, num_tiles). The
// distances must match the plain version bit for bit, so there is no
// wgmma here (walk_common.cuh). A window too wide for the step bits
// (above ~2,200 columns at 256 threads) takes KEEP = false and scans the
// chunks of a delta-class row again.
//
// Measured at 1M points, tile 256, 512 columns (kernel_lab.py, NVIDIA H100
// 80GB HBM3 at 700 W, one call): 0.58 ms a launch where two walks over all
// columns with an early `continue` took 1.48 ms; scanning the step bits
// again instead of keeping them, 0.74 ms. The scan takes ~0.29 ms, the two
// accumulations ~0.17 ms, the per-point math and the 4 rows 0.09 ms,
// staging 0.03 ms. ptxas: bounded to three blocks of 256 threads an SM it
// takes 80 registers and spills 4 bytes; two blocks (100 registers) take
// 0.64 ms, and a fourth does not fit beside the kept bits (0.59 ms at 64
// registers).
#include "pass_walk.cuh"

namespace ngpd {

constexpr int B_MIN_BLOCKS = 3;  // blocks an SM

template <bool KEEP>
__global__ void __launch_bounds__(256, B_MIN_BLOCKS)
pass_b_kernel(const float* __restrict__ gq, const float* __restrict__ gr,
              const int* __restrict__ starts, float* __restrict__ cls_out,
              float* __restrict__ parts, int n, int nv, int tile, int wt, int wp,
              float cos_rho, float class_scale, int nd, int dc0, int dc1, int dc2) {
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

  const int dcls[3] = {dc0, dc1, dc2};
  float acc[3][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const int jmax = min(wt, nv - s);  // columns past nv are masked
  const int nwords = jmax > 0 ? (jmax + 31) >> 5 : 0;
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int i = blk * tile + r;
    const float q[3] = {gq[i], gq[n + i], gq[2 * n + i]};
    const float qq = gq[Q_PP * n + i];
    const float thr_f = mask_threshold(gq[Q_RKF * n + i]);
    const float thr_s = mask_threshold(gq[Q_RKS * n + i]);
    const NvtSums nvt =
        nvt_pass<KEEP>(sm, wp, nwords, jmax, sbits, cbits, q, qq, thr_f, thr_s, cos_rho);
    float t6[6], w[3], v[3][3];
    nvt_mean(nvt, t6);
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
    float sp[4] = {0.f, 0.f, 0.f, 0.f};
    walk_step_bits<KEEP>(sm, wp, nwords, jmax, sbits, cbits, q, qq, thr_s, [&](int j) {
#pragma unroll
      for (int c = 0; c < 3; ++c) sp[c] = fadd(sp[c], sm[(R_P + c) * wp + j]);
      sp[3] = fadd(sp[3], 1.0f);
    });
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

template <bool KEEP>
static void b_allow(size_t smem) {
  static size_t allowed = 0;
  allow_smem(pass_b_kernel<KEEP>, smem, allowed);
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
  const bool keep = walk_keeps(tile, wt);
  const size_t smem = walk_smem(tile, wt, keep);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define B_LAUNCH(KEEP)                                                         \
  b_allow<KEEP>(smem);                                                         \
  pass_b_kernel<KEEP><<<n / tile, pass_threads(tile), smem, cs>>>(             \
      static_cast<const float*>(gq), static_cast<const float*>(gr),            \
      static_cast<const int*>(starts), static_cast<float*>(cls_out),           \
      static_cast<float*>(parts), n, nv, tile, wt, round_up32(wt), cos_rho,    \
      class_scale, nd, dc0, dc1, dc2);
  if (keep) {
    B_LAUNCH(true)
  } else {
    B_LAUNCH(false)
  }
#undef B_LAUNCH
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds at this geometry, as the runtime
// counts them from its registers and shared memory.
extern "C" int ngpd_pass_b_blocks_per_sm(int tile, int wt) {
  using namespace ngpd;
  int blocks = 0;
  const bool keep = walk_keeps(tile, wt);
  const size_t smem = walk_smem(tile, wt, keep);
  if (keep) {
    b_allow<true>(smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pass_b_kernel<true>,
                                                  pass_threads(tile), smem);
  } else {
    b_allow<false>(smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pass_b_kernel<false>,
                                                  pass_threads(tile), smem);
  }
  return blocks;
}
