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
// Design: the second half of pass BD, on its walk (pass_walk.cuh). One
// block per query tile with the window's GR rows 0-17 in shared memory at
// a pitch of whole 32-column words, one thread a query. The class and the
// edge direction are inputs, so one accumulation is all there is: per
// chunk of 16 words, a branch-free scan against rk_step alone into bit
// words, then the lane's set bits from the lowest up in one flat loop,
// one loop a step kind (step_pass), so only the selected step's sums are
// taken, in ascending column order: the numbers are those of one walk
// over all columns. The accumulators of the widest step (new: 25) stay in
// registers. The distances must match the plain version bit for bit, so
// there is no wgmma here (walk_common.cuh).
//
// Measured at 1M points, tile 256, 512 columns (kernel_lab.py, NVIDIA H100
// 80GB HBM3 at 700 W, one call): 0.40 ms a launch where one walk over all
// columns with an early `continue` took 1.37 ms. The scan takes ~0.22 ms,
// the accumulation ~0.08 ms, the per-point math and the 3 rows 0.06 ms,
// staging 0.03 ms. K2's word skip gained nothing (0.406 ms with, 0.403
// without, and more spills) and is not used. ptxas: three blocks of 256
// threads an SM, 80 registers, 12 bytes spilled; two blocks (116
// registers) take 0.46 ms, four (64 registers, 40 bytes spilled) 0.45 ms.
#include "pass_walk.cuh"

namespace ngpd {

constexpr int D_MIN_BLOCKS = 3;  // blocks an SM

__global__ void __launch_bounds__(256, D_MIN_BLOCKS)
pass_d_kernel(const float* __restrict__ gq, const float* __restrict__ gr,
              const float* __restrict__ cls, const float* __restrict__ scal,
              const int* __restrict__ starts, float* __restrict__ out, int n,
              int nv, int tile, int wt, int wp, StepArgs args) {
  // D_ROWS rows of wp, then one chunk's bit words, one a (word, thread).
  extern __shared__ __align__(16) float sm[];
  unsigned* cbits = reinterpret_cast<unsigned*>(sm + D_ROWS * wp) + threadIdx.x;
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_rows_pitched<D_ROWS>(gr, n, s, wt, wp, sm);
  __syncthreads();
  const float d_thr = scal[0];

  const int jmax = min(wt, nv - s);  // columns past nv are masked
  const int nwords = jmax > 0 ? (jmax + 31) >> 5 : 0;
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int i = blk * tile + r;
    const float p[3] = {gq[i], gq[n + i], gq[2 * n + i]};
    const float qq = gq[Q_PP * n + i];
    const float thr_s = mask_threshold(gq[Q_RKS * n + i]);
    const float c_i = cls[i];
    const int cid = c_i == 0.0f ? 0 : (c_i == 1.0f ? 1 : 2);
    const int kind = args.kind[cid];
    if (kind == DUMMY) {
      for (int c = 0; c < 3; ++c) out[c * n + i] = p[c];
      continue;
    }
    const float nrm[3] = {gq[Q_N * n + i], gq[(Q_N + 1) * n + i], gq[(Q_N + 2) * n + i]};
    const float y[3] = {cls[n + i], cls[2 * n + i], cls[3 * n + i]};
    const float none[3] = {0.f, 0.f, 0.f};
    StepSums sums{};  // every sum 0
    float mx = 0.0f;
    const float d2 = step_d2(scal, args, cid, kind);
    step_pass_of<false>(kind, sm, wp, nwords, jmax, nullptr, cbits, p, qq, thr_s, nrm, y, d2,
                        false, none, 0.0f, sums, mx);
    float res[3];
    step_result(kind, sums, p, nrm, y, args.alpha[cid], d_thr, res);
    for (int c = 0; c < 3; ++c) out[c * n + i] = res[c];
  }
}

static void d_allow(size_t smem) {
  static size_t allowed = 0;
  allow_smem(pass_d_kernel, smem, allowed);
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
  const size_t smem = walk_smem(tile, wt, false);
  d_allow(smem);
  pass_d_kernel<<<n / tile, pass_threads(tile), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gq), static_cast<const float*>(gr),
      static_cast<const float*>(cls), static_cast<const float*>(scal),
      static_cast<const int*>(starts), static_cast<float*>(out), n, nv, tile,
      wt, round_up32(wt), args);
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds at this geometry, as the runtime
// counts them from its registers and shared memory.
extern "C" int ngpd_pass_d_blocks_per_sm(int tile, int wt) {
  using namespace ngpd;
  int blocks = 0;
  const size_t smem = walk_smem(tile, wt, false);
  d_allow(smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pass_d_kernel,
                                                pass_threads(tile), smem);
  return blocks;
}
