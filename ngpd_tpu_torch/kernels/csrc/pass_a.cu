// Pass A of the four-pass denoise: per point, the filtered NVT1 over the
// window columns with d <= rk_feat (angle filter, zero-weight rescue),
// its eigendecomposition with the polynomial acos, VU smoothing of the
// normal, and the next stage's packs: GQ2 is GQ with the normals replaced
// by the smoothed ones f, GR2 is rebuilt from p and f (p.f, sym6(f)).
//
// Replaces: ngpd_tpu/core/pallas_fused.py:232, _make_pass_a (the
// pallas_call at l.933 in pallas_denoise).
//
// What bounds it on the H100: operations. Every (query, column) pair
// needs its distance and threshold test, the ~feature_k pairs that pass
// the angle test and twelve sums, and each point one eigendecomposition
// (~300 operations, an acos polynomial and two cosf) and the VU filter;
// it reads GQ and 15 GR rows and writes the 40-row packs (284 bytes a
// point).
//
// Design: pass B's first walk (pass_walk.cuh). One block per query tile
// stages the window's GR rows 0-14 (distance rows, n, p.n, sym6) in shared
// memory at a pitch of whole 32-column words, one thread a query. Per
// chunk of 16 words, a branch-free scan against rk_feat alone into bit
// words, then the lane's set bits from the lowest up in one flat loop into
// the NVT sums (nvt_pass), so they are taken over the query's passing
// columns in ascending column order: the numbers of one walk over all
// columns with an early `continue`. The eigensolver and the VU filter run
// in registers (passes_common.cuh) and the thread writes its point's 40
// output rows. The distances must match the plain version bit for bit, so
// there is no wgmma here (walk_common.cuh).
//
// Measured at 1M points, tile 256, 512 columns (kernel_lab.py, NVIDIA H100
// 80GB HBM3 at 700 W, one call): 0.49 ms a launch where one walk over all
// columns with an early `continue` took 1.01 ms. The scan takes ~0.17 ms,
// the accumulation ~0.16 ms, the eigensolver, the VU filter and the 40 rows
// 0.13 ms, staging 0.025 ms; staging 18 rows six at a time instead of the
// 15 read changes nothing (0.489 ms both). ptxas: three blocks of 256
// threads an SM, 80 registers, no spill; two blocks (96 registers) take
// 0.54 ms, four (64 registers, 8 bytes spilled) 0.486 ms.
#include "pass_walk.cuh"

namespace ngpd {

constexpr int A_MIN_BLOCKS = 3;  // blocks an SM
constexpr int A_ROWS = R_SYM + 6;  // GR rows 0-14 are read

__global__ void __launch_bounds__(256, A_MIN_BLOCKS)
pass_a_kernel(const float* __restrict__ gq, const float* __restrict__ gr,
              const int* __restrict__ starts, float* __restrict__ gq2,
              float* __restrict__ gr2, int n, int nv, int tile, int wt, int wp,
              float cos_rho, float tau, float damping) {
  // A_ROWS rows of wp, then one chunk's bit words, one a (word, thread).
  extern __shared__ __align__(16) float sm[];
  unsigned* cbits = reinterpret_cast<unsigned*>(sm + A_ROWS * wp) + threadIdx.x;
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_rows_pitched<A_ROWS>(gr, n, s, wt, wp, sm);
  __syncthreads();

  const int jmax = min(wt, nv - s);  // columns past nv are masked
  const int nwords = jmax > 0 ? (jmax + 31) >> 5 : 0;
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const size_t i = (size_t)blk * tile + r;
    const float q[3] = {gq[i], gq[n + i], gq[2 * n + i]};
    const float qq = gq[Q_PP * n + i];
    const float thr_f = mask_threshold(gq[Q_RKF * n + i]);
    const NvtSums nvt =
        nvt_pass<false>(sm, wp, nwords, jmax, nullptr, cbits, q, qq, thr_f, 0.0f, cos_rho);
    float t6[6], w[3], v[3][3], f[3];
    nvt_mean(nvt, t6);
    eigh3(t6, w, v);
    const float nrm[3] = {gq[Q_N * n + i], gq[(Q_N + 1) * n + i], gq[(Q_N + 2) * n + i]};
    vu_smooth(w, v, nrm, tau, damping, f);

#pragma unroll
    for (int k = 0; k < GQ_ROWS; ++k)
      gq2[k * (size_t)n + i] = (k >= Q_N && k < Q_N + 3) ? f[k - Q_N] : gq[k * (size_t)n + i];
    const float one = gq[Q_ONE * (size_t)n + i];
    const float out[GR_ROWS] = {
        fmul(-2.0f, q[0]), fmul(-2.0f, q[1]), fmul(-2.0f, q[2]),
        qq, one, f[0], f[1], f[2], dot(q, f),
        fmul(f[0], f[0]), fmul(f[0], f[1]), fmul(f[0], f[2]),
        fmul(f[1], f[1]), fmul(f[1], f[2]), fmul(f[2], f[2]),
        q[0], q[1], q[2], 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < GR_ROWS; ++k) gr2[k * (size_t)n + i] = out[k];
  }
}

static void a_allow(size_t smem) {
  static size_t allowed = 0;
  allow_smem(pass_a_kernel, smem, allowed);
}

}  // namespace ngpd

// gq: (16, n), gr: (24, n) packs; starts: (n / tile,) int32 window
// starts; gq2: (16, n), gr2: (24, n) outputs.
extern "C" int ngpd_pass_a_launch(const void* gq, const void* gr,
                                  const void* starts, void* gq2, void* gr2,
                                  int n, int nv, int tile, int wt,
                                  float cos_rho, float tau, float damping,
                                  void* stream) {
  using namespace ngpd;
  const size_t smem = walk_smem(tile, wt, false, A_ROWS);
  a_allow(smem);
  pass_a_kernel<<<n / tile, pass_threads(tile), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gq), static_cast<const float*>(gr),
      static_cast<const int*>(starts), static_cast<float*>(gq2),
      static_cast<float*>(gr2), n, nv, tile, wt, round_up32(wt), cos_rho, tau,
      damping);
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds at this geometry, as the runtime
// counts them from its registers and shared memory.
extern "C" int ngpd_pass_a_blocks_per_sm(int tile, int wt) {
  using namespace ngpd;
  int blocks = 0;
  const size_t smem = walk_smem(tile, wt, false, A_ROWS);
  a_allow(smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pass_a_kernel,
                                                pass_threads(tile), smem);
  return blocks;
}
