// Pass A of the four-pass denoise: per point, the filtered NVT1 over the
// window columns with d <= rk_feat (angle filter, zero-weight rescue),
// its eigendecomposition with the polynomial acos, VU smoothing of the
// normal, and the next stage's packs: GQ2 is GQ with the normals replaced
// by the smoothed ones f, GR2 is rebuilt from p and f (p.f, sym6(f)).
//
// Replaces: ngpd_tpu/core/pallas_fused.py:232, _make_pass_a (the
// pallas_call at l.933 in pallas_denoise).
//
// What bounds it on the H100: bytes and operations about equally. It
// reads and writes the 40-row packs (320 bytes a point); every (query,
// column) pair needs its distance and threshold test, the ~feature_k
// pairs that pass the angle test and twelve sums, and each point one
// eigendecomposition (~300 operations, an acos polynomial and two cosf).
//
// Design: as K1, one block per query tile stages the window's GR rows
// 0-14 (distance rows, n, p.n, sym6) in shared memory and one thread per
// query walks the window, so a warp reads one column at a time (a
// broadcast); the filtered and the plain sums are kept together and one
// is picked at the end. The eigensolver and the VU filter run in
// registers (passes_common.cuh) and the thread writes its point's 40
// output rows.
#include "passes_common.cuh"

namespace ngpd {

constexpr int A_ROWS = R_SYM + 6;

__global__ void pass_a_kernel(const float* __restrict__ gq,
                              const float* __restrict__ gr,
                              const int* __restrict__ starts,
                              float* __restrict__ gq2, float* __restrict__ gr2,
                              int n, int nv, int tile, int wt, float cos_rho,
                              float tau, float damping) {
  extern __shared__ float sm[];  // A_ROWS rows of wt
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_rows(gr, n, s, wt, A_ROWS, sm);
  __syncthreads();

  const int jmax = min(wt, nv - s);  // columns past nv are masked
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const size_t i = (size_t)blk * tile + r;
    float row[GQ_ROWS];
#pragma unroll
    for (int k = 0; k < GQ_ROWS; ++k) row[k] = gq[k * (size_t)n + i];
    const float q[3] = {row[0], row[1], row[2]};
    float t6[6], w[3], v[3][3], f[3];
    nvt_t6(sm, wt, jmax, q, row[Q_PP], row[Q_RKF], cos_rho, t6);
    eigh3(t6, w, v);
    const float nrm[3] = {row[Q_N], row[Q_N + 1], row[Q_N + 2]};
    vu_smooth(w, v, nrm, tau, damping, f);

#pragma unroll
    for (int k = 0; k < GQ_ROWS; ++k)
      gq2[k * (size_t)n + i] = (k >= Q_N && k < Q_N + 3) ? f[k - Q_N] : row[k];
    const float out[GR_ROWS] = {
        fmul(-2.0f, q[0]), fmul(-2.0f, q[1]), fmul(-2.0f, q[2]),
        row[Q_PP], row[Q_ONE], f[0], f[1], f[2], dot(q, f),
        fmul(f[0], f[0]), fmul(f[0], f[1]), fmul(f[0], f[2]),
        fmul(f[1], f[1]), fmul(f[1], f[2]), fmul(f[2], f[2]),
        q[0], q[1], q[2], 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < GR_ROWS; ++k) gr2[k * (size_t)n + i] = out[k];
  }
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
  const size_t smem = prepare_launch(pass_a_kernel, A_ROWS, wt);
  pass_a_kernel<<<n / tile, pass_threads(tile), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gq), static_cast<const float*>(gr),
      static_cast<const int*>(starts), static_cast<float*>(gq2),
      static_cast<float*>(gr2), n, nv, tile, wt, cos_rho, tau, damping);
  return (int)cudaGetLastError();
}
