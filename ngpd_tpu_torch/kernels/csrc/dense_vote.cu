// The dense pipeline's vote: per point, the first filtered normal voting
// tensor over its feature neighbours, its eigenpairs and the VU-smoothed
// normal f_n, one thread a point.
//
// Replaces: no TPU kernel; the reference is the XLA program of
// ngpd_tpu/core/pipeline.py::denoise_iteration (voting.better_filtered_nvt,
// then voting.vu_smoothed_normals). Its plain version is the same pair in
// ngpd_tpu_torch/core/voting.py, which the CPU runs; eagerly on the card it
// is some 170 kernels of one operation each. It is a launch of its own
// because the second tensor (dense_classify.cu) reads the neighbours' f_n.
//
// What bounds it on the H100: bytes, then latency. A point reads its own
// position, k neighbour indices (8 bytes) and mask bytes, and per
// neighbour a position and a normal, and writes f_n: at 32,768 points and
// k 32 the rows read once are 10.6 MB, 3.2 us of traffic; the neighbour
// rows (0.8 MB of positions and normals) stay in L2, so the 1M gathers
// cost L2 latency, not HBM bytes. The operations, about 60 a neighbour
// with an acosf and two square roots, take ~1 us at the fp32 rate.
//
// Design: one thread a point, its neighbours summed in PyTorch's order
// (dense_common.cuh), so f_n equals the eager stage's bit for bit; a
// warp a point with a shuffle tree over the neighbours would hide more
// latency but sum in another order. 128 threads a block spread the 256
// blocks of the cell's cloud over the 132 SMs. The tensor cores have
// nothing to do here (no product of matrices), so no wgmma.
#include "dense_common.cuh"

namespace ngpd {
namespace dense {

// core/voting.py::vu_smoothed_normals from the eigenpairs (w ascending,
// v[i] the eigenvector of w[i]): the columns in descending order, each
// projection e_i . n summed over the column (sum3_serial), the kept
// projections summed over the eigenvectors (sum3), then
// normalize(damping n + that).
__device__ __forceinline__ void vu_dense(const float w[3], const float v[3][3],
                                         const float n[3], float tau, float damping,
                                         float f[3]) {
  float kp[3];  // column i of the flipped eigenvectors is v[2 - i]
  for (int i = 0; i < 3; ++i) {
    const float* e = v[2 - i];
    const float proj = sum3_serial(fmul(e[0], n[0]), fmul(e[1], n[1]), fmul(e[2], n[2]));
    kp[i] = fmul(w[2 - i] > tau ? 1.0f : 0.0f, proj);
  }
  for (int r = 0; r < 3; ++r) {
    const float contrib =
        sum3(fmul(kp[0], v[2][r]), fmul(kp[1], v[1][r]), fmul(kp[2], v[0][r]));
    f[r] = fadd(fmul(damping, n[r]), contrib);
  }
  normalize3(f);
}

__global__ void __launch_bounds__(THREADS)
dense_vote_kernel(const float* __restrict__ pts, const float* __restrict__ nrm,
                  const float* __restrict__ src_pts, const float* __restrict__ src_nrm,
                  const int64_t* __restrict__ idx, const bool* __restrict__ mask, int n,
                  int k, float rho, float tau, float damping, float* __restrict__ f_n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t6[6], w[3], v[3][3], own[3], f[3];
  filtered_nvt(pts, src_pts, src_nrm, idx, mask, k, i, rho, t6);
  eigh3<true>(t6, w, v);
  load3(nrm, i, own);
  vu_dense(w, v, own, tau, damping, f);
  for (int c = 0; c < 3; ++c) f_n[3 * (int64_t)i + c] = f[c];
}

}  // namespace dense
}  // namespace ngpd

// pts, nrm: the query rows (n, 3) float32; src_pts, src_nrm: the rows
// (m, 3) that idx names (pts and nrm on one device); idx: (n, k) int64;
// mask: (n, k) bool; f_n: (n, 3), a buffer of its own; rho the angle
// threshold; tau, damping the VU smoothing's.
extern "C" int ngpd_dense_vote_launch(const void* pts, const void* nrm, const void* src_pts,
                                      const void* src_nrm, const void* idx, const void* mask,
                                      int n, int k, float rho, float tau, float damping,
                                      void* f_n, void* stream) {
  using namespace ngpd::dense;
  if (n <= 0) return 0;
  dense_vote_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(nrm),
      static_cast<const float*>(src_pts), static_cast<const float*>(src_nrm),
      static_cast<const int64_t*>(idx), static_cast<const bool*>(mask), n, k, rho, tau,
      damping, static_cast<float*>(f_n));
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds, as the runtime counts them.
extern "C" int ngpd_dense_vote_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ngpd::dense::dense_vote_kernel,
                                                ngpd::dense::THREADS, 0);
  return blocks;
}
