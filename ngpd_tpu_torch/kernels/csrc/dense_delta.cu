// The dense pipeline's class deltas: for each class whose step needs one
// (flat, new), the largest distance of its points' valid step neighbours
// from their centre, as per-block maxima. One thread a point.
//
// Replaces: no TPU kernel; the reference is the XLA program of
// ngpd_tpu/core/pipeline.py::_class_delta. Its plain version is
// ngpd_tpu_torch/core/pipeline.py::_class_delta, which the CPU runs.
//
// Every block turns dense_sums.cu's 12 sums into the centres (the same
// bits in every block), then each of its points of such a class takes the
// largest norm of (p_j - centre) over its valid slots (torch.linalg.norm's
// order, dense_common.cuh), and the block writes the largest of its points
// (0 where it has none) to column blockIdx.x of deltas (3, blocks); rows
// of classes outside dmask are written 0. The maximum is order-free, so
// dense_update.cu's maximum of a row is exact; the centre's sums run in
// another order than the eager stage's single sum over all points, so a
// delta may differ from it by a few ulps.
//
// What bounds it on the H100: latency. 32,768 points read 8 step
// neighbours each from L2; a block reads 12 sums. No wgmma: no product of
// matrices.
#include "dense_common.cuh"

namespace ngpd {
namespace dense {

__global__ void __launch_bounds__(THREADS)
dense_delta_kernel(const float* __restrict__ src_pts, const int64_t* __restrict__ idx,
                   const bool* __restrict__ mask, int k, const int* __restrict__ cls,
                   const float* __restrict__ sums, int n, int dmask,
                   float* __restrict__ deltas) {
  __shared__ float centre[3][3];
  __shared__ float red[THREADS / 32];
  const int t = threadIdx.x;
  if (t < 9 && ((dmask >> (t / 3)) & 1))
    centre[t / 3][t % 3] = fdiv(sums[4 * (t / 3) + t % 3], clamp_min(sums[4 * (t / 3) + 3], 1.0f));
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = i < n ? cls[i] : -1;
  const bool mine = c >= 0 && c < 3 && ((dmask >> c) & 1);
  float far = 0.0f;
  if (mine) {
    const int64_t* row = idx + (int64_t)i * k;
    const bool* valid = mask + (int64_t)i * k;
    for (int e = 0; e < k; ++e) {
      if (!valid[e]) continue;
      float d[3];
      load3(src_pts, row[e], d);
      for (int q = 0; q < 3; ++q) d[q] = fsub(d[q], centre[c][q]);
      far = fmaxf(far, norm3(d));
    }
  }
  for (int cc = 0; cc < 3; ++cc) {
    const bool taken = (dmask >> cc) & 1;  // the same in every thread
    const float tot = taken ? block_reduce(c == cc ? far : 0.0f, true, red) : 0.0f;
    if (t == 0) deltas[(int64_t)cc * gridDim.x + blockIdx.x] = tot;
  }
}

}  // namespace dense
}  // namespace ngpd

// src_pts: the rows (m, 3) float32 that idx names (the positions on one
// device); idx, mask: the step neighbourhood (n, k); cls: (n,) int32;
// sums: dense_sums's (12,); dmask: bit c set where class c needs a delta;
// deltas: (3, ceil(n / 128)).
extern "C" int ngpd_dense_delta_launch(const void* src_pts, const void* idx, const void* mask,
                                       int k, const void* cls, const void* sums, int n,
                                       int dmask, void* deltas, void* stream) {
  using namespace ngpd::dense;
  if (n <= 0) return 0;
  dense_delta_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src_pts), static_cast<const int64_t*>(idx),
      static_cast<const bool*>(mask), k, static_cast<const int*>(cls),
      static_cast<const float*>(sums), n, dmask, static_cast<float*>(deltas));
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds, as the runtime counts them.
extern "C" int ngpd_dense_delta_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ngpd::dense::dense_delta_kernel,
                                                ngpd::dense::THREADS, 0);
  return blocks;
}
