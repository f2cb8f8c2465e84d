// The dense pipeline's class centre sums: dense_classify.cu's per-block
// partials (12, blocks) summed over the blocks into the 12 sums of the
// classes whose step needs a delta (flat, new). One block; a warp a row.
//
// Replaces: no TPU kernel; the reference is the XLA program of
// ngpd_tpu/core/pipeline.py::_class_delta (the sums before its centre).
// Its plain version is ngpd_tpu_torch/core/pipeline.py::_class_delta,
// which the CPU runs.
//
// Lane l of a row's warp sums the blocks l, l + 32, ... in order, then the
// warp's shuffle tree (offsets 16 .. 1): a fixed order, so a rerun gives
// the same bits, but not the eager stage's single sum over all points, so
// a sum may differ from it by its rounding. Rows of classes outside dmask
// are written 0. On a rank of the sharded pipeline the 12 sums are then
// all-reduced before dense_delta.cu reads them.
//
// What bounds it on the H100: latency. It reads 12 x blocks floats once
// (12 KB at 32,768 points, 375 KB at 1M) and writes 48 bytes; one block
// suffices, so each point's delta kernel reads 12 sums, not the partials.
// No wgmma: no product of matrices.
#include "dense_common.cuh"

namespace ngpd {
namespace dense {

constexpr int SUM_THREADS = 12 * 32;

__global__ void __launch_bounds__(SUM_THREADS)
dense_sums_kernel(const float* __restrict__ parts, int blocks, int dmask,
                  float* __restrict__ sums) {
  const int r = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (!((dmask >> (r / 4)) & 1)) {  // the same in the whole warp
    if (lane == 0) sums[r] = 0.0f;
    return;
  }
  const float* row = parts + (int64_t)r * blocks;
  float s = 0.0f;
  for (int b = lane; b < blocks; b += 32) s = fadd(s, row[b]);
  for (int o = 16; o > 0; o >>= 1) s = fadd(s, __shfl_down_sync(0xffffffffu, s, o));
  if (lane == 0) sums[r] = s;
}

}  // namespace dense
}  // namespace ngpd

// parts: dense_classify's (12, blocks) float32; dmask: bit c set where
// class c needs a delta; sums: (12,) float32.
extern "C" int ngpd_dense_sums_launch(const void* parts, int blocks, int dmask, void* sums,
                                      void* stream) {
  using namespace ngpd::dense;
  dense_sums_kernel<<<1, SUM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(parts), blocks, dmask, static_cast<float*>(sums));
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds, as the runtime counts them.
extern "C" int ngpd_dense_sums_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ngpd::dense::dense_sums_kernel,
                                                ngpd::dense::SUM_THREADS, 0);
  return blocks;
}
