// The dense pipeline's classify: per point, the second filtered normal
// voting tensor over its feature neighbours' smoothed normals f_n, its
// eigenpairs, the class and the edge direction (the smallest eigenvalue's
// eigenvector); and per block, for each class whose step needs a delta
// (flat, new), the partial sums of its centre. One thread a point.
//
// Replaces: no TPU kernel; the reference is the XLA program of
// ngpd_tpu/core/pipeline.py::denoise_iteration (the second
// voting.better_filtered_nvt, voting.classes, the centre sums of
// _class_delta). Its plain versions are those of ngpd_tpu_torch/core/
// voting.py and core/pipeline.py::_class_delta, which the CPU runs.
//
// Partials (12, blocks): rows 4c .. 4c + 2 the sums of the step
// neighbours' positions over the valid slots of class c's points in the
// block, row 4c + 3 their count; rows of classes outside dmask are left
// unwritten. Each point sums its slots in order, the block in a fixed
// order (block_reduce), so a rerun gives the same bits; dense_sums.cu
// sums the blocks.
//
// What bounds it on the H100: as dense_vote.cu, bytes then latency: 10.6
// MB read once at 32,768 points and k 32 (3.2 us), the step neighbours'
// rows for the partials from L2. Design: one thread a point in PyTorch's
// summation order (dense_common.cuh), so the classes and edge directions
// equal the eager stage's bit for bit. No wgmma: no product of matrices.
#include "dense_common.cuh"

namespace ngpd {
namespace dense {

__global__ void __launch_bounds__(THREADS)
dense_classify_kernel(const float* __restrict__ pts, const float* __restrict__ src_pts,
                      const float* __restrict__ src_f_n, const int64_t* __restrict__ idx,
                      const bool* __restrict__ mask, int k,
                      const int64_t* __restrict__ idx_s, const bool* __restrict__ mask_s,
                      int ks, int n, float rho, float class_scale, int dmask,
                      int* __restrict__ cls_out, float* __restrict__ edge,
                      float* __restrict__ parts) {
  __shared__ float red[THREADS / 32];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int cls = -1;
  if (i < n) {
    float t6[6], w[3], v[3][3];
    filtered_nvt(pts, src_pts, src_f_n, idx, mask, k, i, rho, t6);
    eigh3<true>(t6, w, v);
    cls = (int)classify(w, class_scale);
    cls_out[i] = cls;
    for (int c = 0; c < 3; ++c) edge[3 * (int64_t)i + c] = v[0][c];
  }
  if (dmask == 0) return;  // the same in every thread: no block_reduce below
  const int blocks = gridDim.x;
  for (int c = 0; c < 3; ++c) {
    if (!((dmask >> c) & 1)) continue;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (cls == c) {
      const int64_t* row = idx_s + (int64_t)i * ks;
      const bool* valid = mask_s + (int64_t)i * ks;
      for (int e = 0; e < ks; ++e) {
        if (!valid[e]) continue;
        float vj[3];
        load3(src_pts, row[e], vj);
        for (int q = 0; q < 3; ++q) acc[q] = fadd(acc[q], vj[q]);
        acc[3] = fadd(acc[3], 1.0f);
      }
    }
    for (int q = 0; q < 4; ++q) {
      const float tot = block_reduce(acc[q], false, red);
      if (threadIdx.x == 0) parts[(int64_t)(4 * c + q) * blocks + blockIdx.x] = tot;
    }
  }
}

}  // namespace dense
}  // namespace ngpd

// pts: the query rows (n, 3) float32; src_pts, src_f_n: the rows (m, 3)
// of positions and smoothed normals that the indices name; idx, mask: the
// feature neighbourhood (n, k); idx_s, mask_s: the step neighbourhood (n,
// ks); dmask: bit c set where class c's step needs a delta; cls_out: (n,)
// int32; edge: (n, 3); parts: (12, ceil(n / 128)).
extern "C" int ngpd_dense_classify_launch(const void* pts, const void* src_pts,
                                          const void* src_f_n, const void* idx,
                                          const void* mask, int k, const void* idx_s,
                                          const void* mask_s, int ks, int n, float rho,
                                          float class_scale, int dmask, void* cls_out,
                                          void* edge, void* parts, void* stream) {
  using namespace ngpd::dense;
  if (n <= 0) return 0;
  dense_classify_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float*>(src_pts),
      static_cast<const float*>(src_f_n), static_cast<const int64_t*>(idx),
      static_cast<const bool*>(mask), k,
      static_cast<const int64_t*>(idx_s), static_cast<const bool*>(mask_s), ks, n, rho,
      class_scale, dmask, static_cast<int*>(cls_out), static_cast<float*>(edge),
      static_cast<float*>(parts));
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds, as the runtime counts them.
extern "C" int ngpd_dense_classify_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ngpd::dense::dense_classify_kernel,
                                                ngpd::dense::THREADS, 0);
  return blocks;
}
