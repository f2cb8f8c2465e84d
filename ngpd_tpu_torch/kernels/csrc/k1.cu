// K1, filtered NVT1 of the hybrid denoise: per point i, over the window
// columns j with d_ij <= rk_feat_i, keep those whose normal is at an
// angle to the offset, |n_j.(p_j - p_i)| / |p_j - p_i| < cos(angle), and
// fall back to all of them where none is kept (the zero-weight rescue);
// output the six sums of n_j n_j^T over the kept count.
//
// Replaces: ngpd_tpu/core/pallas_fused.py, _make_k1 (the pallas_call in
// pallas_denoise_hybrid). Output pack (8, n): t6 rows 0-5, rows 6-7 zero.
//
// What bounds it on the H100: operations. Every (query, column) pair
// needs its distance and threshold test; the ~feature_k columns that
// pass add the angle test and twelve sums. Traffic is 64 bytes a point.
//
// Design: one block per query tile stages the window's p, n, |p|^2 and
// p.n (8 rows) in shared memory; one thread per query walks the window
// columns, so the 32 threads of a warp read the same column at once (a
// shared-memory broadcast). The filtered and the plain sums are both
// kept in registers in the same pass and one is picked at the end.
#include "window_common.cuh"

namespace ngpd {

__global__ void k1_kernel(const float* __restrict__ pack,
                          const int* __restrict__ starts,
                          float* __restrict__ out, int n, int nv, int tile,
                          int wt_c, float cos_rho) {
  extern __shared__ float sm[];  // W_ROWS rows of wt_c
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_window<W_ROWS>(pack, n, s, wt_c, sm);
  __syncthreads();

  const int jmax = min(wt_c, nv - s);  // columns past nv are masked
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int i = blk * tile + r;
    const float q0 = pack[i], q1 = pack[n + i], q2 = pack[2 * n + i];
    const float rkf = pack[6 * n + i];
    const float p2q = sq_norm3(q0, q1, q2);
    float kept[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float all[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float n_kept = 0.0f, n_all = 0.0f;
    for (int j = 0; j < jmax; ++j) {
      const float d =
          sq_dist(q0, q1, q2, p2q, sm[W_PX * wt_c + j], sm[W_PY * wt_c + j],
                  sm[W_PZ * wt_c + j], sm[W_PP * wt_c + j]);
      if (!(d <= rkf && d < 1e30f)) continue;
      const float n0 = sm[W_NX * wt_c + j], n1 = sm[W_NY * wt_c + j],
                  n2 = sm[W_NZ * wt_c + j];
      const float sym[6] = {__fmul_rn(n0, n0), __fmul_rn(n0, n1),
                            __fmul_rn(n0, n2), __fmul_rn(n1, n1),
                            __fmul_rn(n1, n2), __fmul_rn(n2, n2)};
#pragma unroll
      for (int c = 0; c < 6; ++c) all[c] = __fadd_rn(all[c], sym[c]);
      n_all = __fadd_rn(n_all, 1.0f);
      const float dotj =
          __fsub_rn(sm[W_PN * wt_c + j], dot3(q0, q1, q2, n0, n1, n2));
      if (keeps_angle(dotj, d, cos_rho)) {
#pragma unroll
        for (int c = 0; c < 6; ++c) kept[c] = __fadd_rn(kept[c], sym[c]);
        n_kept = __fadd_rn(n_kept, 1.0f);
      }
    }
    const bool rescue = n_kept == 0.0f;
    const float wsum = fmaxf(rescue ? n_all : n_kept, 1.0f);
#pragma unroll
    for (int c = 0; c < 6; ++c)
      out[c * n + i] = __fdiv_rn(rescue ? all[c] : kept[c], wsum);
    out[6 * n + i] = 0.0f;
    out[7 * n + i] = 0.0f;
  }
}

}  // namespace ngpd

// pack: (8, n) slim pack [p, n, rk_feat, rk_step]; starts: (n / tile,)
// int32 window starts; out: (8, n).
extern "C" int ngpd_k1_launch(const void* pack, const void* starts, void* out,
                              int n, int nv, int tile, int wt_c, float cos_rho,
                              void* stream) {
  using namespace ngpd;
  const size_t smem = sizeof(float) * W_ROWS * (size_t)wt_c;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const int threads = tile < 256 ? tile : 256;
  k1_kernel<<<n / tile, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pack), static_cast<const int*>(starts),
      static_cast<float*>(out), n, nv, tile, wt_c, cos_rho);
  return (int)cudaGetLastError();
}
