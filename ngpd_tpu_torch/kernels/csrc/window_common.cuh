// Shared pieces of the window kernels K0/K1/K2 (CUDA C++ for sm_90a).
//
// Geometry, identical to ngpd_tpu/core/pallas_fused.py:1527-1549: the
// padded cloud has n points in Morton order; query block b (one CUDA
// block) holds the `tile` queries [b*tile, (b+1)*tile) and reads the
// window columns [sub_starts[b], sub_starts[b] + wt_c). Columns at or
// past nv (the count of real points) are masked. The TPU kernels DMA a
// window shared by `sub` tiles; here every block stages its own window
// in shared memory, which reads the same columns.
//
// Numerics: the squared distance is max(|q|^2 + |p|^2 - 2 q.p, 0),
// summed in the order of the reference's 5-row contraction
// [q, 1, |q|^2] . [-2p, |p|^2, 1], with every product and sum rounded
// on its own (__fmul_rn/__fadd_rn; the sources are also built with
// -fmad=false), so that the threshold masks agree with the plain
// PyTorch version bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace ngpd {

// Stage pack columns [s, s + wt_c) into four shared-memory rows of wt_c
// floats: p0, p1, p2 and |p|^2 (K0's window).
__device__ __forceinline__ void stage_window(const float* __restrict__ pack,
                                             int n, int s, int wt_c,
                                             float* sm) {
  for (int j = threadIdx.x; j < wt_c; j += blockDim.x) {
    const int c = s + j;
    const float p0 = pack[c], p1 = pack[n + c], p2 = pack[2 * n + c];
    sm[j] = p0;
    sm[wt_c + j] = p1;
    sm[2 * wt_c + j] = p2;
    sm[3 * wt_c + j] =
        __fadd_rn(__fadd_rn(__fmul_rn(p0, p0), __fmul_rn(p1, p1)),
                  __fmul_rn(p2, p2));
  }
}

__device__ __forceinline__ float sq_norm3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                   __fmul_rn(c, c));
}

__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// max(|q|^2 + |p|^2 - 2 q.p, 0) in the reference's contraction order.
__device__ __forceinline__ float sq_dist(float q0, float q1, float q2,
                                         float p2q, float p0, float p1,
                                         float p2, float p2w) {
  float d = __fmul_rn(q0, -2.0f * p0);
  d = __fadd_rn(d, __fmul_rn(q1, -2.0f * p1));
  d = __fadd_rn(d, __fmul_rn(q2, -2.0f * p2));
  d = __fadd_rn(d, p2w);
  d = __fadd_rn(d, p2q);
  return fmaxf(d, 0.0f);
}

// |n_j.(p_j - p_i)| / |p_j - p_i| < cos(angle), as the reference's
// num * rsqrt(max(d, 1e-24)) with a correctly rounded 1/sqrt.
__device__ __forceinline__ bool keeps_angle(float dotj, float d,
                                            float cos_rho) {
  const float inv = __fdiv_rn(1.0f, __fsqrt_rn(fmaxf(d, 1e-24f)));
  return __fmul_rn(fabsf(dotj), inv) < cos_rho;
}

}  // namespace ngpd
