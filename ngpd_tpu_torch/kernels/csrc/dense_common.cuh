// Shared pieces of the dense pipeline's stage kernels (CUDA C++ for sm_90a):
// dense_vote.cu, dense_classify.cu, dense_delta.cu and dense_update.cu.
//
// Why they exist: no TPU kernel lies on this path, but eagerly an
// iteration of core/pipeline.py::denoise_iteration launched some 1,100
// kernels of one operation each, and the card waited on the host between
// them (80% idle in the 32,768-point dense cell). Four launches do the
// same work.
//
// Operands, as core/pipeline.py::denoise_iteration holds them: the query
// rows' positions and normals (n, 3) row-major float32; a neighbourhood as
// idx (n, k) int64 and mask (n, k) bool, row-major, whose indices name rows
// of the source arrays (m, 3): the query arrays themselves on one device,
// the whole cloud's on a rank of the sharded pipeline. One thread a point.
//
// Numerics: the kernels compute what the eager stages compute on the card,
// bit for bit. Every product and sum is rounded on its own (fadd, fmul; the
// sources are built with -fmad=false), and every sum that PyTorch's CUDA
// reduction kernel takes runs in that kernel's order (ATen's Reduce.cuh,
// checked on the H100 against torch.sum):
//   - a sum over the neighbour axis of an (n, k, ...) tensor, the axis not
//     innermost (axis_sum): four accumulators, element e into accumulator
//     e mod 4, then ((a0 + a1) + a2) + a3;
//   - a sum over an innermost axis of three (sum3, norm3): two lanes, the
//     first holding elements 0 and 2, so (x0 + x2) + x1;
//   - a sum over the innermost neighbour axis of an (n, k) tensor, k up to
//     MAX_K (row_sum): lanes L = min(last power of two <= k, 32), lane l
//     summing elements l + m L as above, then a shuffle tree with offsets
//     L/2 .. 1;
//   - a sum over an axis of three that is not innermost (sum3_serial):
//     (x0 + x1) + x2;
//   - torch.einsum('...ij,...j->...i') of a 3x3 by a 3-vector, which runs
//     as cuBLAS's batched GEMM (bmm_row): fma(a2, b2, a0 b0) + a1 b1.
// The eigensolver is passes_common.cuh's eigh3<true> (acosf, x / 3.0 as a
// product with the float32 reciprocal), as the hybrid's stage kernels use
// it. Only the class centres of the flat and new steps' deltas are summed in
// another order (per block, then over the blocks), where the eager stage
// sums all points at once. Past MAX_K neighbours PyTorch takes other
// orders; the kernels keep theirs, and a sum may then differ from the eager
// one by its rounding.
#pragma once

#include <cstdint>

#include "passes_common.cuh"

namespace ngpd {
namespace dense {

constexpr int THREADS = 128;  // points a block of every dense kernel
constexpr int MAX_K = 127;    // neighbours a row summed in PyTorch's orders

// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi): a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }
__device__ __forceinline__ float clamp_range(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ __forceinline__ float sum3(float x0, float x1, float x2) {
  return fadd(fadd(x0, x2), x1);
}

__device__ __forceinline__ float sum3_serial(float x0, float x1, float x2) {
  return fadd(fadd(x0, x1), x2);
}

// torch.sum(a * b, dim=-1) of 3-vectors.
__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return sum3(fmul(a[0], b[0]), fmul(a[1], b[1]), fmul(a[2], b[2]));
}

// torch.linalg.norm(a, dim=-1) of a 3-vector: the squares summed as sum3.
__device__ __forceinline__ float norm3(const float a[3]) { return __fsqrt_rn(dot3(a, a)); }

// ops/neighbors.py::normalize: a / clamp(norm(a), min=1e-12).
__device__ __forceinline__ void normalize3(float a[3]) {
  const float nrm = clamp_min(norm3(a), EPS);
  for (int c = 0; c < 3; ++c) a[c] = fdiv(a[c], nrm);
}

// Row r of torch.einsum('...ij,...j->...i', A, b) on the card.
__device__ __forceinline__ float bmm_row(const float r[3], const float b[3]) {
  return fadd(__fmaf_rn(r[2], b[2], fmul(r[0], b[0])), fmul(r[1], b[1]));
}

// Sum over the neighbour axis (not innermost) of the M terms term(e, t)
// writes for neighbour e, in PyTorch's order (see the top of the file):
// accumulator r takes neighbours r, r + 4, ... from zero, and the four
// are combined in turn.
template <int M, typename Term>
__device__ __forceinline__ void axis_sum(int k, Term term, float out[M]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float cur[M];
#pragma unroll
    for (int q = 0; q < M; ++q) cur[q] = 0.0f;
    for (int e = r; e < k; e += 4) {
      float t[M];
      term(e, t);
#pragma unroll
      for (int q = 0; q < M; ++q) cur[q] = fadd(cur[q], t[q]);
    }
#pragma unroll
    for (int q = 0; q < M; ++q) out[q] = r == 0 ? cur[q] : fadd(out[q], cur[q]);
  }
}

// torch.sum(x, dim=1) of one row of an (n, k) tensor, element e x(e);
// PyTorch's order up to k = MAX_K.
template <typename At>
__device__ __forceinline__ float row_sum(int k, At x) {
  int lanes = 1;
  while (lanes * 2 <= k && lanes < 32) lanes *= 2;
  float lane[32];
  for (int l = 0; l < lanes; ++l) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    int m = 0;
    for (int e = l; e < k; e += lanes, ++m) acc[m & 3] = fadd(acc[m & 3], x(e));
    lane[l] = fadd(fadd(fadd(acc[0], acc[1]), acc[2]), acc[3]);
  }
  for (int off = lanes / 2; off > 0; off >>= 1)
    for (int l = 0; l < off; ++l) lane[l] = fadd(lane[l], lane[l + off]);
  return lane[0];
}

__device__ __forceinline__ void load3(const float* __restrict__ rows, int64_t j, float v[3]) {
  v[0] = rows[3 * j];
  v[1] = rows[3 * j + 1];
  v[2] = rows[3 * j + 2];
}

// core/voting.py::better_filtered_nvt at query point i (position pts[i])
// over its k neighbours, rows of the source positions src and normals nrm:
// weights [acos(|normalize(p_j - p_i) . n_j|) > rho] on valid slots, every
// valid slot where none holds, the six sums of w n_j n_j^T over the
// weights' count (at least 1). The eager stage's 0.5 (T + T^T) changes
// nothing: T is symmetric, its halves the same products.
__device__ __forceinline__ void filtered_nvt(const float* __restrict__ pts,
                                             const float* __restrict__ src,
                                             const float* __restrict__ nrm,
                                             const int64_t* __restrict__ idx,
                                             const bool* __restrict__ mask, int k, int i,
                                             float rho, float t6[6]) {
  const int64_t* row = idx + (int64_t)i * k;
  const bool* valid = mask + (int64_t)i * k;
  float p[3];
  load3(pts, i, p);
  int count = 0;
  auto weighted = [&](int e, float t[6]) {
    float v[3], nj[3];
    load3(src, row[e], v);
    load3(nrm, row[e], nj);
    float dv[3] = {fsub(v[0], p[0]), fsub(v[1], p[1]), fsub(v[2], p[2])};
    normalize3(dv);
    const float cosang = clamp_range(fabsf(dot3(dv, nj)), -1.0f, 1.0f);
    const bool on = valid[e] && acosf(cosang) > rho;
    count += on;
    const float w = on ? 1.0f : 0.0f;
    const float nw[3] = {fmul(nj[0], w), fmul(nj[1], w), fmul(nj[2], w)};
    t[0] = fmul(nw[0], nj[0]); t[1] = fmul(nw[0], nj[1]); t[2] = fmul(nw[0], nj[2]);
    t[3] = fmul(nw[1], nj[1]); t[4] = fmul(nw[1], nj[2]); t[5] = fmul(nw[2], nj[2]);
  };
  axis_sum<6>(k, weighted, t6);
  if (count == 0) {  // the zero-weight rescue: every valid slot
    auto rescued = [&](int e, float t[6]) {
      float nj[3];
      load3(nrm, row[e], nj);
      count += valid[e];
      const float w = valid[e] ? 1.0f : 0.0f;
      const float nw[3] = {fmul(nj[0], w), fmul(nj[1], w), fmul(nj[2], w)};
      t[0] = fmul(nw[0], nj[0]); t[1] = fmul(nw[0], nj[1]); t[2] = fmul(nw[0], nj[2]);
      t[3] = fmul(nw[1], nj[1]); t[4] = fmul(nw[1], nj[2]); t[5] = fmul(nw[2], nj[2]);
    };
    axis_sum<6>(k, rescued, t6);
  }
  const float wsum = clamp_min((float)count, 1.0f);
  for (int q = 0; q < 6; ++q) t6[q] = fdiv(t6[q], wsum);
}

}  // namespace dense
}  // namespace ngpd
