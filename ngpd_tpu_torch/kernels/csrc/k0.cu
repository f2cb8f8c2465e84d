// K0, the prologue of the hybrid denoise: per point, the k-th smallest
// squared window distance for feature_k, step_k and 6 by a 24-step
// bisection counting search, and the masked sum and count of the 6-NN
// edge lengths.
//
// Replaces: ngpd_tpu/core/pallas_fused.py, _make_k0 (the pallas_call in
// pallas_denoise_hybrid). Output pack (8, n): rk_feat, rk_step, sum6,
// cnt6, then four zero rows. sum6/cnt6 are zero on padding rows.
//
// What bounds it on the H100: operations. Each (query, column) pair
// costs the distance plus 72 compare-and-count steps (3 searches x 24),
// against 44 bytes of traffic per point; that is far above the card's
// operations-per-byte balance.
//
// Design: one block per query tile stages the window's positions and
// |p|^2 in shared memory. One warp serves one query at a time: each
// lane holds CPL of the window's distances in registers (column
// lane + 32*m), so a bisection step is CPL register compares and one
// warp-wide integer sum (__reduce_add_sync), with no shared-memory
// traffic. CPL is a template parameter, the smallest of 4/8/16/32/64
// that covers wt_c. Columns that do not exist (j >= wt_c) hold +inf
// and never count; columns past nv hold dmax, as in the reference.
#include "window_common.cuh"

namespace ngpd {

constexpr int K0_THREADS = 256;
constexpr int K0_SEARCH_ITERS = 24;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int CPL>
__device__ __forceinline__ float kth_by_count(const float (&d)[CPL], int k,
                                              float dmax) {
  float lo = 0.0f, hi = dmax;
  for (int it = 0; it < K0_SEARCH_ITERS; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    unsigned c = 0;
#pragma unroll
    for (int m = 0; m < CPL; ++m) c += (d[m] <= mid) ? 1u : 0u;
    c = __reduce_add_sync(0xffffffffu, c);
    if (c >= (unsigned)k) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  return hi;
}

template <int CPL>
__global__ void __launch_bounds__(K0_THREADS)
    k0_kernel(const float* __restrict__ pack, const int* __restrict__ starts,
              float* __restrict__ out, int n, int nv, int tile, int wt_c,
              int feature_k, int step_k) {
  extern __shared__ float sm[];  // 4 rows of wt_c: p0, p1, p2, |p|^2
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_window<4>(pack, n, s, wt_c, sm);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; r < tile; r += nwarps) {
    const int i = blk * tile + r;
    const float q0 = pack[i], q1 = pack[n + i], q2 = pack[2 * n + i];
    const float p2q = sq_norm3(q0, q1, q2);
    float d[CPL];
    unsigned long long masked = 0ull;  // bit m: column exists but lies past nv
    float vmax = 0.0f;
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      const int j = lane + 32 * m;
      if (j < wt_c) {
        const float dd = sq_dist(q0, q1, q2, p2q, sm[j], sm[wt_c + j],
                                 sm[2 * wt_c + j], sm[3 * wt_c + j]);
        d[m] = dd;
        if (s + j < nv) {
          vmax = fmaxf(vmax, dd);
        } else {
          masked |= 1ull << m;
        }
      } else {
        d[m] = INFINITY;
      }
    }
    const float dmax = __fadd_rn(warp_max(vmax), 1.0f);
#pragma unroll
    for (int m = 0; m < CPL; ++m)
      if (masked & (1ull << m)) d[m] = dmax;

    const float rkf = kth_by_count<CPL>(d, feature_k, dmax);
    const float rk8 = kth_by_count<CPL>(d, step_k, dmax);
    const float rk6 = kth_by_count<CPL>(d, 6, dmax);
    float sum6 = 0.0f, cnt6 = 0.0f;
#pragma unroll
    for (int m = 0; m < CPL; ++m) {
      if (d[m] <= rk6) {
        sum6 = __fadd_rn(sum6, __fsqrt_rn(fmaxf(d[m], 0.0f)));
        cnt6 = __fadd_rn(cnt6, 1.0f);
      }
    }
    sum6 = warp_sum(sum6);
    cnt6 = warp_sum(cnt6);
    if (lane == 0) {
      const bool row_valid = i < nv;
      out[i] = rkf;
      out[n + i] = rk8;
      out[2 * n + i] = row_valid ? sum6 : 0.0f;
      out[3 * n + i] = row_valid ? cnt6 : 0.0f;
      out[4 * n + i] = 0.0f;
      out[5 * n + i] = 0.0f;
      out[6 * n + i] = 0.0f;
      out[7 * n + i] = 0.0f;
    }
  }
}

template <int CPL>
static void launch_k0(const float* pack, const int* starts, float* out, int n,
                      int nv, int tile, int wt_c, int feature_k, int step_k,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * 4 * (size_t)wt_c;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k0_kernel<CPL>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  k0_kernel<CPL><<<n / tile, K0_THREADS, smem, stream>>>(
      pack, starts, out, n, nv, tile, wt_c, feature_k, step_k);
}

}  // namespace ngpd

// pack: (8, n) slim pack [p, n, rk_feat, rk_step]; starts: (n / tile,)
// int32 window starts; out: (8, n). wt_c <= 2048 (the wrapper checks).
extern "C" int ngpd_k0_launch(const void* pack, const void* starts, void* out,
                              int n, int nv, int tile, int wt_c, int feature_k,
                              int step_k, void* stream) {
  using namespace ngpd;
  const float* p = static_cast<const float*>(pack);
  const int* st = static_cast<const int*>(starts);
  float* o = static_cast<float*>(out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  const int cpl = (wt_c + 31) / 32;
  if (cpl <= 4) {
    launch_k0<4>(p, st, o, n, nv, tile, wt_c, feature_k, step_k, cs);
  } else if (cpl <= 8) {
    launch_k0<8>(p, st, o, n, nv, tile, wt_c, feature_k, step_k, cs);
  } else if (cpl <= 16) {
    launch_k0<16>(p, st, o, n, nv, tile, wt_c, feature_k, step_k, cs);
  } else if (cpl <= 32) {
    launch_k0<32>(p, st, o, n, nv, tile, wt_c, feature_k, step_k, cs);
  } else if (cpl <= 64) {
    launch_k0<64>(p, st, o, n, nv, tile, wt_c, feature_k, step_k, cs);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
