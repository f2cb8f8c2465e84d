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
//
// Windows wider than 64 columns a lane (wt_c > 2048, e.g. the CLI's
// --window 1024 at tile 256) take k0_wide_kernel: the same lanes, the
// same columns a lane in the same order, the same 24 steps and sums, but
// each warp keeps its query's distances in a row of shared memory beside
// the staged window (lane + 32 m at word lane + 32 m, so the lanes read
// 32 consecutive words, no bank conflict). A block runs as many warps,
// up to 8, as fit in 227 KB with the window; one warp fits up to 11,622
// columns, above what K1 (8 rows) and K2 take. Measured at 100k points
// (chip_smoke.py k0_wide, NVIDIA H100 80GB HBM3 at 700 W): 3.98 ms at
// 2,304 columns and 8.57 ms at 4,352, ~2x the register kernel's time a
// pair (5.4 ms for 1M x 512); ptxas: 32 registers, no spill.
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

// The same search over a warp's row of distances in shared memory: lane
// `lane` counts its columns lane + 32 m, m < cpl, in order.
__device__ __forceinline__ float kth_by_count_smem(const float* dw, int cpl, int lane,
                                                   int k, float dmax) {
  float lo = 0.0f, hi = dmax;
  for (int it = 0; it < K0_SEARCH_ITERS; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    unsigned c = 0;
    for (int m = 0; m < cpl; ++m) c += (dw[lane + 32 * m] <= mid) ? 1u : 0u;
    c = __reduce_add_sync(0xffffffffu, c);
    if (c >= (unsigned)k) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  return hi;
}

// k0_kernel for windows of more than 64 columns a lane: each warp's
// distances in its own shared-memory row of wpc = wt_c rounded up to 32.
__global__ void __launch_bounds__(K0_THREADS)
    k0_wide_kernel(const float* __restrict__ pack, const int* __restrict__ starts,
                   float* __restrict__ out, int n, int nv, int tile, int wt_c,
                   int feature_k, int step_k) {
  // 4 rows of wt_c (p0, p1, p2, |p|^2), then one row of wpc a warp.
  extern __shared__ float sm[];
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_window<4>(pack, n, s, wt_c, sm);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int cpl = (wt_c + 31) >> 5;
  float* dw = sm + 4 * wt_c + warp * (cpl << 5);
  for (int r = warp; r < tile; r += nwarps) {
    const int i = blk * tile + r;
    const float q0 = pack[i], q1 = pack[n + i], q2 = pack[2 * n + i];
    const float p2q = sq_norm3(q0, q1, q2);
    float vmax = 0.0f;
    for (int m = 0; m < cpl; ++m) {
      const int j = lane + 32 * m;
      float dd = INFINITY;
      if (j < wt_c) {
        dd = sq_dist(q0, q1, q2, p2q, sm[j], sm[wt_c + j], sm[2 * wt_c + j],
                     sm[3 * wt_c + j]);
        if (s + j < nv) vmax = fmaxf(vmax, dd);
      }
      dw[j] = dd;
    }
    const float dmax = __fadd_rn(warp_max(vmax), 1.0f);
    for (int m = 0; m < cpl; ++m) {
      const int j = lane + 32 * m;
      if (j < wt_c && s + j >= nv) dw[j] = dmax;
    }

    const float rkf = kth_by_count_smem(dw, cpl, lane, feature_k, dmax);
    const float rk8 = kth_by_count_smem(dw, cpl, lane, step_k, dmax);
    const float rk6 = kth_by_count_smem(dw, cpl, lane, 6, dmax);
    float sum6 = 0.0f, cnt6 = 0.0f;
    for (int m = 0; m < cpl; ++m) {
      const float d = dw[lane + 32 * m];
      if (d <= rk6) {
        sum6 = __fadd_rn(sum6, __fsqrt_rn(fmaxf(d, 0.0f)));
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

constexpr size_t K0_SMEM_LIMIT = 232448;  // bytes a block can use on sm_90

// Warps a block of k0_wide_kernel at this window: as many of 8 as fit
// beside the window in shared memory; 0 where not even one does.
static int k0_wide_warps(int wt_c) {
  const size_t window = sizeof(float) * 4 * (size_t)wt_c;
  const size_t row = sizeof(float) * (size_t)((wt_c + 31) & ~31);
  if (window + row > K0_SMEM_LIMIT) return 0;
  const size_t warps = (K0_SMEM_LIMIT - window) / row;
  return warps < K0_THREADS / 32 ? (int)warps : K0_THREADS / 32;
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

static int launch_k0_wide(const float* pack, const int* starts, float* out, int n,
                          int nv, int tile, int wt_c, int feature_k, int step_k,
                          cudaStream_t stream) {
  const int warps = k0_wide_warps(wt_c);
  if (warps < 1) return (int)cudaErrorInvalidValue;  // the wrapper names the limit
  const size_t smem =
      sizeof(float) * (4 * (size_t)wt_c + (size_t)warps * ((wt_c + 31) & ~31));
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k0_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  k0_wide_kernel<<<n / tile, 32 * warps, smem, stream>>>(
      pack, starts, out, n, nv, tile, wt_c, feature_k, step_k);
  return 0;
}

}  // namespace ngpd

// pack: (8, n) slim pack [p, n, rk_feat, rk_step]; starts: (n / tile,)
// int32 window starts; out: (8, n). Up to 2048 columns the register
// kernel runs, above that the shared-memory one, up to the window whose
// one warp row does not fit in K0_SMEM_LIMIT (cudaErrorInvalidValue, which
// the wrapper raises as a ValueError naming the limit).
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
    const int rc = launch_k0_wide(p, st, o, n, nv, tile, wt_c, feature_k, step_k, cs);
    if (rc != 0) return rc;
  }
  return (int)cudaGetLastError();
}
