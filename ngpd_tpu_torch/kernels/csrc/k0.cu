// K0, the prologue of the hybrid denoise: per point, the k-th smallest
// squared window distance for feature_k, step_k and 6 as a 24-step
// bisection counting search finds it, and the masked sum and count of
// the 6-NN edge lengths.
//
// Replaces: ngpd_tpu/core/pallas_fused.py, _make_k0 (the pallas_call in
// pallas_denoise_hybrid). Output pack (8, n): rk_feat, rk_step, sum6,
// cnt6, then four zero rows. sum6/cnt6 are zero on padding rows.
//
// The function: the search keeps hi = mid where count(d <= mid) >= k.
// That holds exactly when d_(k) <= mid, d_(k) the k-th smallest distance
// (a NaN never counts, so it orders above +inf). So the search's result
// follows from d_(k) alone, by the same 24 midpoints in scalars, and K0
// only has to select d_(feature_k), d_(step_k) and d_(6).
//
// Design: one block per query tile stages the window's positions and
// |p|^2 in shared memory. One warp serves one query at a time: each lane
// holds CPL of the window's distances in registers (column lane + 32 m),
// CPL a template parameter, the smallest of 4/8/16/32/64 that covers
// wt_c. Columns that do not exist (j >= wt_c) hold +inf; columns past nv
// hold dmax, as in the reference. Then, with K = max(feature_k, step_k,
// 6) and r = ceil(K / 16):
//   1. each lane keeps its r smallest distances (r <= 4, in registers);
//   2. T is the ceil(K / r)-th smallest of the 32 lanes' r-th smallest
//      (one warp bitonic sort of 32 keys): ceil(K / r) lanes hold r
//      distances at or below T each, so count(d <= T) >= K;
//   3. the distances at or below T, the candidates, are compacted into
//      a per-warp buffer of K0_CAP words in shared memory (a prefix sum
//      of the lanes' counts);
//   4. one warp bitonic sort of the candidates (32, 64 or 128 keys,
//      padded above every distance) puts d_(k) at position k - 1 for
//      every k <= K: the candidates are every distance up to T >= d_(K);
//   5. lanes 0, 1 and 2 replay the three searches against d_(feature_k),
//      d_(step_k) and d_(6), rounded as the counting search rounds;
//   6. sum6 and cnt6 as before: each lane in m order, then a butterfly.
// The sorts run on the distances' bit patterns: they are +0 or above or
// +inf (sq_dist's fmaxf; never -0), so the patterns order as the floats,
// and a NaN's pattern would order above +inf. A query with more than
// K0_CAP candidates (ties, duplicated points), or a launch with K above
// what r <= min(4, CPL) covers or a k below 1, takes the counting search
// over all its columns: exact too, and slower.
//
// Windows wider than 64 columns a lane (wt_c > 2048, e.g. the CLI's
// --window 1024 at tile 256) take k0_wide_kernel: the same lanes and
// columns, but each warp keeps its query's distances in a row of shared
// memory beside the staged window (lane + 32 m at word lane + 32 m, so
// the lanes read 32 consecutive words, no bank conflict), and reads the
// row four times (steps 1, 3 twice and 6) where the counting search read
// it 72 times. A block runs as many warps, up to 8, as fit in 227 KB with
// the window; one warp (its row and candidates) fits beside up to 11,592
// columns, above what K1 (8 rows) and K2 take.
//
// What bounds it on the H100: operations. The function needs the distances
// and a few passes over a query's columns against 44 bytes of traffic a
// point, far above the card's operations-per-byte balance. The kernel
// issues ~1,000 instructions a lane per query at 512 columns (distances
// ~250, sum6 ~190, the sorts ~280, the replay ~120; counted from the
// source, where the counting search issued ~3,200), so what bounds it now
// is its own instruction count, not the function's operations. The
// distances must match the plain version bit for bit (the selection reads
// them), so they run on the float32 pipes and there is no wgmma here.
//
// Measured at 1M points, 512 columns, feature_k 32 (kernel_lab.py,
// NVIDIA H100 80GB HBM3 at 700 W, against the counting search in the same
// call): 1.69-1.78 ms a launch where the counting search took 5.35-5.47;
// at the CLI's 1,280 columns (feature_k 16) 4.93 ms (25.5 before); past
// 2,048 columns at 100k points 0.94 ms at 2,304 and 2.31 ms at 4,352
// (3.75 and 8.45 before). ptxas: 55 registers at 16 columns a lane (four
// blocks an SM), 128 at 64 (two; unbounded it took 195 and one block,
// 7.7 ms), no spill; the shared-memory kernel 40 registers and 12 bytes
// spilled.
#include "window_common.cuh"

namespace ngpd {

constexpr int K0_THREADS = 256;
constexpr int K0_SEARCH_ITERS = 24;
constexpr int K0_CAP = 128;   // candidate words a warp
constexpr int K0_MAX_R = 4;   // the largest r a lane keeps in registers
constexpr unsigned K0_PAD = 0xffffffffu;  // above every distance's pattern

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

// ---- The counting search (the slow path) -----------------------------------

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

// ---- Selection ---------------------------------------------------------------

// What every query of a launch shares: r, the index of T among the lanes'
// r-th smallest, and whether the selection can run at all.
struct K0Select {
  int r, t_index, feature_k, step_k;
  bool fast;
};

__device__ __forceinline__ K0Select k0_select_args(int feature_k, int step_k, int cpl) {
  const int big = max(max(feature_k, step_k), 6);
  const int r = (big + 15) / 16;
  K0Select a;
  a.r = r;
  a.t_index = (big + r - 1) / r - 1;  // <= 15
  a.feature_k = feature_k;
  a.step_k = step_k;
  a.fast = feature_k >= 1 && step_k >= 1 && r <= K0_MAX_R && r <= cpl;
  return a;
}

// Insert key x into the R smallest keys s (ascending).
template <int R>
__device__ __forceinline__ void keep_smallest(unsigned (&s)[R], unsigned x) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const unsigned lo = min(s[i], x);
    x = max(s[i], x);
    s[i] = lo;
  }
}

template <int R, int CPL>
__device__ __forceinline__ unsigned lane_rth(const float (&d)[CPL]) {
  unsigned s[R];
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = K0_PAD;
#pragma unroll
  for (int m = 0; m < CPL; ++m) keep_smallest<R>(s, __float_as_uint(d[m]));
  return s[R - 1];
}

template <int R>
__device__ __forceinline__ unsigned lane_rth(const float* dw, int cpl, int lane) {
  unsigned s[R];
#pragma unroll
  for (int i = 0; i < R; ++i) s[i] = K0_PAD;
  for (int m = 0; m < cpl; ++m) keep_smallest<R>(s, __float_as_uint(dw[lane + 32 * m]));
  return s[R - 1];
}

// Ascending bitonic sort of the warp's 32 R keys, key e = lane + 32 i in
// v[i].
template <int R>
__device__ __forceinline__ void warp_sort(unsigned (&v)[R], int lane) {
#pragma unroll
  for (int s = 2; s <= 32 * R; s <<= 1) {
#pragma unroll
    for (int t = s >> 1; t > 0; t >>= 1) {
      if (t >= 32) {  // the partner sits in this lane, register i ^ (t / 32)
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int p = i ^ (t >> 5);
          if (p > i) {
            const bool up = ((lane + 32 * i) & s) == 0;
            const unsigned a = v[i], b = v[p];
            v[i] = up ? min(a, b) : max(a, b);
            v[p] = up ? max(a, b) : min(a, b);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const unsigned o = __shfl_xor_sync(0xffffffffu, v[i], t);
          const bool up = ((lane + 32 * i) & s) == 0;
          const bool lower = (lane & t) == 0;
          v[i] = up == lower ? min(v[i], o) : max(v[i], o);
        }
      }
    }
  }
}

// Key e of a warp-sorted v (every lane gets the key its own e names).
template <int R>
__device__ __forceinline__ unsigned sorted_key(const unsigned (&v)[R], int e) {
  unsigned key = K0_PAD;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const unsigned x = __shfl_sync(0xffffffffu, v[i], e & 31);
    if ((e >> 5) == i) key = x;
  }
  return key;
}

// Sort the warp's `total` candidates of buf padded to 32 R, and return
// the key at position k - 1 (k <= total).
template <int R>
__device__ __forceinline__ unsigned select_sorted(const unsigned* buf, int total,
                                                  int lane, int k) {
  unsigned v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = lane + 32 * i;
    v[i] = e < total ? buf[e] : K0_PAD;
  }
  __syncwarp();  // the buffer is free for the warp's next query
  warp_sort<R>(v, lane);
  return sorted_key<R>(v, k - 1);
}

// The counting search's result where d_(k) = v: the same midpoints, and
// hi = mid exactly where count(d <= mid) >= k.
__device__ __forceinline__ float replay_search(float v, float dmax) {
  float lo = 0.0f, hi = dmax;
  for (int it = 0; it < K0_SEARCH_ITERS; ++it) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    if (v <= mid) {
      hi = mid;
    } else {
      lo = mid;
    }
  }
  return hi;
}

// Steps 2-5 for one query, given each lane's r-th smallest key:
// count(T) is the lane's count of keys <= T, put(buf, T, off) writes them
// to buf from offset off. False where the candidates overflow K0_CAP; the
// caller then runs the counting search.
template <typename Count, typename Put>
__device__ __forceinline__ bool select_three(const K0Select& a, unsigned rth,
                                             unsigned* buf, int lane, float dmax,
                                             Count count, Put put, float& rkf,
                                             float& rk8, float& rk6) {
  unsigned t[1] = {rth};
  warp_sort<1>(t, lane);
  const unsigned bound = __shfl_sync(0xffffffffu, t[0], a.t_index);
  const int c = count(bound);
  int incl = c;  // inclusive prefix sum of the lanes' counts
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  if (total > K0_CAP) return false;
  put(buf, bound, incl - c);
  __syncwarp();
  const int k = lane == 0 ? a.feature_k : (lane == 1 ? a.step_k : 6);
  unsigned key;
  if (total <= 32) {
    key = select_sorted<1>(buf, total, lane, k);
  } else if (total <= 64) {
    key = select_sorted<2>(buf, total, lane, k);
  } else {
    key = select_sorted<4>(buf, total, lane, k);
  }
  const float hi = replay_search(__uint_as_float(key), dmax);
  rkf = __shfl_sync(0xffffffffu, hi, 0);
  rk8 = __shfl_sync(0xffffffffu, hi, 1);
  rk6 = __shfl_sync(0xffffffffu, hi, 2);
  return true;
}

__device__ __forceinline__ void write_k0_row(float* __restrict__ out, int n, int i,
                                             bool row_valid, float rkf, float rk8,
                                             float sum6, float cnt6) {
  out[i] = rkf;
  out[n + i] = rk8;
  out[2 * n + i] = row_valid ? sum6 : 0.0f;
  out[3 * n + i] = row_valid ? cnt6 : 0.0f;
  out[4 * n + i] = 0.0f;
  out[5 * n + i] = 0.0f;
  out[6 * n + i] = 0.0f;
  out[7 * n + i] = 0.0f;
}

// Blocks an SM the register kernel is built for: 4 (64 registers) up to 16
// columns a lane, 2 (128) above, where the distances alone take CPL.
template <int CPL>
__global__ void __launch_bounds__(K0_THREADS, CPL <= 16 ? 4 : 2)
    k0_kernel(const float* __restrict__ pack, const int* __restrict__ starts,
              float* __restrict__ out, int n, int nv, int tile, int wt_c,
              int feature_k, int step_k) {
  // 4 rows of wt_c (p0, p1, p2, |p|^2), then K0_CAP candidate words a warp.
  extern __shared__ float sm[];
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_window(pack, n, s, wt_c, sm);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  unsigned* buf = reinterpret_cast<unsigned*>(sm + 4 * wt_c) + warp * K0_CAP;
  const K0Select sel = k0_select_args(feature_k, step_k, CPL);
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

    float rkf, rk8, rk6;
    bool done = false;
    if (sel.fast) {
      const auto count = [&](unsigned bound) {
        int c = 0;
#pragma unroll
        for (int m = 0; m < CPL; ++m) c += __float_as_uint(d[m]) <= bound ? 1 : 0;
        return c;
      };
      const auto put = [&](unsigned* b, unsigned bound, int off) {
#pragma unroll
        for (int m = 0; m < CPL; ++m) {
          const unsigned key = __float_as_uint(d[m]);
          if (key <= bound) b[off++] = key;
        }
      };
      unsigned rth;
      switch (sel.r) {
        case 1: rth = lane_rth<1>(d); break;
        case 2: rth = lane_rth<2>(d); break;
        case 3: rth = lane_rth<3>(d); break;
        default: rth = lane_rth<4>(d);
      }
      done = select_three(sel, rth, buf, lane, dmax, count, put, rkf, rk8, rk6);
    }
    if (!done) {
      rkf = kth_by_count<CPL>(d, feature_k, dmax);
      rk8 = kth_by_count<CPL>(d, step_k, dmax);
      rk6 = kth_by_count<CPL>(d, 6, dmax);
    }
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
    if (lane == 0) write_k0_row(out, n, i, i < nv, rkf, rk8, sum6, cnt6);
  }
}

// k0_kernel for windows of more than 64 columns a lane: each warp's
// distances in its own shared-memory row of wpc = wt_c rounded up to 32.
__global__ void __launch_bounds__(K0_THREADS)
    k0_wide_kernel(const float* __restrict__ pack, const int* __restrict__ starts,
                   float* __restrict__ out, int n, int nv, int tile, int wt_c,
                   int feature_k, int step_k) {
  // 4 rows of wt_c (p0, p1, p2, |p|^2), then one row of wpc and K0_CAP
  // candidate words a warp.
  extern __shared__ float sm[];
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_window(pack, n, s, wt_c, sm);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int cpl = (wt_c + 31) >> 5;
  float* dw = sm + 4 * wt_c + warp * ((cpl << 5) + K0_CAP);
  unsigned* buf = reinterpret_cast<unsigned*>(dw + (cpl << 5));
  const K0Select sel = k0_select_args(feature_k, step_k, cpl);
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

    float rkf, rk8, rk6;
    bool done = false;
    if (sel.fast) {
      const auto count = [&](unsigned bound) {
        int c = 0;
        for (int m = 0; m < cpl; ++m) c += __float_as_uint(dw[lane + 32 * m]) <= bound ? 1 : 0;
        return c;
      };
      const auto put = [&](unsigned* b, unsigned bound, int off) {
        for (int m = 0; m < cpl; ++m) {
          const unsigned key = __float_as_uint(dw[lane + 32 * m]);
          if (key <= bound) b[off++] = key;
        }
      };
      unsigned rth;
      switch (sel.r) {
        case 1: rth = lane_rth<1>(dw, cpl, lane); break;
        case 2: rth = lane_rth<2>(dw, cpl, lane); break;
        case 3: rth = lane_rth<3>(dw, cpl, lane); break;
        default: rth = lane_rth<4>(dw, cpl, lane);
      }
      done = select_three(sel, rth, buf, lane, dmax, count, put, rkf, rk8, rk6);
    }
    if (!done) {
      rkf = kth_by_count_smem(dw, cpl, lane, feature_k, dmax);
      rk8 = kth_by_count_smem(dw, cpl, lane, step_k, dmax);
      rk6 = kth_by_count_smem(dw, cpl, lane, 6, dmax);
    }
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
    if (lane == 0) write_k0_row(out, n, i, i < nv, rkf, rk8, sum6, cnt6);
  }
}

constexpr size_t K0_SMEM_LIMIT = 232448;  // bytes a block can use on sm_90

// Warps a block of k0_wide_kernel at this window: as many of 8 as fit
// beside the window in shared memory; 0 where not even one does.
static int k0_wide_warps(int wt_c) {
  const size_t window = sizeof(float) * 4 * (size_t)wt_c;
  const size_t row = sizeof(float) * ((size_t)((wt_c + 31) & ~31) + K0_CAP);
  if (window + row > K0_SMEM_LIMIT) return 0;
  const size_t warps = (K0_SMEM_LIMIT - window) / row;
  return warps < K0_THREADS / 32 ? (int)warps : K0_THREADS / 32;
}

static size_t k0_smem(int wt_c) {
  return sizeof(float) * (4 * (size_t)wt_c + (size_t)(K0_THREADS / 32) * K0_CAP);
}

static size_t k0_wide_smem(int wt_c, int warps) {
  return sizeof(float) *
         (4 * (size_t)wt_c + (size_t)warps * (((wt_c + 31) & ~31) + K0_CAP));
}

template <typename Kernel>
static void k0_allow(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The register kernel's columns a lane at this window (4/8/16/32/64), or 0
// where the shared-memory kernel takes it.
static int k0_lanes(int wt_c) {
  const int cpl = (wt_c + 31) / 32;
  for (int c = 4; c <= 64; c <<= 1)
    if (cpl <= c) return c;
  return 0;
}

// Launch the kernel of k0_lanes(wt_c) == CPL; cudaErrorInvalidValue where
// not even one warp row of the shared-memory kernel fits.
template <int CPL>
static int launch_k0(const float* pack, const int* starts, float* out, int n,
                     int nv, int tile, int wt_c, int feature_k, int step_k,
                     cudaStream_t stream) {
  if constexpr (CPL == 0) {
    const int warps = k0_wide_warps(wt_c);
    if (warps < 1) return (int)cudaErrorInvalidValue;  // the wrapper names the limit
    const size_t smem = k0_wide_smem(wt_c, warps);
    k0_allow(k0_wide_kernel, smem);
    k0_wide_kernel<<<n / tile, 32 * warps, smem, stream>>>(
        pack, starts, out, n, nv, tile, wt_c, feature_k, step_k);
  } else {
    const size_t smem = k0_smem(wt_c);
    k0_allow(k0_kernel<CPL>, smem);
    k0_kernel<CPL><<<n / tile, K0_THREADS, smem, stream>>>(
        pack, starts, out, n, nv, tile, wt_c, feature_k, step_k);
  }
  return 0;
}

template <int CPL>
static int blocks_k0(int wt_c) {
  int blocks = 0;
  if constexpr (CPL == 0) {
    const int warps = k0_wide_warps(wt_c);
    if (warps >= 1) {
      k0_allow(k0_wide_kernel, k0_wide_smem(wt_c, warps));
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k0_wide_kernel, 32 * warps,
                                                    k0_wide_smem(wt_c, warps));
    }
  } else {
    k0_allow(k0_kernel<CPL>, k0_smem(wt_c));
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k0_kernel<CPL>, K0_THREADS,
                                                  k0_smem(wt_c));
  }
  return blocks;
}

}  // namespace ngpd

#define K0_DISPATCH(CALL)                \
  switch (ngpd::k0_lanes(wt_c)) {        \
    case 4: CALL(4) break;               \
    case 8: CALL(8) break;               \
    case 16: CALL(16) break;             \
    case 32: CALL(32) break;             \
    case 64: CALL(64) break;             \
    default: CALL(0)                     \
  }

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
  int rc = 0;
#define K0_LAUNCH(C) rc = launch_k0<C>(p, st, o, n, nv, tile, wt_c, feature_k, step_k, cs);
  K0_DISPATCH(K0_LAUNCH)
#undef K0_LAUNCH
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// Blocks of the kernel this window takes that one SM holds, as the
// runtime counts them from its registers and shared memory (a block is
// K0_THREADS threads at every tile, or fewer warps past 2,048 columns).
extern "C" int ngpd_k0_blocks_per_sm(int tile, int wt_c) {
  using namespace ngpd;
  (void)tile;
  int blocks = 0;
#define K0_BLOCKS(C) blocks = blocks_k0<C>(wt_c);
  K0_DISPATCH(K0_BLOCKS)
#undef K0_BLOCKS
  return blocks;
}
