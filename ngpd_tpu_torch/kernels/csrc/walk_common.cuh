// The window walk of K1, K2 and passes A-D and BD: a branch-free mask scan
// over words of 32 columns, then a walk over the set bits only (CUDA C++
// for sm_90a).
//
// One thread holds one query. In chunks of 16 words (512 columns) it first
// scans: per word of 32 window columns, the 32 squared distances from
// 16-byte shared-memory loads (every lane of a warp reads the same
// address, a broadcast), unrolled into 32 independent chains with no
// branch, one bit a column in two words: within rk_feat, within rk_step.
// The words go to shared memory, one a (word, thread). It then visits its
// own set bits of the chunk from the lowest up in one flat loop, so the
// sums are taken over a query's passing columns in ascending column order,
// and a warp runs an accumulation body as often as its busiest lane has
// bits in the chunk: not once for every column on which any lane passes,
// and not the busiest lane of every word either.
//
// Before the scan of a word a warp may skip it (K2 does): while staging,
// the block reduces each word's bounding box of positions; a word whose
// box lies further from the box of the warp's 32 queries than the warp's
// largest threshold, with a margin for the rounding of the computed
// distance, has no column within any lane's threshold and reads as 32
// masked columns.
//
// Numerics: the distance is q.(-2p) + |p|^2 + |q|^2 in the reference's
// contraction order with every product and sum rounded on its own, as in
// window_common.cuh and passes_common.cuh, so the masks match the plain
// PyTorch versions bit for bit. That rules the tensor cores out for the
// distance block: TF32 keeps 10 mantissa bits and a split-TF32 product is
// not bit-equal either, so there is no wgmma here.
//
// Shared-memory rows have a pitch of wp = wt rounded up to 32 floats, so
// every word is whole and 16-byte aligned; columns [wt, wp) are staged as
// zeros and, like the columns at or past nv, masked by word_valid.
#pragma once

#include "window_common.cuh"

namespace ngpd {

__host__ __device__ __forceinline__ int round_up32(int wt) { return (wt + 31) & ~31; }

// d <= rk && d < 1e30 as one comparison d <= mask_threshold(rk): the
// largest float below 1e30 where rk is at or above it, else rk (a NaN rk
// stays NaN and passes nothing, as before).
__device__ __forceinline__ float mask_threshold(float rk) {
  return rk >= 1e30f ? __int_as_float(__float_as_int(1e30f) - 1) : rk;
}

// Bits of the columns of a word that lie below jmax; rem = jmax - j0.
__device__ __forceinline__ unsigned word_valid(int rem) {
  return rem >= 32 ? 0xffffffffu : (rem <= 0 ? 0u : (1u << rem) - 1u);
}

// The lowest set bit's index; clears it.
__device__ __forceinline__ int pop_lowest(unsigned& bits) {
  const int b = __ffs(bits) - 1;
  bits &= bits - 1u;
  return b;
}

// Words a chunk: a query's bit words of one chunk wait in shared memory,
// and a 32-bit register marks which of them are not empty.
constexpr int CHUNK_WORDS = 16;

// Visit the set bits of one chunk's words from the lowest up: word w of
// the chunk (bit w of `nonzero` says it has a set bit) is words[w * stride]
// and covers the columns from j_base + 32 w. One flat loop, so a warp runs
// the body max-over-lanes times of a lane's count in the whole chunk: the
// lanes need not find their bits in the same words.
template <typename Body>
__device__ __forceinline__ void walk_chunk(const unsigned* words, int stride,
                                           unsigned nonzero, int j_base,
                                           Body body) {
  unsigned bits = 0u;
  int j0 = 0;
  for (;;) {
    if (bits == 0u) {
      if (nonzero == 0u) break;
      const int w = pop_lowest(nonzero);
      bits = words[w * stride];
      j0 = j_base + (w << 5);
    }
    body(j0 + pop_lowest(bits));
  }
}

// max(q.(-2p_j) + |p_j|^2 + |q|^2, 0) for column j of a window staged with
// rows 0-2 = -2p and row 3 = |p|^2 at pitch wp.
__device__ __forceinline__ float col_dist(const float* sm, int wp, int j,
                                          float q0, float q1, float q2,
                                          float qq) {
  float d = __fmul_rn(q0, sm[j]);
  d = __fadd_rn(d, __fmul_rn(q1, sm[wp + j]));
  d = __fadd_rn(d, __fmul_rn(q2, sm[2 * wp + j]));
  d = __fadd_rn(d, sm[3 * wp + j]);
  d = __fadd_rn(d, qq);
  return fmaxf(d, 0.0f);
}

// The mask scan of the 32 columns from j0 (a multiple of 32): bit b of
// bf / bs is set where col_dist(j0 + b) <= thr_f / thr_s.
__device__ __forceinline__ void scan_word(const float* sm, int wp, int j0,
                                          float q0, float q1, float q2,
                                          float qq, float thr_f, float thr_s,
                                          unsigned& bf, unsigned& bs) {
  const float4* x4 = reinterpret_cast<const float4*>(sm + j0);
  const float4* y4 = reinterpret_cast<const float4*>(sm + wp + j0);
  const float4* z4 = reinterpret_cast<const float4*>(sm + 2 * wp + j0);
  const float4* p4 = reinterpret_cast<const float4*>(sm + 3 * wp + j0);
  bf = 0u;
  bs = 0u;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const float4 x = x4[g], y = y4[g], z = z4[g], pp = p4[g];
    const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
    const float zs[4] = {z.x, z.y, z.z, z.w}, ps[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float d = __fmul_rn(q0, xs[e]);
      d = __fadd_rn(d, __fmul_rn(q1, ys[e]));
      d = __fadd_rn(d, __fmul_rn(q2, zs[e]));
      d = __fadd_rn(d, ps[e]);
      d = __fadd_rn(d, qq);
      d = fmaxf(d, 0.0f);
      if (d <= thr_f) bf |= 1u << (4 * g + e);
      if (d <= thr_s) bs |= 1u << (4 * g + e);
    }
  }
}

// The same scan against one threshold: bit b is set where
// col_dist(j0 + b) <= thr.
__device__ __forceinline__ unsigned scan_word(const float* sm, int wp, int j0,
                                              float q0, float q1, float q2,
                                              float qq, float thr) {
  const float4* x4 = reinterpret_cast<const float4*>(sm + j0);
  const float4* y4 = reinterpret_cast<const float4*>(sm + wp + j0);
  const float4* z4 = reinterpret_cast<const float4*>(sm + 2 * wp + j0);
  const float4* p4 = reinterpret_cast<const float4*>(sm + 3 * wp + j0);
  unsigned bits = 0u;
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const float4 x = x4[g], y = y4[g], z = z4[g], pp = p4[g];
    const float xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
    const float zs[4] = {z.x, z.y, z.z, z.w}, ps[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float d = __fmul_rn(q0, xs[e]);
      d = __fadd_rn(d, __fmul_rn(q1, ys[e]));
      d = __fadd_rn(d, __fmul_rn(q2, zs[e]));
      d = __fadd_rn(d, ps[e]);
      d = __fadd_rn(d, qq);
      d = fmaxf(d, 0.0f);
      if (d <= thr) bits |= 1u << (4 * g + e);
    }
  }
  return bits;
}

// ---- The slim pack's window and its filtered NVT (K1 and K2) --------------

// Staged rows of the slim pack [p, n, rk_feat, rk_step], each wp floats:
// the first four are the scan's.
enum SlimRow { K_M2P = 0, K_PP = 3, K_N = 4, K_PN = 7, K_ROWS = 8 };

// Stage the window columns [s, s + wt_c) of a slim pack: -2p, |p|^2, n,
// p.n; zeros in columns [wt_c, wp).
__device__ __forceinline__ void stage_slim(const float* __restrict__ pack, int n,
                                           int s, int wt_c, int wp, float* sm) {
  for (int j = threadIdx.x; j < wp; j += blockDim.x) {
    float p[3] = {0.f, 0.f, 0.f}, nj[3] = {0.f, 0.f, 0.f};
    if (j < wt_c) {
      const int c = s + j;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p[k] = pack[k * n + c];
        nj[k] = pack[(3 + k) * n + c];
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      sm[(K_M2P + k) * wp + j] = -2.0f * p[k];
      sm[(K_N + k) * wp + j] = nj[k];
    }
    sm[K_PP * wp + j] = sq_norm3(p[0], p[1], p[2]);
    sm[K_PN * wp + j] = dot3(p[0], p[1], p[2], nj[0], nj[1], nj[2]);
  }
}

// The sums of the filtered NVT.
struct NvtSums {
  float kept[6], all[6], n_kept, n_all;
};

// One passing column j of the filtered NVT over a slim window: sym6 of
// n_j into every sum, into the kept sums where the angle filter keeps it.
__device__ __forceinline__ void nvt_slim_column(const float* sm, int wp, int j,
                                                float q0, float q1, float q2,
                                                float qq, float cos_rho, NvtSums& a) {
  const float d = col_dist(sm, wp, j, q0, q1, q2, qq);
  const float n0 = sm[K_N * wp + j], n1 = sm[(K_N + 1) * wp + j],
              n2 = sm[(K_N + 2) * wp + j];
  const float sym[6] = {__fmul_rn(n0, n0), __fmul_rn(n0, n1),
                        __fmul_rn(n0, n2), __fmul_rn(n1, n1),
                        __fmul_rn(n1, n2), __fmul_rn(n2, n2)};
  const float dotj = __fsub_rn(sm[K_PN * wp + j], dot3(q0, q1, q2, n0, n1, n2));
#pragma unroll
  for (int c = 0; c < 6; ++c) a.all[c] = __fadd_rn(a.all[c], sym[c]);
  a.n_all = __fadd_rn(a.n_all, 1.0f);
  if (keeps_angle(dotj, d, cos_rho)) {
#pragma unroll
    for (int c = 0; c < 6; ++c) a.kept[c] = __fadd_rn(a.kept[c], sym[c]);
    a.n_kept = __fadd_rn(a.n_kept, 1.0f);
  }
}

// t6 of the filtered NVT: the kept sums over the kept count, all of them
// where none is kept (the zero-weight rescue).
__device__ __forceinline__ void nvt_mean(const NvtSums& nvt, float t6[6]) {
  const bool rescue = nvt.n_kept == 0.0f;
  const float wsum = fmaxf(rescue ? nvt.n_all : nvt.n_kept, 1.0f);
#pragma unroll
  for (int c = 0; c < 6; ++c) t6[c] = __fdiv_rn(rescue ? nvt.all[c] : nvt.kept[c], wsum);
}

// ---- Skipping words that cannot pass --------------------------------------

// Per word, in shared memory: the bounding box of its columns' positions
// (lo x, y, z, hi x, y, z) and the largest |p|^2 among them.
constexpr int BOX_FLOATS = 8;

// A bound on |computed - exact| of the distance above for |q|^2 <= qq and
// |p|^2 <= pp: three products, four sums and the two squared norms, each
// rounded once, come to under 12 ulps of |q|^2 + |p|^2; 16 are taken.
__device__ __forceinline__ float dist_margin(float qq, float pp) {
  return 9.5367431640625e-07f * (qq + pp);  // 16 * 2^-24
}

// After the window rows are staged (and a __syncthreads): each warp takes
// words w = warp, warp + warps, ... and reduces the box of the word's 32
// columns. Rows 0-2 hold -2p, row 3 |p|^2. Columns past the window's end
// (zeros) and padding points only widen a box.
__device__ __forceinline__ void reduce_word_boxes(const float* sm, int wp,
                                                  float* boxes) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  for (int w = warp; w < (wp >> 5); w += warps) {
    const int j = (w << 5) + lane;
    float lo[3], hi[3], pm = sm[3 * wp + j];
#pragma unroll
    for (int c = 0; c < 3; ++c) lo[c] = hi[c] = -0.5f * sm[c * wp + j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = fminf(lo[c], __shfl_xor_sync(0xffffffffu, lo[c], o));
        hi[c] = fmaxf(hi[c], __shfl_xor_sync(0xffffffffu, hi[c], o));
      }
      pm = fmaxf(pm, __shfl_xor_sync(0xffffffffu, pm, o));
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        boxes[w * BOX_FLOATS + c] = lo[c];
        boxes[w * BOX_FLOATS + 3 + c] = hi[c];
      }
      boxes[w * BOX_FLOATS + 6] = pm;
    }
  }
}

// The box of a warp's 32 queries, their largest |q|^2 and largest
// threshold; the same in every lane.
struct WarpBox {
  float lo[3], hi[3], qq, thr;
};

__device__ __forceinline__ WarpBox warp_box(float q0, float q1, float q2,
                                            float qq, float thr) {
  WarpBox b = {{q0, q1, q2}, {q0, q1, q2}, qq, thr};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      b.lo[c] = fminf(b.lo[c], __shfl_xor_sync(0xffffffffu, b.lo[c], o));
      b.hi[c] = fmaxf(b.hi[c], __shfl_xor_sync(0xffffffffu, b.hi[c], o));
    }
    b.qq = fmaxf(b.qq, __shfl_xor_sync(0xffffffffu, b.qq, o));
    b.thr = fmaxf(b.thr, __shfl_xor_sync(0xffffffffu, b.thr, o));
  }
  return b;
}

// True when no query of the warp can have a column of word `box` within
// its threshold: the squared gap between the two boxes, lowered by its own
// rounding and by the distance's margin, still exceeds the warp's largest
// threshold. A NaN anywhere compares false and skips nothing. The plain
// copy is kernels/window.py::word_skippable.
__device__ __forceinline__ bool word_skippable(const WarpBox& q,
                                               const float* box) {
  float lb = 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float gap = fmaxf(fmaxf(box[c] - q.hi[c], q.lo[c] - box[3 + c]), 0.0f);
    lb = lb + gap * gap;
  }
  return lb * 0.99999f - dist_margin(q.qq, box[6]) > q.thr;
}

// ---- Launch ----------------------------------------------------------------

// Dynamic shared memory above 48 KB must be allowed once a kernel;
// `allowed` is that kernel's high-water mark.
template <typename Kernel>
__host__ inline void allow_smem(Kernel kernel, size_t smem, size_t& allowed) {
  if (smem > 48 * 1024 && smem > allowed) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    allowed = smem;
  }
}

}  // namespace ngpd
