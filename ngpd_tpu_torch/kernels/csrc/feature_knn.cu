// The DGCNN's feature-space kNN: for each node i of a patch, the k nodes j
// of the same patch with the smallest d(i, j) = sum_c (x_ic - x_jc)^2,
// self included, ascending by (d, j): equal distances keep the lower
// index, as jax.lax.top_k keeps it. x is (B, P, C) float32, the output
// (B, P, k) int64.
//
// Replaces: ngpd_tpu/models/dgcnn.py, feature_knn (l.41). That is a jitted
// XLA program (a sum of squared differences, then jax.lax.top_k), not a
// pallas_call. The port ran it as plain torch, which writes the (B, P, P,
// C) difference block to device memory, squares and sums it, and selects
// on an int64 key; models/dgcnn.py keeps that as feature_knn_plain.
//
// What bounds it on the H100: operations. Each (i, j, c) costs a
// subtraction, a product and a sum, 3 P^2 C a patch (1.6e10 a mesh-cell
// batch of 2,048 patches over C = 128, 256 and 256), against bytes of
// only the (P, C) rows in and the (P, k) indices out. The ranking must be
// the plain version's, so the distances run on the float32 pipes, each
// product and sum rounded on its own (-fmad=false and the __f*_rn
// intrinsics): no mma, no wgmma, no TF32. The order of the sum is fixed:
// c ascending from 0, d = ((t_0^2 + t_1^2) + t_2^2) + ..., t_c = x_ic -
// x_jc. torch.sum adds in another order, so a distance may differ from the
// plain version's by a few ulps; two rows with equal features give equal
// distances bit for bit in any fixed order, so the ties that masked patch
// nodes make stay ties and resolve as in the reference. Unfused, each
// operation is one instruction: the SM's issue rate is the ceiling.
//
// Design. One block a patch, up to FKNN_WARPS warps. The patch streams
// through shared memory in slabs of FKNN_SLAB channels of every node, a
// ring of FKNN_STAGES slabs filled by cp.async two slabs ahead of the
// compute, so the copy of one slab overlaps the distances of another and
// the block's shared memory no longer grows with C. A slab is stored row
// by row (node by node) with a pitch of FKNN_PITCH floats, 4 more than a
// slab's row: 16-byte copies need no transpose, and a lane's float4 of
// its own row falls in its own four banks (the pitch is 4 mod 32 words).
// Each warp owns 64 rows (lane l the rows l and l + 32) and one chunk of
// FKNN_COLS columns at a time: per 4 channels a lane loads its two rows'
// float4s and the chunk's eight column float4s, which every lane of the
// warp shares (a broadcast), and updates 16 distances; that is 10 loads
// for 192 float operations. A patch of 64 nodes takes 8 warps, one a
// chunk, in one round; larger patches take their chunks in rounds, the
// slabs streamed again each round. Each distance adds its terms c
// ascending, slab after slab, so its bits are those of a sum over c in
// one pass; channels past C are staged as zeros and add an exact 0.
//
// The selection runs on the plain version's int64 key, the bits of d + 0
// sign-extended times 2^32 plus j: keys are unique, so the order in which
// they are offered does not matter. After a round each thread writes its
// keys to shared memory (over the slab ring, column by column so that a
// warp's stores and loads hit consecutive words), and one thread a row
// keeps its k best in K sorted registers behind K - k pads of the least
// key (the k-th is always slot K - 1, no register indexed at run time); a
// key enters only below the k-th and bubbles down K - 1 compare-swaps.
// The warps of a block stay busy on distances while a few rows select,
// and an SM holds FKNN_MIN_BLOCKS such blocks, 32 warps: the launch bounds
// cap a thread at 64 registers, which the 16 distances, the two rows'
// float4s and the list fit.
#include <cuda_runtime.h>


namespace ngpd {

constexpr int FKNN_MAX_P = 256;  // nodes a patch
constexpr int FKNN_MAX_K = 16;
constexpr int FKNN_SLAB = 32;  // channels a staged slab
constexpr int FKNN_PITCH = FKNN_SLAB + 4;  // floats a staged row: 4 mod 32 words
constexpr int FKNN_STAGES = 3;  // slabs in the ring
constexpr int FKNN_COLS = 8;  // columns a thread a round
constexpr int FKNN_ROWS = 64;  // rows a warp: lane l takes l and l + 32
constexpr int FKNN_WARPS = 8;  // warps a block at most
constexpr int FKNN_MIN_BLOCKS = 4;  // blocks an SM: registers capped at 64 a thread
static_assert(FKNN_PITCH % 32 == 4, "a lane's row float4 falls in its own banks");
static_assert(FKNN_SLAB % 4 == 0, "a slab is whole float4s");

// A patch's layout: row groups of 64 nodes, column groups (one warp each
// a row group), the rounds that cover its chunks of FKNN_COLS columns.
struct FknnShape {
  int row_groups, groups, warps, rounds, rows;
  __host__ __device__ FknnShape(int p) {
    row_groups = (p + FKNN_ROWS - 1) / FKNN_ROWS;
    const int chunks = (p + FKNN_COLS - 1) / FKNN_COLS;
    groups = chunks < FKNN_WARPS / row_groups ? chunks : FKNN_WARPS / row_groups;
    warps = row_groups * groups;
    rounds = (chunks + groups - 1) / groups;
    rows = row_groups * FKNN_ROWS;
  }
};

// Bytes of shared memory a block takes: the slab ring, or the keys of a
// round written over it, whichever is larger.
__host__ __device__ inline size_t fknn_smem_bytes(int p) {
  const FknnShape s(p);
  const size_t ring = (size_t)FKNN_STAGES * s.rows * FKNN_PITCH * sizeof(float);
  const size_t keys = (size_t)s.rows * s.groups * FKNN_COLS * sizeof(long long);
  return ring > keys ? ring : keys;
}

// Copy 16 (VEC) or 4 bytes from global to shared memory without the
// registers, or zero the destination where !valid (nothing is read).
template <bool VEC>
__device__ __forceinline__ void fknn_copy(float* dst, const float* src, bool valid) {
  const unsigned smem = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (VEC) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                 "r"(smem), "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                 "r"(smem), "l"(src), "r"(valid ? 4 : 0));
  }
}

__device__ __forceinline__ void fknn_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most FKNN_STAGES - 2 groups of this thread are in flight.
__device__ __forceinline__ void fknn_wait_slab() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(FKNN_STAGES - 2));
}

__device__ __forceinline__ void fknn_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Stage channels [c0, c0 + FKNN_SLAB) of every row of the patch xb into
// the slab at ring; rows past p and channels past c are zeros.
template <bool VEC>
__device__ __forceinline__ void fknn_stage(float* ring, const float* __restrict__ xb, int p,
                                           int c, int c0, int rows) {
  const int per_row = VEC ? FKNN_SLAB / 4 : FKNN_SLAB;
  const int width = VEC ? 4 : 1;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int row = e / per_row, ch = (e - row * per_row) * width;
    const bool valid = row < p && c0 + ch < c;
    fknn_copy<VEC>(ring + row * FKNN_PITCH + ch,
                   valid ? xb + (size_t)row * c + c0 + ch : xb, valid);
  }
}

// d += (a - b)^2 over the four channels of a float4, in order.
__device__ __forceinline__ float fknn_add4(float d, const float4 a, const float4 b) {
  float t = __fsub_rn(a.x, b.x);
  d = __fadd_rn(d, __fmul_rn(t, t));
  t = __fsub_rn(a.y, b.y);
  d = __fadd_rn(d, __fmul_rn(t, t));
  t = __fsub_rn(a.z, b.z);
  d = __fadd_rn(d, __fmul_rn(t, t));
  t = __fsub_rn(a.w, b.w);
  return __fadd_rn(d, __fmul_rn(t, t));
}

// The plain version's key: the bits of d + 0.0 (no -0.0), sign-extended,
// times 2^32, plus j.
__device__ __forceinline__ long long fknn_key(float d, int j) {
  return (long long)__float_as_int(__fadd_rn(d, 0.0f)) * 4294967296LL + j;
}

constexpr long long FKNN_LEAST = -0x7fffffffffffffffLL - 1;
constexpr long long FKNN_NONE = 0x7fffffffffffffffLL;

template <int K, bool VEC, bool ONE_ROUND>
__global__ void __launch_bounds__(FKNN_WARPS * 32, FKNN_MIN_BLOCKS)
feature_knn_kernel(const float* __restrict__ x, long long* __restrict__ out, int p, int c,
                   int k) {
  extern __shared__ float4 fknn_smem[];
  float* ring = reinterpret_cast<float*>(fknn_smem);
  long long* keys = reinterpret_cast<long long*>(fknn_smem);
  const FknnShape shape(p);
  const float* xb = x + (size_t)blockIdx.x * p * c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = warp / shape.groups, g = warp - rg * shape.groups;
  const int i0 = rg * FKNN_ROWS + lane, i1 = i0 + 32;
  const int slabs = (c + FKNN_SLAB - 1) / FKNN_SLAB;
  const int slab_floats = shape.rows * FKNN_PITCH;
  const int cols = shape.groups * FKNN_COLS;  // columns a round

  long long best[K];
#pragma unroll
  for (int s = 0; s < K; ++s) best[s] = s < K - k ? FKNN_LEAST : FKNN_NONE;

  for (int r = 0; r < (ONE_ROUND ? 1 : shape.rounds); ++r) {
    const int j0 = (r * shape.groups + g) * FKNN_COLS;  // this thread's first column
    float d0[FKNN_COLS], d1[FKNN_COLS];
#pragma unroll
    for (int t = 0; t < FKNN_COLS; ++t) d0[t] = d1[t] = 0.0f;
#pragma unroll
    for (int s = 0; s < FKNN_STAGES - 1; ++s) {
      if (s < slabs) fknn_stage<VEC>(ring + s * slab_floats, xb, p, c, s * FKNN_SLAB, shape.rows);
      fknn_commit();
    }
    for (int s = 0; s < slabs; ++s) {
      fknn_wait_slab();
      __syncthreads();  // slab s is in; slab s - 1 is consumed
      const int next = s + FKNN_STAGES - 1;
      if (next < slabs)
        fknn_stage<VEC>(ring + (next % FKNN_STAGES) * slab_floats, xb, p, c,
                        next * FKNN_SLAB, shape.rows);
      fknn_commit();
      const float* slab = ring + (s % FKNN_STAGES) * slab_floats;
      const float* row0 = slab + i0 * FKNN_PITCH;
      const float* row1 = slab + i1 * FKNN_PITCH;
      const float* colv = slab + j0 * FKNN_PITCH;
#pragma unroll 2
      for (int cc = 0; cc < FKNN_SLAB; cc += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(row0 + cc);
        const float4 a1 = *reinterpret_cast<const float4*>(row1 + cc);
#pragma unroll
        for (int t = 0; t < FKNN_COLS; ++t) {
          const float4 b = *reinterpret_cast<const float4*>(colv + t * FKNN_PITCH + cc);
          d0[t] = fknn_add4(d0[t], a0, b);
          d1[t] = fknn_add4(d1[t], a1, b);
        }
      }
    }
    fknn_wait_all();
    __syncthreads();  // every slab consumed: the keys go over the ring
#pragma unroll
    for (int t = 0; t < FKNN_COLS; ++t) {
      const int j = j0 + t, jj = g * FKNN_COLS + t;
      keys[(size_t)jj * shape.rows + i0] = j < p ? fknn_key(d0[t], j) : FKNN_NONE;
      keys[(size_t)jj * shape.rows + i1] = j < p ? fknn_key(d1[t], j) : FKNN_NONE;
    }
    __syncthreads();
    if (threadIdx.x < p) {
      for (int jj = 0; jj < cols; ++jj) {
        const long long key = keys[(size_t)jj * shape.rows + threadIdx.x];
        if (key < best[K - 1]) {
          best[K - 1] = key;
#pragma unroll
          for (int s = K - 1; s > 0; --s) {
            if (best[s] < best[s - 1]) {
              const long long tmp = best[s];
              best[s] = best[s - 1];
              best[s - 1] = tmp;
            }
          }
        }
      }
    }
    if (!ONE_ROUND) __syncthreads();  // the keys are read before the next round's slabs
  }
  if (threadIdx.x < p) {
    long long* o = out + ((size_t)blockIdx.x * p + threadIdx.x) * k;
#pragma unroll
    for (int s = 0; s < K; ++s)
      if (s >= K - k) o[s - (K - k)] = best[s] & 0xffffffffLL;
  }
}

// The list size a k runs with (kernels/graph.py::feature_knn_variant).
inline int fknn_variant(int k) { return k <= 8 ? 8 : 16; }

template <typename Kernel>
static void fknn_allow(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The kernel that runs (p, k) with x at `x`, handed to fn: 16-byte copies
// where every row starts 16-byte aligned, one round up to 64 nodes.
template <typename Fn>
static void fknn_dispatch(const void* x, int p, int c, int k, Fn fn) {
  const bool vec = c % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0;
  const bool one = FknnShape(p).rounds == 1;
  if (fknn_variant(k) == 8) {
    if (vec) one ? fn(feature_knn_kernel<8, true, true>) : fn(feature_knn_kernel<8, true, false>);
    else one ? fn(feature_knn_kernel<8, false, true>) : fn(feature_knn_kernel<8, false, false>);
  } else {
    if (vec) one ? fn(feature_knn_kernel<16, true, true>) : fn(feature_knn_kernel<16, true, false>);
    else one ? fn(feature_knn_kernel<16, false, true>) : fn(feature_knn_kernel<16, false, false>);
  }
}

}  // namespace ngpd

// x (b, p, c) contiguous float32; out (b, p, k) int64, every slot written.
// Takes 1 <= p <= FKNN_MAX_P, 1 <= k <= min(FKNN_MAX_K, p) and c >= 1;
// anything else returns cudaErrorInvalidValue.
extern "C" int ngpd_feature_knn_launch(const void* x, void* out, int b, int p, int c, int k,
                                       void* stream) {
  using namespace ngpd;
  if (b <= 0 || p <= 0 || p > FKNN_MAX_P || c <= 0 || k <= 0 || k > FKNN_MAX_K || k > p)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fknn_smem_bytes(p);
  const int threads = FknnShape(p).warps * 32;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  long long* op = static_cast<long long*>(out);
  fknn_dispatch(x, p, c, k, [&](auto kernel) {
    fknn_allow(kernel, smem);
    kernel<<<b, threads, smem, s>>>(xp, op, p, c, k);
  });
  return (int)cudaGetLastError();
}

// Blocks of the variant that runs (p, c, k) on 16-byte-aligned rows that
// one SM holds, as the runtime counts them from its registers and shared
// memory.
extern "C" int ngpd_feature_knn_blocks_per_sm(int p, int c, int k) {
  using namespace ngpd;
  if (p <= 0 || p > FKNN_MAX_P) return 0;
  const size_t smem = fknn_smem_bytes(p);
  int blocks = 0;
  fknn_dispatch(nullptr, p, c, k, [&](auto kernel) {
    fknn_allow(kernel, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, FknnShape(p).warps * 32,
                                                  smem);
  });
  return blocks;
}
