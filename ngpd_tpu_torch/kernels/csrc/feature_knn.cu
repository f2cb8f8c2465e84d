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
// nodes make stay ties and resolve as in the reference.
//
// Design (a first port, simple and right): one block a patch, one thread
// a node (P <= FKNN_MAX_P). The block stages its patch transposed in
// shared memory, xs[c * PP + j] with PP = P rounded up to FKNN_J (the
// rows past P zero), so that a warp's threads read their own x_ic from
// consecutive words and every thread reads the same x_jc (a broadcast,
// four columns a 16-byte load). A thread computes FKNN_J distances at once
// in registers, which reads its x_ic once for FKNN_J columns, then offers
// them in ascending j to its list. The list is K 64-bit keys in registers,
// (distance bits << 32) + j, the plain version's int64 key, sorted: K - k
// pads of the least key in front, so the k-th is always slot K - 1 and no
// register is indexed at run time; a key enters only below the k-th and
// bubbles down K - 1 compare-swaps. At C = 256 the patch takes 64 KB of
// shared memory (above 48 KB the launch opts in), so an SM holds three
// blocks, six warps. Left for later: several patches a block or several
// nodes a thread, and the list kept as distances alone.
#include <cuda_runtime.h>

namespace ngpd {

constexpr int FKNN_J = 16;  // distances a thread computes at once
constexpr int FKNN_MAX_P = 256;  // nodes a patch: one thread each
constexpr int FKNN_MAX_K = 16;
constexpr int FKNN_SMEM_LIMIT = 232448;  // bytes of shared memory a block can use

__host__ __device__ inline int fknn_padded(int p) { return (p + FKNN_J - 1) / FKNN_J * FKNN_J; }

template <int K>
__global__ void __launch_bounds__(FKNN_MAX_P)
feature_knn_kernel(const float* __restrict__ x, long long* __restrict__ out, int p, int c,
                   int k) {
  extern __shared__ float4 fknn_smem[];
  float* xs = reinterpret_cast<float*>(fknn_smem);
  const int pp = fknn_padded(p);
  const float* xb = x + (size_t)blockIdx.x * p * c;
  for (int e = threadIdx.x; e < pp * c; e += blockDim.x) {
    const int ch = e / pp, node = e - ch * pp;
    xs[e] = node < p ? xb[(size_t)node * c + ch] : 0.0f;
  }
  __syncthreads();
  const int i = threadIdx.x;
  if (i >= p) return;

  long long best[K];
#pragma unroll
  for (int s = 0; s < K; ++s) best[s] = s < K - k ? (long long)(-0x7fffffffffffffffLL - 1)
                                                  : 0x7fffffffffffffffLL;
  for (int j0 = 0; j0 < p; j0 += FKNN_J) {
    float d[FKNN_J];
#pragma unroll
    for (int t = 0; t < FKNN_J; ++t) d[t] = 0.0f;
    for (int ch = 0; ch < c; ++ch) {
      const float xi = xs[ch * pp + i];
      const float4* row = reinterpret_cast<const float4*>(xs + ch * pp + j0);
#pragma unroll
      for (int q = 0; q < FKNN_J / 4; ++q) {
        const float4 v = row[q];
        const float t0 = __fsub_rn(xi, v.x), t1 = __fsub_rn(xi, v.y);
        const float t2 = __fsub_rn(xi, v.z), t3 = __fsub_rn(xi, v.w);
        d[4 * q] = __fadd_rn(d[4 * q], __fmul_rn(t0, t0));
        d[4 * q + 1] = __fadd_rn(d[4 * q + 1], __fmul_rn(t1, t1));
        d[4 * q + 2] = __fadd_rn(d[4 * q + 2], __fmul_rn(t2, t2));
        d[4 * q + 3] = __fadd_rn(d[4 * q + 3], __fmul_rn(t3, t3));
      }
    }
#pragma unroll
    for (int t = 0; t < FKNN_J; ++t) {
      const int j = j0 + t;
      // The plain version's key: the bits of d + 0.0 (no -0.0), sign-
      // extended, times 2^32, plus j. All keys differ, so the order is
      // the stable order by (distance bits, index).
      const long long key =
          (long long)__float_as_int(__fadd_rn(d[t], 0.0f)) * 4294967296LL + j;
      if (j < p && key < best[K - 1]) {
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
  long long* o = out + ((size_t)blockIdx.x * p + i) * k;
#pragma unroll
  for (int s = 0; s < K; ++s)
    if (s >= K - k) o[s - (K - k)] = best[s] & 0xffffffffLL;
}

// The list size a k runs with (kernels/graph.py::feature_knn_variant).
inline int fknn_variant(int k) { return k <= 8 ? 8 : 16; }

inline size_t fknn_smem_bytes(int p, int c) { return (size_t)fknn_padded(p) * c * sizeof(float); }

inline int fknn_threads(int p) { return (p + 31) / 32 * 32; }

template <typename Kernel>
static void fknn_allow(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace ngpd

// x (b, p, c) contiguous float32; out (b, p, k) int64, every slot written.
// Takes 1 <= p <= FKNN_MAX_P, 1 <= k <= min(FKNN_MAX_K, p), c >= 1 and a
// patch of at most FKNN_SMEM_LIMIT bytes (p rounded up to 16, times c,
// times 4); anything else returns cudaErrorInvalidValue.
extern "C" int ngpd_feature_knn_launch(const void* x, void* out, int b, int p, int c, int k,
                                       void* stream) {
  using namespace ngpd;
  if (b <= 0 || p <= 0 || p > FKNN_MAX_P || c <= 0 || k <= 0 || k > FKNN_MAX_K || k > p ||
      fknn_smem_bytes(p, c) > (size_t)FKNN_SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fknn_smem_bytes(p, c);
  const int threads = fknn_threads(p);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  long long* op = static_cast<long long*>(out);
  if (fknn_variant(k) == 8) {
    fknn_allow(feature_knn_kernel<8>, smem);
    feature_knn_kernel<8><<<b, threads, smem, s>>>(xp, op, p, c, k);
  } else {
    fknn_allow(feature_knn_kernel<16>, smem);
    feature_knn_kernel<16><<<b, threads, smem, s>>>(xp, op, p, c, k);
  }
  return (int)cudaGetLastError();
}

// Blocks of the variant that runs (p, c, k) that one SM holds, as the
// runtime counts them from its registers and shared memory.
extern "C" int ngpd_feature_knn_blocks_per_sm(int p, int c, int k) {
  using namespace ngpd;
  const size_t smem = fknn_smem_bytes(p, c);
  int blocks = 0;
  if (fknn_variant(k) == 8) {
    fknn_allow(feature_knn_kernel<8>, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, feature_knn_kernel<8>,
                                                  fknn_threads(p), smem);
  } else {
    fknn_allow(feature_knn_kernel<16>, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, feature_knn_kernel<16>,
                                                  fknn_threads(p), smem);
  }
  return blocks;
}
