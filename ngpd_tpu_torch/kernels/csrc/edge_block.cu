// The edge-feature block of the learned models: for each edge (b, i, s)
// with neighbour j = idx[b, i, s], the row of 2C floats made of x_i and
// x_j - x_i, in one of two orders:
//   order 0, the DGCNN's   [x_j - x_i, x_i];
//   order 1, the EdgeConv's [x_i, x_j - x_i].
// x is (B, P, C) float32, idx (B, P, K) int64, the output (B, P, K, 2C).
// An index in [-P, 0) counts from the end of the patch, as torch's
// indexing takes it; one outside [-P, P) makes its difference half NaN.
//
// Replaces: ngpd_tpu/models/dgcnn.py, _edge_features (l.34), and the edge
// features of ngpd_tpu/models/edgeconv.py, EdgeConv (l.85-88) and
// DynamicEdgeConv (l.125-128). Those are XLA gathers, a subtraction and a
// concatenate under jit, not pallas_calls. In the port they were an
// advanced-index gather, an expand, a subtraction and a cat, about nine
// reads and writes of a (B, P, K, C) block; models/edge.py keeps that as
// edge_block_plain.
//
// What bounds it on the H100: bytes. It writes the (B, P, K, 2C) block
// once and reads x and idx, with one subtraction an element of the
// difference half: 4.9 GB a batch of the point track (1,024 patches,
// widths 8 to 256, K 12), far below any operation bound. The subtraction
// is exact (__fsub_rn, one rounding, as torch's), so the block equals the
// plain version's bit for bit.
//
// Design (a first port, simple and right): a block takes a run of edge
// rows (rows_per_block, at most EB_MAX_ROWS, about EB_VECTORS_A_BLOCK
// stores a block) and first finds each row's x_i and x_j offsets into
// shared memory, one thread a row, so the 64-bit divisions by K and P run
// once a row. Then its threads walk the run's output element by element in
// order, consecutive threads on consecutive addresses, so every store is
// coalesced. Where C is a multiple of 4 and x lies on 16 bytes, an element
// is a float4 (16-byte loads and stores; no vector straddles the two
// halves); otherwise (the DGCNN's first width, 17) a float. x_i and x_j are
// read again for every edge and element, from L1 and L2: x is a ninth of
// the block at K 12. Left for later: a warp a row, and the fold of the
// edge block into the product that follows it, (W_a - W_b) x_i + W_b x_j,
// which changes the rounding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ngpd {

constexpr int EB_THREADS = 256;
constexpr int EB_MAX_ROWS = 512;  // edge rows a block (their offsets in shared memory)
constexpr int EB_VECTORS_A_BLOCK = 4096;

__device__ __forceinline__ float eb_nan() { return __int_as_float(0x7fc00000); }

__device__ __forceinline__ float4 eb_sub(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z),
                     __fsub_rn(a.w, b.w));
}

// VEC: elements are float4 (c % 4 == 0, x on 16 bytes); W floats an element.
template <bool VEC>
__global__ void __launch_bounds__(EB_THREADS)
edge_block_kernel(const float* __restrict__ x, const long long* __restrict__ idx,
                  float* __restrict__ out, int p, int kk, int c, int order, long long rows,
                  int rows_per_block) {
  __shared__ long long xi_off[EB_MAX_ROWS];
  __shared__ long long xj_off[EB_MAX_ROWS];  // -1: the index is out of range
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const int nrows = (int)min((long long)rows_per_block, rows - r0);
  for (int lr = threadIdx.x; lr < nrows; lr += blockDim.x) {
    const long long r = r0 + lr;
    const long long node = r / kk;  // b * p + i
    const long long base = node - node % p;  // b * p
    long long j = idx[r];
    if (j < 0) j += p;
    xi_off[lr] = node * c;
    xj_off[lr] = (j >= 0 && j < p) ? (base + j) * c : -1;
  }
  __syncthreads();
  constexpr int W = VEC ? 4 : 1;
  const int half = c / W;  // elements a half row
  const int w = 2 * half;  // elements a row
  const int first_diff = order == 0;  // does the first half hold x_j - x_i?
  for (int e = threadIdx.x; e < nrows * w; e += blockDim.x) {
    const int lr = e / w;
    const int q = e - lr * w;
    const bool first = q < half;
    const int cq = (first ? q : q - half) * W;
    const long long xo = xi_off[lr] + cq, jo = xj_off[lr];
    float* o = out + (r0 + lr) * 2 * c + (long long)q * W;
    const bool diff = first == (first_diff != 0);
    if (VEC) {
      const float4 xi = *reinterpret_cast<const float4*>(x + xo);
      float4 v = xi;
      if (diff)
        v = jo < 0 ? make_float4(eb_nan(), eb_nan(), eb_nan(), eb_nan())
                   : eb_sub(*reinterpret_cast<const float4*>(x + jo + cq), xi);
      *reinterpret_cast<float4*>(o) = v;
    } else {
      const float xi = x[xo];
      *o = diff ? (jo < 0 ? eb_nan() : __fsub_rn(x[jo + cq], xi)) : xi;
    }
  }
}

inline bool eb_vector(const void* x, int c) {
  return c % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
}

inline int eb_rows_per_block(int c, bool vec) {
  const int w = vec ? 2 * c / 4 : 2 * c;
  const int rows = EB_VECTORS_A_BLOCK / w;
  return rows < 1 ? 1 : (rows > EB_MAX_ROWS ? EB_MAX_ROWS : rows);
}

}  // namespace ngpd

// x (b, p, c) contiguous float32; idx (b, p, kk) contiguous int64; out
// (b, p, kk, 2c) float32, every element written. order 0 writes [x_j -
// x_i, x_i], order 1 [x_i, x_j - x_i]. Anything else returns
// cudaErrorInvalidValue.
extern "C" int ngpd_edge_block_launch(const void* x, const void* idx, void* out, int b, int p,
                                      int kk, int c, int order, void* stream) {
  using namespace ngpd;
  if (b <= 0 || p <= 0 || kk <= 0 || c <= 0 || (order != 0 && order != 1))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * p * kk;
  const bool vec = eb_vector(x, c);
  const int rpb = eb_rows_per_block(c, vec);
  const long long blocks = (rows + rpb - 1) / rpb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const long long* ip = static_cast<const long long*>(idx);
  float* op = static_cast<float*>(out);
  if (vec)
    edge_block_kernel<true><<<(unsigned)blocks, EB_THREADS, 0, s>>>(xp, ip, op, p, kk, c, order,
                                                                   rows, rpb);
  else
    edge_block_kernel<false><<<(unsigned)blocks, EB_THREADS, 0, s>>>(xp, ip, op, p, kk, c,
                                                                    order, rows, rpb);
  return (int)cudaGetLastError();
}

// Blocks that one SM holds, of the variant a width c takes (c % 4 == 0:
// the float4 kernel), as the runtime counts them.
extern "C" int ngpd_edge_block_blocks_per_sm(int c) {
  using namespace ngpd;
  int blocks = 0;
  if (c % 4 == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, edge_block_kernel<true>, EB_THREADS, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, edge_block_kernel<false>, EB_THREADS,
                                                  0);
  return blocks;
}
