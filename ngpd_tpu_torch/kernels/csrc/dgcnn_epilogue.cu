// The DGCNN's eval-mode epilogue after an edge convolution's product, in
// one pass: BatchNorm with given per-channel terms, LeakyReLU (slope 0.2)
// and the max over the K neighbours,
//   out[r, c] = max_s lrelu(((h[r, s, c] - mean[c]) * mul[c]) + bias[c]),
// h (rows, K, C) float32, contiguous; mean, mul and bias (C,); out
// (rows, C). At K = 1 it is the BatchNorm and the activation alone (conv7's
// (B, P, emb_dims) product).
//
// Replaces: ngpd_tpu/models/dgcnn.py, _ConvBlock's BatchNorm, leaky_relu
// and max over neighbours (l.54-57) and bn7 with its leaky_relu (l.90-91),
// which XLA fuses under jit; no pallas_call. In the port they were five
// eager passes over every (B, P, K, C') product: h - mean, * mul and + bias
// as broadcast elementwise kernels, leaky_relu, and torch.amax over the
// neighbour axis. models/dgcnn.py keeps them as dgcnn_epilogue_plain.
//
// Rounding: each operation is rounded alone, as torch's CUDA kernels round
// it (__fsub_rn, __fmul_rn, __fadd_rn, no contraction into an FMA; the
// slope product __fmul_rn(t, 0.2f) where t <= 0, as leaky_relu computes
// a > 0 ? a : a * negval). The max is torch.amax's: a NaN accumulator
// stays and a NaN element replaces the accumulator (fmaxf would drop it),
// and the K elements fall into four accumulators, element s into s % 4,
// combined 0, 1, 2, 3, as torch's reduction kernel takes a non-innermost
// axis (vt0 = 4), so that of two equal elements (+0 and -0) it keeps the
// same one. The output equals the plain version's bit for bit.
//
// What bounds it on the H100: bytes. It reads h once and writes out once:
// at the mesh cell's shapes (2,048 patches of 64 nodes, the six edge convs
// and conv7) 4.16 GB read and 1.07 GB written a DGCNN batch, 1.56 ms at
// 3.35 TB/s; four to six operations an element, far below any operation
// bound.
//
// Design: a thread owns four channels (a float4) of a row, the threads of a
// warp consecutive quads, so a warp reads 512 contiguous bytes a neighbour.
// K is a template parameter (1, 3 and 8, the model's; 0 takes it at run
// time), and all K loads of a row are issued before the arithmetic, so 3 to
// 8 16-byte loads a thread are in flight. Loads and stores stream (__ldcs,
// __stcs): nothing is read twice. A grid-stride loop over rows, its stride
// in threads a multiple of the threads a row, keeps each thread on its own
// channels, so mean, mul and bias are read once a thread and stay in
// registers. Where C is not a multiple of 4 or h or out does not lie on 16
// bytes, a thread owns one channel.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ngpd {

constexpr int EP_THREADS = 256;
constexpr float EP_SLOPE = 0.2f;  // torch's leaky_relu negval, as float

__device__ __forceinline__ float ep_neg_inf() { return __int_as_float(0xff800000); }

// torch's MaxNanFunctor: (isnan(a) || a > b) ? a : b.
__device__ __forceinline__ float ep_max(float a, float b) { return (isnan(a) || a > b) ? a : b; }

__device__ __forceinline__ float ep_act(float x, float m, float s, float b) {
  const float t = __fadd_rn(__fmul_rn(__fsub_rn(x, m), s), b);
  return t > 0.f ? t : __fmul_rn(t, EP_SLOPE);
}

template <int W>
__device__ __forceinline__ void ep_load(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = __ldcs(p);
  }
}

template <int W>
__device__ __forceinline__ void ep_store(float* p, const float (&v)[W]) {
  if constexpr (W == 4)
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else
    __stcs(p, v[0]);
}

// KT: K, or 0 for K taken from k_run; W: channels a thread (4 or 1).
template <int KT, int W>
__global__ void __launch_bounds__(EP_THREADS)
dgcnn_epilogue_kernel(const float* __restrict__ h, const float* __restrict__ mean,
                      const float* __restrict__ mul, const float* __restrict__ bias,
                      float* __restrict__ out, int rows, int k_run, int c) {
  const int k = KT > 0 ? KT : k_run;
  const int lanes = c / W;  // threads a row
  const long long g = (long long)blockIdx.x * EP_THREADS + threadIdx.x;
  const int c0 = (int)(g % lanes) * W;
  // The grid's threads are a multiple of lanes: each thread keeps c0.
  const long long r_step = (long long)gridDim.x * EP_THREADS / lanes;
  float m[W], s[W], b[W];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    m[w] = mean[c0 + w];
    s[w] = mul[c0 + w];
    b[w] = bias[c0 + w];
  }
  for (long long r = g / lanes; r < rows; r += r_step) {
    const float* hr = h + r * k * c + c0;
    float y[W];
    if constexpr (KT == 1) {
      float x[W];
      ep_load<W>(hr, x);
#pragma unroll
      for (int w = 0; w < W; ++w) y[w] = ep_act(x[w], m[w], s[w], b[w]);
    } else {
      float acc[4][W];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[a][w] = ep_neg_inf();
      if constexpr (KT > 1) {
        float x[KT][W];
#pragma unroll
        for (int j = 0; j < KT; ++j) ep_load<W>(hr + (long long)j * c, x[j]);
#pragma unroll
        for (int j = 0; j < KT; ++j)
#pragma unroll
          for (int w = 0; w < W; ++w)
            acc[j & 3][w] = ep_max(acc[j & 3][w], ep_act(x[j][w], m[w], s[w], b[w]));
      } else {
        for (int j0 = 0; j0 < k; j0 += 4) {
          float x[4][W];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            if (j0 + a < k) ep_load<W>(hr + (long long)(j0 + a) * c, x[a]);
#pragma unroll
          for (int a = 0; a < 4; ++a)
            if (j0 + a < k)
#pragma unroll
              for (int w = 0; w < W; ++w)
                acc[a][w] = ep_max(acc[a][w], ep_act(x[a][w], m[w], s[w], b[w]));
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w)
        y[w] = ep_max(ep_max(ep_max(acc[0][w], acc[1][w]), acc[2][w]), acc[3][w]);
    }
    ep_store<W>(out + r * c + c0, y);
  }
}

inline int ep_gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <int KT, int W>
int ep_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, dgcnn_epilogue_kernel<KT, W>,
                                                EP_THREADS, 0);
  return blocks;
}

template <int KT, int W>
int ep_launch(const float* h, const float* mean, const float* mul, const float* bias, float* out,
              int rows, int k, int c, cudaStream_t stream) {
  static const int per_sm = ep_blocks_per_sm<KT, W>();
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int lanes = c / W;
  const long long needed = ((long long)rows * lanes + EP_THREADS - 1) / EP_THREADS;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  long long blocks = needed < resident ? needed : resident;
  // Blocks in units that make the grid's threads a multiple of lanes.
  const long long unit = lanes / ep_gcd(lanes, EP_THREADS);
  blocks = (blocks + unit - 1) / unit * unit;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dgcnn_epilogue_kernel<KT, W><<<(unsigned)blocks, EP_THREADS, 0, stream>>>(
      h, mean, mul, bias, out, rows, k, c);
  return (int)cudaGetLastError();
}

template <int W>
int ep_dispatch(const float* h, const float* mean, const float* mul, const float* bias,
                float* out, int rows, int k, int c, cudaStream_t s) {
  switch (k) {
    case 1: return ep_launch<1, W>(h, mean, mul, bias, out, rows, k, c, s);
    case 3: return ep_launch<3, W>(h, mean, mul, bias, out, rows, k, c, s);
    case 8: return ep_launch<8, W>(h, mean, mul, bias, out, rows, k, c, s);
    default: return ep_launch<0, W>(h, mean, mul, bias, out, rows, k, c, s);
  }
}

inline bool ep_vector(const void* h, const void* out, int c) {
  return c % 4 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(out) & 15) == 0;
}

}  // namespace ngpd

// h (rows, k, c) contiguous float32; mean, mul, bias (c,) float32; out
// (rows, c) float32, every element written. Anything else returns
// cudaErrorInvalidValue.
extern "C" int ngpd_dgcnn_epilogue_launch(const void* h, const void* mean, const void* mul,
                                          const void* bias, void* out, int rows, int k, int c,
                                          void* stream) {
  using namespace ngpd;
  if (rows <= 0 || k <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  const float* hp = static_cast<const float*>(h);
  const float* mp = static_cast<const float*>(mean);
  const float* sp = static_cast<const float*>(mul);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ep_vector(h, out, c)) return ep_dispatch<4>(hp, mp, sp, bp, op, rows, k, c, s);
  return ep_dispatch<1>(hp, mp, sp, bp, op, rows, k, c, s);
}

// Blocks that one SM holds of the variant that k and a width c take (c % 4
// == 0: the float4 kernel), as the runtime counts them.
extern "C" int ngpd_dgcnn_epilogue_blocks_per_sm(int k, int c) {
  using namespace ngpd;
  const bool vec = c % 4 == 0;
  switch (k) {
    case 1: return vec ? ep_blocks_per_sm<1, 4>() : ep_blocks_per_sm<1, 1>();
    case 3: return vec ? ep_blocks_per_sm<3, 4>() : ep_blocks_per_sm<3, 1>();
    case 8: return vec ? ep_blocks_per_sm<8, 4>() : ep_blocks_per_sm<8, 1>();
    default: return vec ? ep_blocks_per_sm<0, 4>() : ep_blocks_per_sm<0, 1>();
  }
}
