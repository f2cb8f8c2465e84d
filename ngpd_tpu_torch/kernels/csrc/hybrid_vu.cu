// The hybrid engine's VU stage: the filtered-NVT rows t6 and the slim pack
// [p, n, rk_feat, rk_step] in, the post-VU pack [p, f, rk_feat, rk_step]
// out, one thread a point.
//
// Replaces: ngpd_tpu/core/pallas_fused.py, _xla_vu_stage (the XLA fusion
// between K1 and K2 of pallas_denoise_hybrid). Its plain version is
// ngpd_tpu_torch/core/hybrid_stages.py::vu_stage, which the CPU runs.
//
// What bounds it on the H100: bytes. A point reads 6 rows of t6 and 8 of
// the pack and writes 8 rows, 88 bytes, against some 200 operations of
// the eigenvalues and the projector form; at 1M points that is 0.03 ms of
// traffic. Eager torch ran the same map as some 300 kernels of one
// operation each, every one a round trip of its rows through device
// memory and a launch from the host.
//
// Design: one thread a point, each row read and written once with
// neighbouring threads on neighbouring columns. t6 is K1's output or rows
// of K2's (under lagged NVT1), read through its row pitch. The arithmetic
// is ops/eigh3.py::vu_filter_components operation for operation: the
// eigenvalues (eigen_roots<true>: acosf, and x / 3.0 as PyTorch's CUDA
// kernels compute it), then normalize(damping n + P n) with P the sum of
// the eigenprojectors whose eigenvalue exceeds tau, each product and sum
// rounded on its own, so the output equals the eager stage's on the card.
// The tensor cores have nothing to do here (no product of matrices), so
// no wgmma.
#include "passes_common.cuh"

namespace ngpd {

constexpr int VU_THREADS = 256;

// ops/eigh3.py::vu_filter_components: f = normalize(damping n + P n).
__device__ __forceinline__ void vu_filter(const float a[6], const float n[3],
                                          float tau, float damping, float f[3]) {
  float lam[3];
  unscale(eigen_roots<true>(a), lam);
  // A n and A (A n), A = [[a0 a1 a2] [a1 a3 a4] [a2 a4 a5]].
  const float u[3] = {fadd(fadd(fmul(a[0], n[0]), fmul(a[1], n[1])), fmul(a[2], n[2])),
                      fadd(fadd(fmul(a[1], n[0]), fmul(a[3], n[1])), fmul(a[4], n[2])),
                      fadd(fadd(fmul(a[2], n[0]), fmul(a[4], n[1])), fmul(a[5], n[2]))};
  const float z[3] = {fadd(fadd(fmul(a[0], u[0]), fmul(a[1], u[1])), fmul(a[2], u[2])),
                      fadd(fadd(fmul(a[1], u[0]), fmul(a[3], u[1])), fmul(a[4], u[2])),
                      fadd(fadd(fmul(a[2], u[0]), fmul(a[4], u[1])), fmul(a[5], u[2]))};
  const float k = fadd(fadd(lam[0] > tau ? 1.0f : 0.0f, lam[1] > tau ? 1.0f : 0.0f),
                       lam[2] > tau ? 1.0f : 0.0f);
  float pn[3] = {0.0f, 0.0f, 0.0f};
  if (k == 1.0f || k == 2.0f) {
    // The projector onto the eigenvector of lam_a: (A - lb)(A - lc) n over
    // (lam_a - lb)(lam_a - lc); k == 1 takes the largest root's, k == 2
    // n minus the smallest root's.
    const float la = k == 1.0f ? lam[2] : lam[0];
    const float lb = k == 1.0f ? lam[0] : lam[1];
    const float lc = k == 1.0f ? lam[1] : lam[2];
    const float den = fmul(fsub(la, lb), fsub(la, lc));
    const float inv = fdiv(den, fmaxf(fmul(den, den), EPS));
    const float bc = fadd(lb, lc), lbc = fmul(lb, lc);
    for (int c = 0; c < 3; ++c) {
      const float pc = fmul(fadd(fsub(z[c], fmul(bc, u[c])), fmul(lbc, n[c])), inv);
      pn[c] = k == 1.0f ? pc : fsub(n[c], pc);
    }
  } else if (k == 3.0f) {
    for (int c = 0; c < 3; ++c) pn[c] = n[c];
  }
  float acc[3];
  for (int c = 0; c < 3; ++c) acc[c] = fadd(fmul(damping, n[c]), pn[c]);
  const float inv = fdiv(1.0f, __fsqrt_rn(fmaxf(dot(acc, acc), EPS)));
  for (int c = 0; c < 3; ++c) f[c] = fmul(acc[c], inv);
}

__global__ void __launch_bounds__(VU_THREADS)
hybrid_vu_kernel(const float* __restrict__ t6, int pitch,
                 const float* __restrict__ pack, float* __restrict__ out, int n,
                 float tau, float damping) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a[6], nrm[3], f[3];
#pragma unroll
  for (int r = 0; r < 6; ++r) a[r] = t6[(size_t)r * pitch + i];
#pragma unroll
  for (int c = 0; c < 3; ++c) nrm[c] = pack[(size_t)(3 + c) * n + i];
  vu_filter(a, nrm, tau, damping, f);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    out[(size_t)c * n + i] = pack[(size_t)c * n + i];
    out[(size_t)(3 + c) * n + i] = f[c];
  }
  out[(size_t)6 * n + i] = pack[(size_t)6 * n + i];
  out[(size_t)7 * n + i] = pack[(size_t)7 * n + i];
}

}  // namespace ngpd

// t6: rows 0-5 the filtered-NVT sums, `pitch` floats apart; pack: (8, n)
// slim pack; out: (8, n) post-VU pack, a buffer of its own.
extern "C" int ngpd_hybrid_vu_launch(const void* t6, int pitch, const void* pack,
                                     void* out, int n, float tau, float damping,
                                     void* stream) {
  using namespace ngpd;
  if (n <= 0) return 0;
  hybrid_vu_kernel<<<(n + VU_THREADS - 1) / VU_THREADS, VU_THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t6), pitch, static_cast<const float*>(pack),
      static_cast<float*>(out), n, tau, damping);
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds, as the runtime counts them.
extern "C" int ngpd_hybrid_vu_blocks_per_sm() {
  int blocks = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ngpd::hybrid_vu_kernel,
                                                ngpd::VU_THREADS, 0);
  return blocks;
}
