// Pass C of the four-pass denoise: per tile and per delta class, the
// largest squared distance |p_j - centre|^2 over the pairs d <= rk_step of
// that class's valid rows, with 0 for masked pairs as in the reference's
// max over the masked tile; the driver takes the delta as the square root
// of the largest over the tiles.
//
// Replaces: ngpd_tpu/core/pallas_fused.py:356, _make_pass_c (the
// pallas_call at l.1001 in pallas_denoise). The centre of the ci-th class
// of needs_delta is read from scal[4 + ci, 0:3], and the class row of the
// cls pack decides which centre a row is held to (l.384-394).
//
// What bounds it on the H100: operations. Every (query, column) pair of a
// delta-class row needs its distance and threshold test and the ~step_k
// pairs that pass the distance to the centre and a max; the traffic is
// the packs' rows it reads (4 a column, 6 a query) and one value a tile.
//
// Design: pass D's one-threshold walk (pass_walk.cuh). One block per
// query tile stages the window's distance rows (GR rows 0-3: -2p and
// |p|^2, which also give |p - c|^2) in shared memory at a pitch of whole
// 32-column words, one thread a query. A row that is not of a delta class
// skips the window. The others scan it chunk by chunk, branch-free, against
// rk_step alone into bit words and walk their set bits in one flat loop,
// taking the max of |p_j|^2 + (-2p_j).c + |c|^2; fewer passing columns
// than valid ones leave a masked pair, which puts 0 into the max. The
// per-tile maxima are reduced over the block (warp shuffles, then warps in
// turn) and written compactly as (nd, num_tiles). A max is exact, so
// kernel and plain version agree bit for bit where their masks do, and the
// masks must, so there is no wgmma here (walk_common.cuh).
//
// Measured at 1M points, tile 256, 512 columns (kernel_lab.py, NVIDIA H100
// 80GB HBM3 at 700 W, one call): 0.35 ms a launch where one walk over all
// columns with an early `continue` took 0.535 ms. The scan takes ~0.26 ms
// (nothing else in the kernel hides it, as the per-point math does in A
// and D), the walk of the ~8 passing columns 0.014 ms, staging 0.02 ms, the
// rows' reads and the block reduction ~0.055 ms. ptxas: 64 registers, no
// spill, four blocks of 256 threads an SM; bounds of two or three blocks
// leave the registers at 64, six (40 registers, 58 bytes spilled) are no
// faster.
#include "pass_walk.cuh"

namespace ngpd {

constexpr int C_MIN_BLOCKS = 4;  // blocks an SM
constexpr int C_ROWS = R_PP + 1;

__global__ void __launch_bounds__(256, C_MIN_BLOCKS)
pass_c_kernel(const float* __restrict__ gq, const float* __restrict__ gr,
              const float* __restrict__ cls, const float* __restrict__ scal,
              const int* __restrict__ starts, float* __restrict__ maxp, int n,
              int nv, int tile, int wt, int wp, int nd, int dc0, int dc1,
              int dc2) {
  // C_ROWS rows of wp, then one chunk's bit words, one a (word, thread).
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  unsigned* cbits = reinterpret_cast<unsigned*>(sm + C_ROWS * wp) + threadIdx.x;
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_rows_pitched<C_ROWS>(gr, n, s, wt, wp, sm);
  __syncthreads();

  const int dcls[3] = {dc0, dc1, dc2};
  const int jmax = min(wt, nv - s);  // columns past nv are masked
  const int nwords = jmax > 0 ? (jmax + 31) >> 5 : 0;
  float best[3] = {-INFINITY, -INFINITY, -INFINITY};
  // zero[k]: the tile has a pair masked for class k, which adds 0 to the
  // reference's max. Columns past nv are masked in every row.
  bool zero[3] = {jmax < wt, jmax < wt, jmax < wt};
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int i = blk * tile + r;
    const float c_i = cls[i];
    int ci = -1;
    for (int k = 0; k < nd; ++k)
      if (c_i == (float)dcls[k] && i < nv) ci = k;
    // A row is masked in every column for the classes it is not of.
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k != ci) zero[k] = true;
    if (ci < 0) continue;
    const float cen[3] = {scal[(4 + ci) * 128], scal[(4 + ci) * 128 + 1],
                          scal[(4 + ci) * 128 + 2]};
    const float csq = dot(cen, cen);
    const float q[3] = {gq[i], gq[n + i], gq[2 * n + i]};
    const float qq = gq[Q_PP * n + i];
    const float thr_s = mask_threshold(gq[Q_RKS * n + i]);
    float mx = -INFINITY;
    int seen = 0;  // passing columns; fewer than jmax leaves a masked pair
    walk_step_bits<false>(sm, wp, nwords, jmax, nullptr, cbits, q, qq, thr_s, [&](int j) {
      const float m2p[3] = {sm[j], sm[wp + j], sm[2 * wp + j]};
      mx = fmaxf(mx, fadd(fadd(sm[R_PP * wp + j], dot(m2p, cen)), csq));
      ++seen;
    });
    const bool gap = seen < jmax;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k == ci) {
        best[k] = fmaxf(best[k], mx);
        zero[k] = zero[k] || gap;
      }
  }
  const int num_tiles = n / tile;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    if (k >= nd) break;  // nd is the same in every thread
    const float tot = block_reduce(best[k], true, red);
    const float any_zero = block_reduce(zero[k] ? 1.0f : 0.0f, true, red);
    if (threadIdx.x == 0)
      maxp[k * num_tiles + blk] = any_zero > 0.0f ? fmaxf(tot, 0.0f) : tot;
  }
}

static void c_allow(size_t smem) {
  static size_t allowed = 0;
  allow_smem(pass_c_kernel, smem, allowed);
}

}  // namespace ngpd

// gq, gr: (16, n), (24, n) post-pass-A packs; cls: (4, n) from pass B;
// scal: (8, 128) with the centres; starts: (n / tile,) int32; maxp:
// (nd, n / tile); dc0-dc2: the delta classes, -1 past nd.
extern "C" int ngpd_pass_c_launch(const void* gq, const void* gr,
                                  const void* cls, const void* scal,
                                  const void* starts, void* maxp, int n,
                                  int nv, int tile, int wt, int nd, int dc0,
                                  int dc1, int dc2, void* stream) {
  using namespace ngpd;
  const size_t smem = walk_smem(tile, wt, false, C_ROWS);
  c_allow(smem);
  pass_c_kernel<<<n / tile, pass_threads(tile), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gq), static_cast<const float*>(gr),
      static_cast<const float*>(cls), static_cast<const float*>(scal),
      static_cast<const int*>(starts), static_cast<float*>(maxp), n, nv, tile,
      wt, round_up32(wt), nd, dc0, dc1, dc2);
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds at this geometry, as the runtime
// counts them from its registers and shared memory.
extern "C" int ngpd_pass_c_blocks_per_sm(int tile, int wt) {
  using namespace ngpd;
  int blocks = 0;
  const size_t smem = walk_smem(tile, wt, false, C_ROWS);
  c_allow(smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pass_c_kernel,
                                                pass_threads(tile), smem);
  return blocks;
}
