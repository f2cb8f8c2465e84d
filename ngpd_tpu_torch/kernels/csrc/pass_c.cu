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
// What bounds it on the H100: operations. Every (query, column) pair
// needs its distance and threshold test and the ~step_k pairs that pass
// the distance to the centre and a max; the traffic is the packs' rows
// it reads (4 a column, 6 a query) and one value a tile.
//
// Design: one block per query tile stages the window's distance rows
// (GR rows 0-3: -2p and |p|^2, which also give |p - c|^2) in shared
// memory; one thread per query walks the window; the per-tile maxima are
// reduced over the block (warp shuffles, then warps in turn) and written
// compactly as (nd, num_tiles). A max is exact, so kernel and plain
// version agree bit for bit where their masks do.
#include "passes_common.cuh"

namespace ngpd {

constexpr int C_ROWS = R_PP + 1;

__global__ void pass_c_kernel(const float* __restrict__ gq,
                              const float* __restrict__ gr,
                              const float* __restrict__ cls,
                              const float* __restrict__ scal,
                              const int* __restrict__ starts,
                              float* __restrict__ maxp, int n, int nv,
                              int tile, int wt, int nd, int dc0, int dc1,
                              int dc2) {
  extern __shared__ float sm[];  // C_ROWS rows of wt
  __shared__ float red[32];
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_rows(gr, n, s, wt, C_ROWS, sm);
  __syncthreads();

  const int dcls[3] = {dc0, dc1, dc2};
  const int jmax = min(wt, nv - s);  // columns past nv are masked
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
    const float q0 = gq[i], q1 = gq[n + i], q2 = gq[2 * n + i];
    const float qq = gq[Q_PP * n + i], rk8 = gq[Q_RKS * n + i];
    float mx = -INFINITY;
    bool gap = false;
    for (int j = 0; j < jmax; ++j) {
      const float d = pack_dist(q0, q1, q2, qq, sm, wt, j);
      if (!(d <= rk8 && d < MASKED)) {
        gap = true;
        continue;
      }
      const float m2p[3] = {sm[j], sm[wt + j], sm[2 * wt + j]};
      mx = fmaxf(mx, fadd(fadd(sm[R_PP * wt + j], dot(m2p, cen)), csq));
    }
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
  const size_t smem = prepare_launch(pass_c_kernel, C_ROWS, wt);
  pass_c_kernel<<<n / tile, pass_threads(tile), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gq), static_cast<const float*>(gr),
      static_cast<const float*>(cls), static_cast<const float*>(scal),
      static_cast<const int*>(starts), static_cast<float*>(maxp), n, nv, tile,
      wt, nd, dc0, dc1, dc2);
  return (int)cudaGetLastError();
}
