// K1, filtered NVT1 of the hybrid denoise: per point i, over the window
// columns j with d_ij <= rk_feat_i, keep those whose normal is at an
// angle to the offset, |n_j.(p_j - p_i)| / |p_j - p_i| < cos(angle), and
// fall back to all of them where none is kept (the zero-weight rescue);
// output the six sums of n_j n_j^T over the kept count.
//
// Replaces: ngpd_tpu/core/pallas_fused.py, _make_k1 (the pallas_call in
// pallas_denoise_hybrid). Output pack (8, n): t6 rows 0-5, rows 6-7 zero.
//
// What bounds it on the H100: operations. Every (query, column) pair
// needs its distance and threshold test; the ~feature_k columns that
// pass add the angle test and twelve sums. Traffic is 64 bytes a point.
// The masks must match the plain version bit for bit, so the distances
// run on the float32 pipes and there is no wgmma here (walk_common.cuh).
//
// Design: K2's walk over its feature bits (walk_common.cuh). One block per
// query tile stages the slim window (-2p, |p|^2, n, p.n: stage_slim) at a
// pitch of whole words and reduces each word's bounding box, one thread
// per query. In chunks of 16 words of 32 columns a warp skips the words
// whose box cannot reach any of its queries (K2's word skip); each lane
// scans the others' distances against mask_threshold(rk_feat) branch-free
// into bit words in shared memory, then visits its own set bits from the
// lowest up in one flat loop (walk_chunk) with K2's column body
// (nvt_slim_column). The sums are taken over the passing columns in
// ascending column order, as a walk over all columns with an early
// `continue` takes them, so the output is that walk's bit for bit.
//
// Measured at 1M points, 512 columns, feature_k 32 (kernel_lab.py, NVIDIA
// H100 80GB HBM3 at 700 W): 0.40-0.42 ms a launch where one thread walking
// every column with an early `continue` took 0.85-0.88 ms in the same
// calls; the word skip gives 4% (0.41 without it), and 22% at the CLI's
// 1,280 columns (0.60 against 0.78 ms). ptxas: 72 registers, no spill,
// three blocks of 256 threads an SM (K1_MIN_BLOCKS; two or four were no
// faster).
#include "walk_common.cuh"

namespace ngpd {

constexpr int K1_MIN_BLOCKS = 3;  // blocks an SM

__global__ void __launch_bounds__(256, K1_MIN_BLOCKS)
k1_kernel(const float* __restrict__ pack, const int* __restrict__ starts,
          float* __restrict__ out, int n, int nv, int tile, int wt_c, int wp,
          float cos_rho) {
  // K_ROWS rows of wp, BOX_FLOATS a word, then one chunk's feature bit
  // words, one a (word, thread).
  extern __shared__ __align__(16) float sm[];
  float* boxes = sm + K_ROWS * wp;
  unsigned* fbits = reinterpret_cast<unsigned*>(boxes + BOX_FLOATS * (wp >> 5)) + threadIdx.x;
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_slim(pack, n, s, wt_c, wp, sm);
  __syncthreads();
  reduce_word_boxes(sm, wp, boxes);
  __syncthreads();

  const int jmax = min(wt_c, nv - s);  // columns past nv are masked
  const int nwords = jmax > 0 ? (jmax + 31) >> 5 : 0;
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int i = blk * tile + r;
    const float q0 = pack[i], q1 = pack[n + i], q2 = pack[2 * n + i];
    const float p2q = sq_norm3(q0, q1, q2);
    const float thr = mask_threshold(pack[6 * n + i]);
    const WarpBox wb = warp_box(q0, q1, q2, p2q, thr);
    NvtSums nvt{};  // every sum 0
    for (int w0 = 0; w0 < nwords; w0 += CHUNK_WORDS) {
      unsigned nz = 0u;
      const int cw = min(CHUNK_WORDS, nwords - w0);
      for (int wl = 0; wl < cw; ++wl) {
        const int j0 = (w0 + wl) << 5;
        if (word_skippable(wb, boxes + (w0 + wl) * BOX_FLOATS)) continue;
        const unsigned bits =
            scan_word(sm, wp, j0, q0, q1, q2, p2q, thr) & word_valid(jmax - j0);
        if (bits) {
          fbits[wl * blockDim.x] = bits;
          nz |= 1u << wl;
        }
      }
      walk_chunk(fbits, blockDim.x, nz, w0 << 5, [&](int j) {
        nvt_slim_column(sm, wp, j, q0, q1, q2, p2q, cos_rho, nvt);
      });
    }
    float t6[6];
    nvt_mean(nvt, t6);
#pragma unroll
    for (int c = 0; c < 6; ++c) out[c * n + i] = t6[c];
    out[6 * n + i] = 0.0f;
    out[7 * n + i] = 0.0f;
  }
}

static int k1_threads(int tile) { return tile < 256 ? tile : 256; }

static size_t k1_smem(int tile, int wt_c) {
  const int wp = round_up32(wt_c);
  return sizeof(float) * ((size_t)K_ROWS * wp + (size_t)BOX_FLOATS * (wp >> 5) +
                          (size_t)CHUNK_WORDS * k1_threads(tile));
}

// Shared memory above 48 KB is allowed once a window size.
static void k1_allow(size_t smem) {
  static size_t allowed = 0;
  allow_smem(k1_kernel, smem, allowed);
}

}  // namespace ngpd

// pack: (8, n) slim pack [p, n, rk_feat, rk_step]; starts: (n / tile,)
// int32 window starts; out: (8, n).
extern "C" int ngpd_k1_launch(const void* pack, const void* starts, void* out,
                              int n, int nv, int tile, int wt_c, float cos_rho,
                              void* stream) {
  using namespace ngpd;
  const size_t smem = k1_smem(tile, wt_c);
  k1_allow(smem);
  k1_kernel<<<n / tile, k1_threads(tile), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pack), static_cast<const int*>(starts),
      static_cast<float*>(out), n, nv, tile, wt_c, round_up32(wt_c), cos_rho);
  return (int)cudaGetLastError();
}

// Blocks of the kernel that one SM holds at this geometry, as the runtime
// counts them from its registers and shared memory.
extern "C" int ngpd_k1_blocks_per_sm(int tile, int wt_c) {
  using namespace ngpd;
  int blocks = 0;
  k1_allow(k1_smem(tile, wt_c));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k1_kernel, k1_threads(tile),
                                                k1_smem(tile, wt_c));
  return blocks;
}
