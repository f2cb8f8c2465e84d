// K2 of the hybrid denoise: every class-independent window sum that the
// per-point update stage needs, over the post-VU pack [p, f, rkf, rks].
//
// Replaces: ngpd_tpu/core/pallas_fused.py, _make_k2 (the pallas_call in
// pallas_denoise_hybrid). Rows, in the order of _k2_layout:
//   t6 (6)    filtered NVT2 over d <= rk_feat, with the zero-weight rescue
//   s6 (6)    sum n_j n_j^T        \
//   b_nv (3)  sum n_j (n_j.p_j)     | over the step mask m8: d <= rk_step
//   sv (3)    sum p_j              /
//   q18 (18)  EDGE: Q[c,a,b] = sum n_c n_a p_b, pairs c <= a
//   flat (2)  FLAT: bilateral numerator and denominator, delta = scal[1,0]
//   new (12)  NEW: likelihood-weighted s6, b_nv, sv, delta = scal[2,0]
//   deg (1)   sum m8
//   maxd (nd) per lagged class ci: max over m8 of |p_j - centre_ci|^2
//             (centre in scal[4+ci, 0:3]), with 0 where masked
//   zero rows up to a multiple of 8.
//
// What bounds it on the H100: operations. Every (query, column) pair
// needs its distance and two threshold tests; the ~step_k and
// ~feature_k columns that pass add up to ~60 sums, three exps among
// them. Traffic is 32 bytes read and 4*rows written a point. The
// distances must match the plain version bit for bit, so the pairs run on
// the float32 pipes: TF32 keeps 10 mantissa bits and a split-TF32 product
// is not bit-equal either, so wgmma has no place here.
//
// Design: one block per query tile with the window's -2p, |p|^2, n and
// p.n staged in shared memory (stage_slim, as K1 stages it) and one thread
// per query. The walk is walk_common.cuh's, in chunks of 16 words of 32
// columns. Scan: per word a warp first asks whether the word's bounding
// box can reach any of its queries and skips it if not; else each lane
// computes the word's 32 distances branch-free and keeps a feature and a
// step bit word in shared memory. Accumulate: each lane visits its own
// feature bits of the chunk (NVT2 sums, the angle filter on a recomputed
// distance: nvt_slim_column, K1's column body), then its own step bits
// (s6 ... maxd), each in one flat loop from the lowest bit up.
// Every sum belongs to one of the two loops and is taken in ascending
// column order, as a walk over all columns takes it, so the output equals
// that walk's bit for bit. All accumulators stay in registers; the lagged
// classes' centres are read from shared memory where they are used. The
// strategy's variants are template flags (FLAT, EDGE, NEW) and the count of
// lagged classes nd (0-3) a runtime argument.
//
// Measured at 1M points, tile 256, 512 columns (kernel_lab.py, NVIDIA H100
// 80GB HBM3 at 700 W): 0.64 ms a launch where one walk over all columns
// with an early `continue` took 2.27 ms; the per-word bit walk alone
// 1.03 ms (a warp then waits for the busiest lane of every word, 102
// turns a warp where the flat loop takes ~45), the word skip 5% of the
// rest. The scan takes 0.24 ms, the two accumulations 0.28 ms, the output
// rows 0.10 ms, staging 0.02 ms. ptxas: 127 registers and no spill for
// FLAT + EDGE, two blocks of 256 threads an SM; bounding it to three
// blocks spills 252 bytes and is slower (0.75 ms), as is taking two or
// four set bits a turn side by side (registers again).
#include "walk_common.cuh"

namespace ngpd {

constexpr int K2_MIN_BLOCKS = 2;  // blocks an SM: three spill and are slower

template <bool FLAT, bool EDGE, bool NEW>
__global__ void __launch_bounds__(256, K2_MIN_BLOCKS)
k2_kernel(const float* __restrict__ pack, const int* __restrict__ starts,
          const float* __restrict__ scal, float* __restrict__ out, int n,
          int nv, int tile, int wt_c, int wp, float cos_rho, int nd,
          int total) {
  // K_ROWS rows of wp, BOX_FLOATS a word, then one chunk's feature and
  // step bit words, one a (word, thread).
  extern __shared__ __align__(16) float sm[];
  __shared__ float cen[3][4];  // lagged class ci: centre x, y, z, |centre|^2
  float* boxes = sm + K_ROWS * wp;
  unsigned* fbits = reinterpret_cast<unsigned*>(boxes + BOX_FLOATS * (wp >> 5)) + threadIdx.x;
  unsigned* sbits = fbits + CHUNK_WORDS * blockDim.x;
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_slim(pack, n, s, wt_c, wp, sm);
  if (threadIdx.x < 3) {
    const int ci = threadIdx.x;
    float c[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) c[k] = ci < nd ? scal[(4 + ci) * 128 + k] : 0.0f;
    cen[ci][0] = c[0];
    cen[ci][1] = c[1];
    cen[ci][2] = c[2];
    cen[ci][3] = sq_norm3(c[0], c[1], c[2]);
  }
  __syncthreads();
  reduce_word_boxes(sm, wp, boxes);
  __syncthreads();

  // Lag state (scal is (8, 128)).
  float d2_flat = 0.0f, d2_new = 0.0f;
  if constexpr (FLAT) {
    const float dl = scal[1 * 128];
    d2_flat = fmaxf(__fmul_rn(dl, dl), 1e-30f);
  }
  if constexpr (NEW) {
    const float dl = scal[2 * 128];
    d2_new = fmaxf(__fmul_rn(dl, dl), 1e-30f);
  }

  const int jmax = min(wt_c, nv - s);  // columns past nv are masked
  const int nwords = jmax > 0 ? (jmax + 31) >> 5 : 0;
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int i = blk * tile + r;
    const float q0 = pack[i], q1 = pack[n + i], q2 = pack[2 * n + i];
    const float m0 = pack[3 * n + i], m1 = pack[4 * n + i],
                m2 = pack[5 * n + i];
    const float p2q = sq_norm3(q0, q1, q2);
    const float thr_f = mask_threshold(pack[6 * n + i]);
    const float thr_s = mask_threshold(pack[7 * n + i]);
    const WarpBox wb = warp_box(q0, q1, q2, p2q, fmaxf(thr_f, thr_s));

    NvtSums nvt{};  // every sum 0
    float s6[6] = {0.f}, bnv[3] = {0.f}, sv[3] = {0.f}, deg = 0.0f;
    float q18[18] = {0.f};  // dead unless EDGE
    float fl_num = 0.0f, fl_den = 0.0f;
    float nw[12] = {0.f};  // dead unless NEW
    float maxd[3] = {-INFINITY, -INFINITY, -INFINITY};
    // A masked column adds m8f * dist2 = 0 to the reference's max.
    bool zero_seen = jmax < wt_c;

    for (int w0 = 0; w0 < nwords; w0 += CHUNK_WORDS) {
      // The scan of one chunk: bit words to shared memory.
      unsigned nz_f = 0u, nz_s = 0u;
      const int cw = min(CHUNK_WORDS, nwords - w0);
      for (int wl = 0; wl < cw; ++wl) {
        const int j0 = (w0 + wl) << 5;
        if (word_skippable(wb, boxes + (w0 + wl) * BOX_FLOATS)) {
          zero_seen = true;
          continue;
        }
        const unsigned valid = word_valid(jmax - j0);
        unsigned bf, bs;
        scan_word(sm, wp, j0, q0, q1, q2, p2q, thr_f, thr_s, bf, bs);
        bf &= valid;
        bs &= valid;
        if (bs != valid) zero_seen = true;
        if (bf) {
          fbits[wl * blockDim.x] = bf;
          nz_f |= 1u << wl;
        }
        if (bs) {
          sbits[wl * blockDim.x] = bs;
          nz_s |= 1u << wl;
        }
      }

      // The feature bits: NVT2 with the angle filter.
      walk_chunk(fbits, blockDim.x, nz_f, w0 << 5, [&](int j) {
        nvt_slim_column(sm, wp, j, q0, q1, q2, p2q, cos_rho, nvt);
      });

      // The step bits: the update stage's sums.
      walk_chunk(sbits, blockDim.x, nz_s, w0 << 5, [&](int j) {
        const float n0 = sm[K_N * wp + j], n1 = sm[(K_N + 1) * wp + j],
                    n2 = sm[(K_N + 2) * wp + j];
        const float pn = sm[K_PN * wp + j];
        // p from -2p: halving is exact.
        const float pp[3] = {-0.5f * sm[K_M2P * wp + j],
                             -0.5f * sm[(K_M2P + 1) * wp + j],
                             -0.5f * sm[(K_M2P + 2) * wp + j]};
        const float sym[6] = {__fmul_rn(n0, n0), __fmul_rn(n0, n1),
                              __fmul_rn(n0, n2), __fmul_rn(n1, n1),
                              __fmul_rn(n1, n2), __fmul_rn(n2, n2)};
        const float nnv[3] = {__fmul_rn(n0, pn), __fmul_rn(n1, pn),
                              __fmul_rn(n2, pn)};
        const float dotj = __fsub_rn(pn, dot3(q0, q1, q2, n0, n1, n2));
#pragma unroll
        for (int c = 0; c < 6; ++c) s6[c] = __fadd_rn(s6[c], sym[c]);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          bnv[c] = __fadd_rn(bnv[c], nnv[c]);
          sv[c] = __fadd_rn(sv[c], pp[c]);
        }
        deg = __fadd_rn(deg, 1.0f);
        if constexpr (EDGE) {
          // Pairs (c, a) with c <= a in the order 00 01 02 11 12 22: n_c n_a
          // is sym.
#pragma unroll
          for (int k = 0; k < 6; ++k)
#pragma unroll
            for (int b = 0; b < 3; ++b)
              q18[k * 3 + b] = __fadd_rn(q18[k * 3 + b], __fmul_rn(sym[k], pp[b]));
        }
        if constexpr (FLAT) {
          const float d = col_dist(sm, wp, j, q0, q1, q2, p2q);
          const float ninj = dot3(m0, m1, m2, n0, n1, n2);
          const float sim = expf(__fdiv_rn(
              __fmul_rn(-16.0f, __fsub_rn(2.0f, __fmul_rn(2.0f, ninj))),
              d2_flat));
          const float close = expf(__fdiv_rn(__fmul_rn(-4.0f, d), d2_flat));
          const float wbl = __fmul_rn(sim, close);
          fl_num = __fadd_rn(fl_num, __fmul_rn(wbl, dotj));
          fl_den = __fadd_rn(fl_den, wbl);
        }
        if constexpr (NEW) {
          const float like = expf(__fdiv_rn(
              __fmul_rn(__fmul_rn(-9.0f, dotj), dotj), d2_new));
#pragma unroll
          for (int c = 0; c < 6; ++c)
            nw[c] = __fadd_rn(nw[c], __fmul_rn(like, sym[c]));
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            nw[6 + c] = __fadd_rn(nw[6 + c], __fmul_rn(like, nnv[c]));
            nw[9 + c] = __fadd_rn(nw[9 + c], __fmul_rn(like, pp[c]));
          }
        }
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
          if (ci < nd) {
            const float dist2 = __fadd_rn(
                __fsub_rn(sm[K_PP * wp + j],
                          __fmul_rn(2.0f, dot3(pp[0], pp[1], pp[2], cen[ci][0],
                                               cen[ci][1], cen[ci][2]))),
                cen[ci][3]);
            maxd[ci] = fmaxf(maxd[ci], dist2);
          }
        }
      });
    }

    // Write the rows in _k2_layout order.
    int row = 0;
    float t6[6];
    nvt_mean(nvt, t6);
#pragma unroll
    for (int c = 0; c < 6; ++c) out[(row++) * n + i] = t6[c];
#pragma unroll
    for (int c = 0; c < 6; ++c) out[(row++) * n + i] = s6[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) out[(row++) * n + i] = bnv[c];
#pragma unroll
    for (int c = 0; c < 3; ++c) out[(row++) * n + i] = sv[c];
    if constexpr (EDGE) {
#pragma unroll
      for (int c = 0; c < 18; ++c) out[(row++) * n + i] = q18[c];
    }
    if constexpr (FLAT) {
      out[(row++) * n + i] = fl_num;
      out[(row++) * n + i] = fl_den;
    }
    if constexpr (NEW) {
#pragma unroll
      for (int c = 0; c < 12; ++c) out[(row++) * n + i] = nw[c];
    }
    out[(row++) * n + i] = deg;
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
      if (ci < nd)
        out[(row++) * n + i] = zero_seen ? fmaxf(maxd[ci], 0.0f) : maxd[ci];
    for (; row < total; ++row) out[row * n + i] = 0.0f;
  }
}

static int k2_threads(int tile) { return tile < 256 ? tile : 256; }

static size_t k2_smem(int tile, int wt_c) {
  const int wp = round_up32(wt_c);
  return sizeof(float) * ((size_t)K_ROWS * wp + (size_t)BOX_FLOATS * (wp >> 5) +
                          2 * (size_t)CHUNK_WORDS * k2_threads(tile));
}

// Shared memory above 48 KB is allowed once a variant and window size.
template <bool FLAT, bool EDGE, bool NEW>
static void k2_allow(size_t smem) {
  static size_t allowed = 0;
  allow_smem(k2_kernel<FLAT, EDGE, NEW>, smem, allowed);
}

template <bool FLAT, bool EDGE, bool NEW>
static void launch_k2(const float* pack, const int* starts, const float* scal,
                      float* out, int n, int nv, int tile, int wt_c,
                      float cos_rho, int nd, int total, cudaStream_t stream) {
  const size_t smem = k2_smem(tile, wt_c);
  k2_allow<FLAT, EDGE, NEW>(smem);
  k2_kernel<FLAT, EDGE, NEW><<<n / tile, k2_threads(tile), smem, stream>>>(
      pack, starts, scal, out, n, nv, tile, wt_c, round_up32(wt_c), cos_rho,
      nd, total);
}

template <bool FLAT, bool EDGE, bool NEW>
static int blocks_k2(int tile, int wt_c) {
  int blocks = 0;
  k2_allow<FLAT, EDGE, NEW>(k2_smem(tile, wt_c));
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k2_kernel<FLAT, EDGE, NEW>, k2_threads(tile), k2_smem(tile, wt_c));
  return blocks;
}

}  // namespace ngpd

#define K2_DISPATCH(CALL)                                                    \
  switch ((use_flat ? 4 : 0) | (use_edge ? 2 : 0) | (use_new ? 1 : 0)) {     \
    case 0: CALL(false, false, false) break;                                 \
    case 1: CALL(false, false, true) break;                                  \
    case 2: CALL(false, true, false) break;                                  \
    case 3: CALL(false, true, true) break;                                   \
    case 4: CALL(true, false, false) break;                                  \
    case 5: CALL(true, false, true) break;                                   \
    case 6: CALL(true, true, false) break;                                   \
    case 7: CALL(true, true, true) break;                                    \
  }

// pack: (8, n) post-VU pack [p, f, rkf, rks]; starts: (n / tile,) int32
// window starts; scal: (8, 128) lag state; out: (total, n).
extern "C" int ngpd_k2_launch(const void* pack, const void* starts,
                              const void* scal, void* out, int n, int nv,
                              int tile, int wt_c, float cos_rho, int use_flat,
                              int use_edge, int use_new, int nd, int total,
                              void* stream) {
  using namespace ngpd;
  const float* p = static_cast<const float*>(pack);
  const int* st = static_cast<const int*>(starts);
  const float* sc = static_cast<const float*>(scal);
  float* o = static_cast<float*>(out);
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
#define K2_LAUNCH(F, E, W) \
  launch_k2<F, E, W>(p, st, sc, o, n, nv, tile, wt_c, cos_rho, nd, total, cs);
  K2_DISPATCH(K2_LAUNCH)
#undef K2_LAUNCH
  return (int)cudaGetLastError();
}

// Blocks of the variant's kernel that one SM holds at this geometry, as
// the runtime counts them from its registers and shared memory.
extern "C" int ngpd_k2_blocks_per_sm(int tile, int wt_c, int use_flat,
                                     int use_edge, int use_new) {
  using namespace ngpd;
  int blocks = 0;
#define K2_BLOCKS(F, E, W) blocks = blocks_k2<F, E, W>(tile, wt_c);
  K2_DISPATCH(K2_BLOCKS)
#undef K2_BLOCKS
  return blocks;
}
