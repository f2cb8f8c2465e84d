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
// them. Traffic is 32 bytes read and 4*rows written a point.
//
// Design: as K1, one block per query tile with the window's p, n, |p|^2
// and p.n staged in shared memory and one thread per query, all
// accumulators in registers (about 60 at the default strategy). The
// strategy's variants are template flags (FLAT, EDGE, NEW) and the
// count of lagged classes nd (0-3) a runtime argument.
#include "window_common.cuh"

namespace ngpd {

template <bool FLAT, bool EDGE, bool NEW>
__global__ void k2_kernel(const float* __restrict__ pack,
                          const int* __restrict__ starts,
                          const float* __restrict__ scal,
                          float* __restrict__ out, int n, int nv, int tile,
                          int wt_c, float cos_rho, int nd, int total) {
  extern __shared__ float sm[];  // W_ROWS rows of wt_c
  const int blk = blockIdx.x;
  const int s = starts[blk];
  stage_window<W_ROWS>(pack, n, s, wt_c, sm);
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
  float cen[3][3], csq[3];
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) {
    const bool on = ci < nd;
#pragma unroll
    for (int c = 0; c < 3; ++c) cen[ci][c] = on ? scal[(4 + ci) * 128 + c] : 0.0f;
    csq[ci] = sq_norm3(cen[ci][0], cen[ci][1], cen[ci][2]);
  }

  const int jmax = min(wt_c, nv - s);  // columns past nv are masked
  for (int r = threadIdx.x; r < tile; r += blockDim.x) {
    const int i = blk * tile + r;
    const float q0 = pack[i], q1 = pack[n + i], q2 = pack[2 * n + i];
    const float m0 = pack[3 * n + i], m1 = pack[4 * n + i],
                m2 = pack[5 * n + i];
    const float rkf = pack[6 * n + i], rk8 = pack[7 * n + i];
    const float p2q = sq_norm3(q0, q1, q2);

    float kept[6] = {0.f}, all[6] = {0.f}, n_kept = 0.0f, n_all = 0.0f;
    float s6[6] = {0.f}, bnv[3] = {0.f}, sv[3] = {0.f}, deg = 0.0f;
    float q18[18] = {0.f};  // dead unless EDGE
    float fl_num = 0.0f, fl_den = 0.0f;
    float nw[12] = {0.f};  // dead unless NEW
    float maxd[3] = {-INFINITY, -INFINITY, -INFINITY};
    // A masked column adds m8f * dist2 = 0 to the reference's max.
    bool zero_seen = jmax < wt_c;

    for (int j = 0; j < jmax; ++j) {
      const float p0 = sm[W_PX * wt_c + j], p1 = sm[W_PY * wt_c + j],
                  p2 = sm[W_PZ * wt_c + j];
      const float d = sq_dist(q0, q1, q2, p2q, p0, p1, p2, sm[W_PP * wt_c + j]);
      const bool mk = d <= rkf && d < 1e30f;
      const bool m8 = d <= rk8 && d < 1e30f;
      if (!m8) zero_seen = true;
      if (!(mk || m8)) continue;
      const float n0 = sm[W_NX * wt_c + j], n1 = sm[W_NY * wt_c + j],
                  n2 = sm[W_NZ * wt_c + j];
      const float pn = sm[W_PN * wt_c + j];
      const float sym[6] = {__fmul_rn(n0, n0), __fmul_rn(n0, n1),
                            __fmul_rn(n0, n2), __fmul_rn(n1, n1),
                            __fmul_rn(n1, n2), __fmul_rn(n2, n2)};
      const float dotj = __fsub_rn(pn, dot3(q0, q1, q2, n0, n1, n2));
      if (mk) {
#pragma unroll
        for (int c = 0; c < 6; ++c) all[c] = __fadd_rn(all[c], sym[c]);
        n_all = __fadd_rn(n_all, 1.0f);
        if (keeps_angle(dotj, d, cos_rho)) {
#pragma unroll
          for (int c = 0; c < 6; ++c) kept[c] = __fadd_rn(kept[c], sym[c]);
          n_kept = __fadd_rn(n_kept, 1.0f);
        }
      }
      if (!m8) continue;
      const float nn[3] = {n0, n1, n2};
      const float pp[3] = {p0, p1, p2};
      const float nnv[3] = {__fmul_rn(n0, pn), __fmul_rn(n1, pn),
                            __fmul_rn(n2, pn)};
#pragma unroll
      for (int c = 0; c < 6; ++c) s6[c] = __fadd_rn(s6[c], sym[c]);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        bnv[c] = __fadd_rn(bnv[c], nnv[c]);
        sv[c] = __fadd_rn(sv[c], pp[c]);
      }
      deg = __fadd_rn(deg, 1.0f);
      if constexpr (EDGE) {
        // Pairs (c, a) with c <= a in the order 00 01 02 11 12 22.
        const int pc[6] = {0, 0, 0, 1, 1, 2}, pa[6] = {0, 1, 2, 1, 2, 2};
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float base = __fmul_rn(nn[pc[k]], nn[pa[k]]);
#pragma unroll
          for (int b = 0; b < 3; ++b)
            q18[k * 3 + b] = __fadd_rn(q18[k * 3 + b], __fmul_rn(base, pp[b]));
        }
      }
      if constexpr (FLAT) {
        const float ninj = dot3(m0, m1, m2, n0, n1, n2);
        const float sim = expf(__fdiv_rn(
            __fmul_rn(-16.0f, __fsub_rn(2.0f, __fmul_rn(2.0f, ninj))),
            d2_flat));
        const float close = expf(__fdiv_rn(__fmul_rn(-4.0f, d), d2_flat));
        const float wb = __fmul_rn(sim, close);
        fl_num = __fadd_rn(fl_num, __fmul_rn(wb, dotj));
        fl_den = __fadd_rn(fl_den, wb);
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
              __fsub_rn(sm[W_PP * wt_c + j],
                        __fmul_rn(2.0f, dot3(p0, p1, p2, cen[ci][0],
                                             cen[ci][1], cen[ci][2]))),
              csq[ci]);
          maxd[ci] = fmaxf(maxd[ci], dist2);
        }
      }
    }

    // Write the rows in _k2_layout order.
    int row = 0;
    const bool rescue = n_kept == 0.0f;
    const float wsum = fmaxf(rescue ? n_all : n_kept, 1.0f);
#pragma unroll
    for (int c = 0; c < 6; ++c)
      out[(row++) * n + i] = __fdiv_rn(rescue ? all[c] : kept[c], wsum);
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

template <bool FLAT, bool EDGE, bool NEW>
static void launch_k2(const float* pack, const int* starts, const float* scal,
                      float* out, int n, int nv, int tile, int wt_c,
                      float cos_rho, int nd, int total, cudaStream_t stream) {
  const size_t smem = sizeof(float) * W_ROWS * (size_t)wt_c;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(k2_kernel<FLAT, EDGE, NEW>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  const int threads = tile < 256 ? tile : 256;
  k2_kernel<FLAT, EDGE, NEW><<<n / tile, threads, smem, stream>>>(
      pack, starts, scal, out, n, nv, tile, wt_c, cos_rho, nd, total);
}

}  // namespace ngpd

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
  const int key = (use_flat ? 4 : 0) | (use_edge ? 2 : 0) | (use_new ? 1 : 0);
#define NGPD_K2_CASE(K, F, E, W)                                              \
  case K:                                                                     \
    launch_k2<F, E, W>(p, st, sc, o, n, nv, tile, wt_c, cos_rho, nd, total, \
                       cs);                                                   \
    break;
  switch (key) {
    NGPD_K2_CASE(0, false, false, false)
    NGPD_K2_CASE(1, false, false, true)
    NGPD_K2_CASE(2, false, true, false)
    NGPD_K2_CASE(3, false, true, true)
    NGPD_K2_CASE(4, true, false, false)
    NGPD_K2_CASE(5, true, false, true)
    NGPD_K2_CASE(6, true, true, false)
    NGPD_K2_CASE(7, true, true, true)
  }
#undef NGPD_K2_CASE
  return (int)cudaGetLastError();
}
