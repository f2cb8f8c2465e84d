// Exact brute-force kNN: for each query, the k nearest of the points
// [0, nv) by squared distance d = max((|q|^2 + |p|^2) - 2 (q.p), 0), the
// k smallest by (d, point index), ascending; slots that find no finite
// neighbour hold (+inf, 0). Optionally the point whose index is the
// query's own is left out (exclude_self; the mask goes by index).
//
// Replaces: ngpd_tpu/ops/knn.py, knn (l.112, over _knn_chunk l.64). That
// is a jitted XLA program, a lax.map over query chunks around a lax.scan
// over point tiles with a running lax.top_k, not a pallas_call. In the
// port it was a Python loop of ~65 eager launches a (query tile, point
// tile) step, which ops/knn.py keeps as the plain version.
//
// What bounds it on the H100: operations. Every (query, point) pair needs
// its distance: three products and two sums for q.p, the sum |q|^2 + |p|^2,
// the doubling, the difference and the clamp, and a comparison with the
// query's current k-th distance. The bytes are the two clouds and the
// (nq, k) outputs. The distances must rank exactly as the plain version's,
// so they run on the float32 pipes, each product and sum rounded on its
// own (-fmad=false and the __f*_rn intrinsics) in pairwise_sqdist's order:
// no mma, no wgmma, no TF32.
//
// Design (a first port, simple and right): one thread a query, 128 a
// block. The block stages the points through shared memory in tiles of
// KNN_TILE as (x, y, z, |p|^2), |p|^2 computed in the order above, so that
// staging it changes no bit; the rows past nv are never staged and a
// tile's tail holds (0, 0, 0, +inf), whose distance is +inf. Each thread
// keeps its k best as a list sorted by distance: for k <= 64 in registers
// (template K = 1, 8, 16, 32, 64, the list padded to K, k-th distance kept
// in a register), for larger k in its own output row in device memory
// (knn_row_kernel). The points are scanned in ascending index, so a
// candidate enters only when its distance is strictly below the k-th,
// after every equal distance already kept: the list is ordered by (d,
// index) without storing a key, which is the plain version's int64 key
// (distance bits above the position) and jax.lax.top_k's order. A thread
// tests KNN_BATCH (16) distances against its k-th at once, before their
// clamp and self mask, and clamps, masks and inserts in index order only
// where one passes: the hot loop is the eight float operations of a
// distance, one shared-memory load and the running minimum.
//
// Insertions cost K steps each, and a warp pays for every batch in which
// any lane inserts. Scanned in index order, a cloud stored row by row
// (a scan, a grid) brings each query's neighbours closer row after row,
// so most rows insert. So a block first scans one home tile, the KNN_TILE
// points around the index its queries map to (q * nv / nq), and keeps each
// query's k-th distance there as a cap; the list is then emptied and the
// full scan in index order takes only candidates at or below the cap. The
// cap is at least the true k-th distance, so no member of the result is
// lost, and the list still sees its candidates in index order. Left for
// later: a warp a query tile with a warp-wide merge, several queries a
// thread (a point's shared-memory load, one a pair now, feeds each), a
// (q - p)^2 prefilter, a split of the points across blocks where there are
// few queries (k 1 of 20,000 queries fills 157 blocks), and a list in
// shared memory for k > 64.
//
// Its times, and those of batches of 4 and 8, are in PERF.md.
#include <cuda_runtime.h>

namespace ngpd {

constexpr int KNN_THREADS = 128;
constexpr int KNN_TILE = 1024;  // points a shared-memory tile (16 KB)
constexpr int KNN_BATCH = 16;  // distances tested against the k-th at once
static_assert(KNN_TILE % KNN_BATCH == 0, "a tile holds whole batches");
constexpr int KNN_MAX_REGISTER_K = 64;
constexpr int KNN_HOME_MIN = 4 * KNN_TILE;  // fewer points: no home tile

__device__ __forceinline__ float knn_inf() { return __int_as_float(0x7f800000); }

// (x*x + y*y) + z*z, as pairwise_sqdist sums |a|^2.
__device__ __forceinline__ float knn_sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

// (|q|^2 + |p|^2) - 2 (q.p) with q.p = (q0 p0 + q1 p1) + q2 p2, before the
// clamp at 0 (knn_clamp).
__device__ __forceinline__ float knn_raw(float qx, float qy, float qz, float qq,
                                         const float4 p) {
  const float dot = __fadd_rn(__fadd_rn(__fmul_rn(qx, p.x), __fmul_rn(qy, p.y)),
                              __fmul_rn(qz, p.z));
  return __fsub_rn(__fadd_rn(qq, p.w), __fmul_rn(2.0f, dot));
}

// torch.clamp(min=0): a NaN stays NaN.
__device__ __forceinline__ float knn_clamp(float v) { return v < 0.0f ? 0.0f : v; }

// The k best of one query in registers, ascending, in the last k of K
// slots: the first K - k hold -inf, which no candidate passes, so the
// k-th is always d[K - 1]. Every index is a compile-time constant after
// unrolling, so the arrays stay in registers (a select of d[k - 1] by a
// runtime k became an indexed load and put the list in local memory).
template <int K>
struct RegisterList {
  float d[K];
  int i[K];
  float worst;  // min(d[K - 1], cap): a candidate must be strictly below it
  float cap;
  int k;

  __device__ __forceinline__ void init(int k_, bool active) {
    k = k_;
    restart(active ? knn_inf() : -knn_inf());  // an idle lane takes nothing
  }

  // Empty the list; from now on only candidates below cap are taken.
  __device__ __forceinline__ void restart(float cap_) {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      d[s] = s < K - k ? -knn_inf() : knn_inf();
      i[s] = 0;
    }
    cap = worst = cap_;
  }

  // Insert (dist, j) after every kept entry with a distance <= dist: j is
  // above every kept index, so this is the (d, index) order.
  __device__ __forceinline__ void insert(float dist, int j) {
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      const bool shift = d[s - 1] > dist;
      const bool here = d[s] > dist;
      d[s] = shift ? d[s - 1] : (here ? dist : d[s]);
      i[s] = shift ? i[s - 1] : (here ? j : i[s]);
    }
    if (d[0] > dist) {
      d[0] = dist;
      i[0] = j;
    }
    worst = fminf(d[K - 1], cap);
  }

  __device__ __forceinline__ void store(float* od, long long* oi) const {
#pragma unroll
    for (int s = 0; s < K; ++s) {
      if (s >= K - k) {
        od[s - (K - k)] = d[s];
        oi[s - (K - k)] = i[s];
      }
    }
  }
};

// The k best of one query in its own output row (any k), ascending.
struct RowList {
  float* d;
  long long* i;
  float worst;
  float cap;
  int k;
  bool active;

  __device__ __forceinline__ void init(float* od, long long* oi, int k_, bool active_) {
    d = od;
    i = oi;
    k = k_;
    active = active_;
    restart(active ? knn_inf() : -knn_inf());
  }

  __device__ __forceinline__ void restart(float cap_) {
    if (active) {
      for (int s = 0; s < k; ++s) {
        d[s] = knn_inf();
        i[s] = 0;
      }
    }
    cap = worst = cap_;
  }

  __device__ __forceinline__ void insert(float dist, int j) {
    int s = k - 1;
    while (s > 0 && d[s - 1] > dist) {
      d[s] = d[s - 1];
      i[s] = i[s - 1];
      --s;
    }
    d[s] = dist;
    i[s] = j;
    worst = fminf(d[k - 1], cap);
  }
};

// Stage the points [t0, t0 + cnt) as (x, y, z, |p|^2), the rest of the
// tile as (0, 0, 0, +inf).
__device__ __forceinline__ void stage_tile(const float* __restrict__ points, int t0, int cnt,
                                           float4* tile) {
  __syncthreads();  // the previous tile is consumed
  for (int j = threadIdx.x; j < KNN_TILE; j += blockDim.x) {
    float4 p = make_float4(0.0f, 0.0f, 0.0f, knn_inf());
    if (j < cnt) {
      const size_t g = 3 * (size_t)(t0 + j);
      p.x = points[g];
      p.y = points[g + 1];
      p.z = points[g + 2];
      p.w = knn_sq_norm(p.x, p.y, p.z);
    }
    tile[j] = p;
  }
  __syncthreads();
}

// One staged tile, KNN_BATCH distances at a time against the list's k-th.
// The batch is tested before its clamp and its self mask: a raw value is
// at most its distance, so every batch that holds a candidate enters, and
// there each candidate is clamped, masked and tested exactly.
template <class List>
__device__ __forceinline__ void scan_tile(const float4* tile, int t0, int cnt, float qx,
                                          float qy, float qz, float qq, int self,
                                          List& list) {
  // The tail past cnt holds +inf up to the next whole batch.
  const int end = (cnt + KNN_BATCH - 1) / KNN_BATCH * KNN_BATCH;
  for (int j = 0; j < end; j += KNN_BATCH) {
    float v[KNN_BATCH];
#pragma unroll
    for (int u = 0; u < KNN_BATCH; ++u) v[u] = knn_raw(qx, qy, qz, qq, tile[j + u]);
    float m = v[0];
#pragma unroll
    for (int u = 1; u < KNN_BATCH; ++u) m = fminf(m, v[u]);
    if (m < list.worst) {
      // In index order; the candidates rotate through v[0] so that the
      // insertion is inlined once.
#pragma unroll 1
      for (int u = 0; u < KNN_BATCH; ++u) {
        const float d = knn_clamp(v[0]);
        if (d < list.worst && t0 + j + u != self) list.insert(d, t0 + j + u);
#pragma unroll
        for (int w = 0; w + 1 < KNN_BATCH; ++w) v[w] = v[w + 1];
      }
    }
  }
}

// The scan every variant shares: the home tile's k-th distance as the cap,
// then every tile of points [0, nv) in index order.
template <class List>
__device__ __forceinline__ void knn_scan(const float* __restrict__ points, int nv, int nq,
                                         float qx, float qy, float qz, int self,
                                         List& list) {
  __shared__ float4 tile[KNN_TILE];
  const float qq = knn_sq_norm(qx, qy, qz);
  if (nv >= KNN_HOME_MIN) {
    const long long centre =
        ((long long)blockIdx.x * blockDim.x + blockDim.x / 2) * nv / nq;
    const long long h0 = min(max(centre - KNN_TILE / 2, 0LL), (long long)(nv - KNN_TILE));
    stage_tile(points, (int)h0, KNN_TILE, tile);
    scan_tile(tile, (int)h0, KNN_TILE, qx, qy, qz, qq, self, list);
    // d <= cap exactly where d < the next float above it.
    list.restart(nextafterf(list.worst, knn_inf()));
  }
  for (int t0 = 0; t0 < nv; t0 += KNN_TILE) {
    const int cnt = min(KNN_TILE, nv - t0);
    stage_tile(points, t0, cnt, tile);
    scan_tile(tile, t0, cnt, qx, qy, qz, qq, self, list);
  }
}

__device__ __forceinline__ void load_query(const float* __restrict__ queries, int q,
                                           bool active, float& qx, float& qy, float& qz) {
  qx = qy = qz = 0.0f;
  if (active) {
    qx = queries[3 * (size_t)q];
    qy = queries[3 * (size_t)q + 1];
    qz = queries[3 * (size_t)q + 2];
  }
}

template <int K>
__global__ void __launch_bounds__(KNN_THREADS)
knn_kernel(const float* __restrict__ points, const float* __restrict__ queries,
           float* __restrict__ out_d, long long* __restrict__ out_i, int nq, int nv, int k,
           int exclude_self) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = q < nq;
  float qx, qy, qz;
  load_query(queries, q, active, qx, qy, qz);
  RegisterList<K> list;
  list.init(k, active);
  knn_scan(points, nv, nq, qx, qy, qz, exclude_self && active ? q : -1, list);
  if (active) list.store(out_d + (size_t)q * k, out_i + (size_t)q * k);
}

__global__ void __launch_bounds__(KNN_THREADS)
knn_row_kernel(const float* __restrict__ points, const float* __restrict__ queries,
               float* __restrict__ out_d, long long* __restrict__ out_i, int nq, int nv,
               int k, int exclude_self) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = q < nq;
  float qx, qy, qz;
  load_query(queries, q, active, qx, qy, qz);
  RowList list;
  const size_t row = active ? (size_t)q * k : 0;
  list.init(out_d + row, out_i + row, k, active);
  knn_scan(points, nv, nq, qx, qy, qz, exclude_self && active ? q : -1, list);
}

// The list size a k runs with: the smallest register variant that holds
// it, or 0 for the row kernel (kernels/knn.py::variant).
inline int knn_variant(int k) {
  if (k == 1) return 1;
  for (int v = 8; v <= KNN_MAX_REGISTER_K; v *= 2)
    if (k <= v) return v;
  return 0;
}

}  // namespace ngpd

// points (n, 3) and queries (nq, 3) contiguous float32; out_d (nq, k)
// float32 and out_i (nq, k) int64, every slot written. Rows of points at
// or past nv are ignored; with exclude_self, query q skips point q.
extern "C" int ngpd_knn_launch(const void* points, const void* queries, void* out_d,
                               void* out_i, int n, int nq, int nv, int k,
                               int exclude_self, void* stream) {
  using namespace ngpd;
  if (n < 0 || nq <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  nv = nv < 0 ? 0 : (nv > n ? n : nv);
  const dim3 grid((nq + KNN_THREADS - 1) / KNN_THREADS);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(points);
  const float* qs = static_cast<const float*>(queries);
  float* od = static_cast<float*>(out_d);
  long long* oi = static_cast<long long*>(out_i);
  switch (knn_variant(k)) {
    case 1: knn_kernel<1><<<grid, KNN_THREADS, 0, s>>>(p, qs, od, oi, nq, nv, k, exclude_self); break;
    case 8: knn_kernel<8><<<grid, KNN_THREADS, 0, s>>>(p, qs, od, oi, nq, nv, k, exclude_self); break;
    case 16: knn_kernel<16><<<grid, KNN_THREADS, 0, s>>>(p, qs, od, oi, nq, nv, k, exclude_self); break;
    case 32: knn_kernel<32><<<grid, KNN_THREADS, 0, s>>>(p, qs, od, oi, nq, nv, k, exclude_self); break;
    case 64: knn_kernel<64><<<grid, KNN_THREADS, 0, s>>>(p, qs, od, oi, nq, nv, k, exclude_self); break;
    default: knn_row_kernel<<<grid, KNN_THREADS, 0, s>>>(p, qs, od, oi, nq, nv, k, exclude_self);
  }
  return (int)cudaGetLastError();
}

// Blocks of the variant that runs k that one SM holds, as the runtime
// counts them from its registers and shared memory.
extern "C" int ngpd_knn_blocks_per_sm(int k) {
  using namespace ngpd;
  int blocks = 0;
  switch (knn_variant(k)) {
    case 1: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_kernel<1>, KNN_THREADS, 0); break;
    case 8: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_kernel<8>, KNN_THREADS, 0); break;
    case 16: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_kernel<16>, KNN_THREADS, 0); break;
    case 32: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_kernel<32>, KNN_THREADS, 0); break;
    case 64: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_kernel<64>, KNN_THREADS, 0); break;
    default: cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, knn_row_kernel, KNN_THREADS, 0);
  }
  return blocks;
}
