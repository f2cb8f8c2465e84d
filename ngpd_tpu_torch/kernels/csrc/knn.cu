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
// no mma, no wgmma, no TF32. Unfused, each of those operations is one
// instruction, so the issue rate of the SM, not the float32 rate that
// counts an FMA as two, is the ceiling of the distance loop.
//
// Design. The selection runs on the plain version's own key, (distance
// bits << 32) + point index: keys are unique, so the k smallest keys are
// the same whatever order the candidates arrive in. That frees the scan
// from index order, lets the points be split across blocks and lets
// candidates be merged in bulk.
//
// The loop. A block stages the points through shared memory in tiles of
// KNN_TILE as (x, y, z, |p|^2), |p|^2 computed in the order above, so that
// staging it changes no bit; a tile's tail holds (0, 0, 0, +inf), whose
// distance is +inf. Each thread serves Q queries (4 at k 1), queries t,
// t + T, ... of the block, so one broadcast load of a staged point feeds Q
// distances. The hot loop is a shared-memory load a point, the eight float
// operations of each distance and a minimum over a batch of KNN_BATCH
// points (a tree, not a chain). A batch is tested once against each
// query's limit, the largest distance that can still enter its list,
// under a warp vote; only a batch that passes is computed again, point by
// point, with its clamp and self mask, and its candidates taken.
//
// The list. For k 1 the best key sits in a register; up to k 16 the k best
// sit in a sorted register list of 8 or 16 keys behind K - k pads of the
// least key, and a candidate below the k-th bubbles in (K compare-swaps,
// no register indexed at run time). Past 16 a list in registers costs the
// occupancy (64 keys took 168 registers), and inserting one candidate at
// a time walks the list once for each and serialises the warp on every
// lane's own candidates. So each query buffers its candidates, KNN_BUF
// keys in shared memory; when any lane of a warp may overflow, the warp
// flushes: each lane sorts its buffer in registers (a bitonic network) and
// merges it into its sorted list from the back, dropping the largest, in
// place, every lane the same number of branch-free steps. That list is a
// row in device memory (the output row, or the query's partial row of a
// split): rows in shared memory capped the SM at 8 warps for k 64 and ran
// slower than rows in device memory, which the L1 and L2 serve; no k has
// its own kernel and every k runs.
//
// The cap. Scanned in index order, a cloud stored row by row (a scan, a
// grid) brings each query's neighbours closer row after row, so most rows
// enter the list. So a block first scans one home tile, the KNN_TILE
// points around the index its queries map to (q * nv / nq), from its own
// queries outward, and keeps each query's k-th distance there as a cap;
// the list is then emptied, and the scan takes only candidates at or
// below the cap, starting at the tile that holds the home index. The cap
// is at least the true k-th distance, so no member of the result is lost.
//
// The split. Where the queries fill fewer than KNN_WAVES waves of the
// card's SMs (k 1 of 20,000 queries fills 79 blocks), ngpd_knn_slices
// splits the points into S slices, a grid of (query blocks, S); each
// block writes its slice's sorted keys to a partial row, and
// knn_merge_kernel merges the S rows of each query by key. The union of
// the slices' k best holds the global k best, and every slice is capped
// by the same home tile, so the merge is exact.
//
// Left for later: cp.async double buffering of the point tiles, a (q -
// p)^2 prefilter, and a cap from a spatial order (a Morton sort of the
// points with their indices carried) for clouds whose index order is not
// spatial.
#include <cuda_runtime.h>

namespace ngpd {

typedef unsigned long long Key;

constexpr int KNN_T1 = 64;  // threads a block at k 1
constexpr int KNN_TS = 128;  // ... at 2 <= k <= KNN_SMALL_K
constexpr int KNN_TL = 64;  // ... above
constexpr int KNN_TILE = 512;  // points a shared-memory tile (8 KB)
constexpr int KNN_BATCH = 8;  // points tested against each query's limit at once
constexpr int KNN_BUF = 32;  // candidate keys a query buffers
constexpr int KNN_Q1 = 4;  // queries a thread at k 1
constexpr int KNN_QS = 1;  // ... at 2 <= k <= KNN_SMALL_K
constexpr int KNN_QL = 1;  // ... above
constexpr int KNN_SMALL_K = 16;
constexpr int KNN_MAX_SLICES = 64;
constexpr int KNN_MIN_SLICE = 8 * KNN_TILE;  // points a slice at least
constexpr int KNN_WAVES = 2;  // waves of blocks the split aims at
constexpr int KNN_HOME_MIN = 4 * KNN_TILE;  // fewer points: no home tile
constexpr Key KNN_NONE = ~0ULL;  // an empty slot, above every key
static_assert(KNN_TILE % KNN_BATCH == 0, "a tile holds whole batches");
static_assert(KNN_BUF >= KNN_BATCH && (KNN_BUF & (KNN_BUF - 1)) == 0,
              "a buffer takes a whole batch and is a power of two");
constexpr unsigned KNN_WARP = 0xffffffffu;

__device__ __forceinline__ float knn_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float knn_max_finite() { return __int_as_float(0x7f7fffff); }

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

// The plain version's key of a clamped distance d (+0 or above) and index j.
__device__ __forceinline__ Key knn_key(float d, int j) {
  return ((Key)__float_as_uint(d) << 32) | (unsigned)j;
}

__device__ __forceinline__ float knn_key_dist(Key key) {
  return __uint_as_float((unsigned)(key >> 32));
}

// The largest distance that can still enter a list whose k-th key is kth
// under the cap: the k-th's distance (an equal distance may still enter
// with a lower index) or, while the list has an empty slot, the cap.
__device__ __forceinline__ float knn_limit(Key kth, float cap) {
  return kth == KNN_NONE ? cap : fminf(cap, knn_key_dist(kth));
}

// Where the launch puts things: the block's Q * T queries (QB),
// its slice of the points and its output.
struct KnnArgs {
  const float* points;
  const float* queries;
  float* out_d;      // (nq, k), or null when the launch writes partial lists
  long long* out_i;  // (nq, k)
  Key* part;         // (slices, nq, k) partial lists, or null
  int nq, nv, k, exclude_self, slices;
};

// One thread's queries. K > 0: each query's k best keys in K sorted
// registers, K - k pads of 0 in front (the least key; a real key 0 sorts
// after them), so that the k-th is always reg[K - 1] and no register is
// indexed at run time. K = 0: the k best in a sorted list in memory, fed
// through a buffer.
template <int Q, int K>
struct Queries {
  float x[Q], y[Q], z[Q], qq[Q];
  float lim[Q];  // a candidate enters only at or below it
  float cap[Q];
  int self[Q];   // the point index left out, or -1 (-2: an idle lane)
  int cnt[Q];    // buffered candidates
  Key reg[Q][K > 0 ? K : 1];
  Key* list[Q];  // K = 0: slot 0 of the sorted list
};

// Stage the points [t0, t0 + cnt) as (x, y, z, |p|^2), the rest of the
// tile as (0, 0, 0, +inf).
template <int T>
__device__ __forceinline__ void stage_tile(const float* __restrict__ points, int t0, int cnt,
                                           float4* tile) {
  __syncthreads();  // the previous tile is consumed
#pragma unroll 4
  for (int j = threadIdx.x; j < KNN_TILE; j += T) {
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

// Ascending bitonic sort of N keys in registers (all indices constant).
template <int N>
__device__ __forceinline__ void sort_keys(Key (&b)[N]) {
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int f = e ^ stride;
        if (f > e) {
          const bool up = (e & size) == 0;
          const Key lo = b[e] < b[f] ? b[e] : b[f];
          const Key hi = b[e] < b[f] ? b[f] : b[e];
          b[e] = up ? lo : hi;
          b[f] = up ? hi : lo;
        }
      }
    }
  }
}

// Merge the m sorted keys at buf[0], buf[bs], ... into the sorted list
// L[0 .. k) of k keys, keeping the k smallest, in place: first the
// m largest of the union are dropped from the back, then the rest is
// written from position k - 1 down; the list read index never passes the
// write index, and keys are unique. Both loops run the same number of
// steps on every lane (KNN_BUF, then k) with a finished lane's work
// masked off, and each step is branch-free. Each step reads the two heads
// afresh. The form that carries them in registers across steps (--j;
// bj = j >= 0 ? buf[j * bs] : 0) is miscompiled by ptxas of CUDA 12.9 at
// -O1 and above: its PTX loads buf[j * bs], its SASS one stride lower,
// buf[(j - 1) * bs] (below the buffer at j = 0), so wrong keys enter the
// list; ptxas -O0 builds it right. The card test
// test_card_knn_sweeps_every_k_of_the_row_lists fails that form at every
// k past 16.
__device__ __forceinline__ void merge_back(Key* L, int k, const Key* buf, int bs, int m) {
  int i = k - 1, j = m - 1;
#pragma unroll
  for (int d = 0; d < KNN_BUF; ++d) {
    const bool act = d < m;
    const Key bv = act && j >= 0 ? buf[(size_t)j * bs] : 0;
    const Key lv = act && i >= 0 ? L[i] : 0;
    const bool take_b = j >= 0 && (i < 0 || bv > lv);
    j -= act && take_b;
    i -= act && !take_b;
  }
  for (int w = k - 1; w >= 0; --w) {
    const bool act = j >= 0;
    const Key bv = act ? buf[(size_t)j * bs] : 0;
    const Key lv = act && i >= 0 ? L[i] : 0;
    const bool take_b = i < 0 || bv > lv;
    if (act) L[w] = take_b ? bv : lv;
    j -= act && take_b;
    i -= act && !take_b;
  }
}

template <int T, int Q, int K>
struct KnnBlock {
  int k;
  float4* tile;
  Key* buf;   // slot c of the block's query i at c * QB + i
  static constexpr int QB = Q * T;

  __device__ __forceinline__ Key kth(const Queries<Q, K>& st, int u) const {
    return K > 0 ? st.reg[u][K > 0 ? K - 1 : 0] : st.list[u][k - 1];
  }

  // All lanes of the warp together: each merges its buffers (K = 0).
  __device__ __forceinline__ void flush(Queries<Q, K>& st) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      if (st.cnt[u] == 0) continue;
      Key* b = buf + u * T + threadIdx.x;
      Key keys[KNN_BUF];
#pragma unroll
      for (int c = 0; c < KNN_BUF; ++c) keys[c] = c < st.cnt[u] ? b[c * QB] : KNN_NONE;
      sort_keys(keys);
#pragma unroll
      for (int c = 0; c < KNN_BUF; ++c) b[c * QB] = keys[c];
      merge_back(st.list[u], k, b, QB, st.cnt[u]);
      st.lim[u] = knn_limit(kth(st, u), st.cap[u]);
      st.cnt[u] = 0;
    }
  }

  // Empty every list; from now on only candidates at or below the cap
  // are taken.
  __device__ __forceinline__ void restart(Queries<Q, K>& st) {
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      st.lim[u] = st.self[u] == -2 ? -1.0f : st.cap[u];
      st.cnt[u] = 0;
#pragma unroll
      for (int s = 0; s < (K > 0 ? K : 1); ++s) st.reg[u][s] = s < K - k ? 0 : KNN_NONE;
      if (K == 0 && st.self[u] != -2)
        for (int s = 0; s < k; ++s) st.list[u][s] = KNN_NONE;
    }
  }

  // Insert a key below the k-th into a register list.
  __device__ __forceinline__ void insert(Queries<Q, K>& st, int u, Key key) {
    if (K == 0) return;
    constexpr int R = K > 0 ? K : 1;
    st.reg[u][R - 1] = key;
#pragma unroll
    for (int s = R - 1; s > 0; --s) {
      const Key a = st.reg[u][s - 1], b = st.reg[u][s];
      st.reg[u][s - 1] = b < a ? b : a;
      st.reg[u][s] = b < a ? a : b;
    }
    st.lim[u] = knn_limit(st.reg[u][R - 1], st.cap[u]);
  }

  // One staged tile of cnt points from index t0, KNN_BATCH at a time,
  // from the batch at `from` round to the tile's end and on from its start.
  __device__ __forceinline__ void scan(int t0, int cnt, Queries<Q, K>& st, int from = 0) {
    const int end = (cnt + KNN_BATCH - 1) / KNN_BATCH * KNN_BATCH;
    for (int jb = 0; jb < end; jb += KNN_BATCH) {
      const int j = jb + from < end ? jb + from : jb + from - end;
      float4 p[KNN_BATCH];
#pragma unroll
      for (int e = 0; e < KNN_BATCH; ++e) p[e] = tile[j + e];
      float m[Q];
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        float v[KNN_BATCH];
#pragma unroll
        for (int e = 0; e < KNN_BATCH; ++e) v[e] = knn_raw(st.x[u], st.y[u], st.z[u], st.qq[u], p[e]);
#pragma unroll
        for (int w = KNN_BATCH / 2; w > 0; w /= 2)
#pragma unroll
          for (int e = 0; e < w; ++e) v[e] = fminf(v[e], v[e + w]);
        m[u] = v[0];
      }
      bool hit = false;
#pragma unroll
      for (int u = 0; u < Q; ++u) hit |= m[u] <= st.lim[u];
      if (!__any_sync(KNN_WARP, hit)) continue;
      // The batch again, point by point, clamped and masked, for each query
      // whose minimum passed.
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        if (!(m[u] <= st.lim[u])) continue;
#pragma unroll 1
        for (int e = 0; e < KNN_BATCH; ++e) {
          const float d = knn_clamp(knn_raw(st.x[u], st.y[u], st.z[u], st.qq[u], tile[j + e]));
          const int g = t0 + j + e;
          const Key key = knn_key(d, g);
          const bool take = d <= st.lim[u] && g != st.self[u];
          if (K > 0) {
            if (take && key < kth(st, u)) insert(st, u, key);
          } else {
            if (take) buf[(st.cnt[u] * Q + u) * T + threadIdx.x] = key;
            st.cnt[u] += take;
          }
        }
      }
      if (K == 0) {
        bool full = false;
#pragma unroll
        for (int u = 0; u < Q; ++u) full |= st.cnt[u] > KNN_BUF - KNN_BATCH;
        if (__any_sync(KNN_WARP, full)) flush(st);
      }
    }
  }
};

// Grid (query blocks, slices): the k best of the block's queries among
// the points of its slice.
template <int T, int Q, int K>
__global__ void __launch_bounds__(T)
knn_kernel(const KnnArgs a) {
  // Each buffer is declared with the type it holds: the tile of staged
  // points static, the candidate keys (K = 0) in the dynamic part.
  __shared__ float4 tile[KNN_TILE];
  extern __shared__ Key knn_buf[];
  constexpr int QB = Q * T;
  const int q0 = blockIdx.x * QB;
  const int slice = blockIdx.y;
  KnnBlock<T, Q, K> blk{a.k, tile, knn_buf};

  Queries<Q, K> st;
#pragma unroll
  for (int u = 0; u < Q; ++u) {
    const int i = u * T + threadIdx.x;
    const int q = q0 + i;
    const bool active = q < a.nq;
    st.x[u] = st.y[u] = st.z[u] = 0.0f;
    if (active) {
      st.x[u] = a.queries[3 * (size_t)q];
      st.y[u] = a.queries[3 * (size_t)q + 1];
      st.z[u] = a.queries[3 * (size_t)q + 2];
    }
    st.qq[u] = knn_sq_norm(st.x[u], st.y[u], st.z[u]);
    st.self[u] = !active ? -2 : (a.exclude_self ? q : -1);
    st.cap[u] = knn_max_finite();  // no infinite or NaN distance enters
    st.list[u] = nullptr;
    if (K == 0 && active) {
      st.list[u] = a.part ? a.part + ((size_t)slice * a.nq + q) * a.k
                          : reinterpret_cast<Key*>(a.out_i) + (size_t)q * a.k;
    }
  }
  blk.restart(st);

  // The home tile, from the block's own queries outward so that the list
  // fills with near points first: its k-th distance caps every later
  // candidate.
  const long long centre = ((long long)q0 + QB / 2) * a.nv / a.nq;
  if (a.nv >= KNN_HOME_MIN) {
    const long long h0 =
        min(max(centre - KNN_TILE / 2, 0LL), (long long)(a.nv - KNN_TILE));
    stage_tile<T>(a.points, (int)h0, KNN_TILE, tile);
    blk.scan((int)h0, KNN_TILE, st, (int)(centre - h0) / KNN_BATCH * KNN_BATCH % KNN_TILE);
    if (K == 0) blk.flush(st);
#pragma unroll
    for (int u = 0; u < Q; ++u)
      if (st.self[u] != -2) st.cap[u] = knn_limit(blk.kth(st, u), knn_max_finite());
    blk.restart(st);
  }

  // The slice, tile by tile from the one that holds the home index.
  const int len = (a.nv + a.slices - 1) / a.slices;
  const int s0 = min(slice * len, a.nv), s1 = min(s0 + len, a.nv);
  const int tiles = (s1 - s0 + KNN_TILE - 1) / KNN_TILE;
  const int first = tiles ? (int)min(max((centre - s0) / KNN_TILE, 0LL),
                                     (long long)(tiles - 1)) : 0;
  for (int t = 0; t < tiles; ++t) {
    const int t0 = s0 + ((first + t) % tiles) * KNN_TILE;
    const int cnt = min(KNN_TILE, s1 - t0);
    stage_tile<T>(a.points, t0, cnt, tile);
    blk.scan(t0, cnt, st);
  }
  if (K == 0) blk.flush(st);

#pragma unroll
  for (int u = 0; u < Q; ++u) {
    if (st.self[u] == -2) continue;
    const int q = q0 + u * T + threadIdx.x;
    if (K > 0) {
      constexpr int R = K > 0 ? K : 1;
#pragma unroll
      for (int s = 0; s < R; ++s) {
        if (s < R - a.k) continue;
        const Key key = st.reg[u][s];
        const size_t o = (size_t)q * a.k + s - (R - a.k);
        if (a.part) {
          a.part[(size_t)slice * a.nq * a.k + o] = key;
        } else {
          a.out_d[o] = key == KNN_NONE ? knn_inf() : knn_key_dist(key);
          a.out_i[o] = key == KNN_NONE ? 0 : (long long)(key & 0xffffffffu);
        }
      }
    } else {
      if (a.part) continue;  // the list is the partial row
      for (int s = 0; s < a.k; ++s) {
        const Key key = st.list[u][s];
        const size_t o = (size_t)q * a.k + s;
        a.out_d[o] = key == KNN_NONE ? knn_inf() : knn_key_dist(key);
        a.out_i[o] = key == KNN_NONE ? 0 : (long long)(key & 0xffffffffu);
      }
    }
  }
}

// One thread a query: the k smallest keys of its S sorted partial lists.
__global__ void __launch_bounds__(128)
knn_merge_kernel(const Key* __restrict__ part, float* __restrict__ out_d,
                 long long* __restrict__ out_i, int nq, int k, int slices) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  int pos[KNN_MAX_SLICES];
  Key head[KNN_MAX_SLICES];
  for (int s = 0; s < slices; ++s) {
    pos[s] = 0;
    head[s] = part[((size_t)s * nq + q) * k];
  }
  for (int r = 0; r < k; ++r) {
    int w = 0;
    for (int s = 1; s < slices; ++s)
      if (head[s] < head[w]) w = s;
    const Key key = head[w];
    out_d[(size_t)q * k + r] = key == KNN_NONE ? knn_inf() : knn_key_dist(key);
    out_i[(size_t)q * k + r] = key == KNN_NONE ? 0 : (long long)(key & 0xffffffffu);
    head[w] = ++pos[w] < k ? part[((size_t)w * nq + q) * k + pos[w]] : KNN_NONE;
  }
}

// The register list's length at k (0: a list in memory), threads a block
// and queries a thread.
inline int knn_reg_k(int k) { return k == 1 ? 1 : k <= 8 ? 8 : k <= KNN_SMALL_K ? 16 : 0; }
inline int knn_threads(int k) { return k == 1 ? KNN_T1 : k <= KNN_SMALL_K ? KNN_TS : KNN_TL; }
inline int knn_queries(int k) { return k == 1 ? KNN_Q1 : k <= KNN_SMALL_K ? KNN_QS : KNN_QL; }

// Dynamic shared memory of the launch at k: for a list in memory, each
// query's buffer (the tile is static).
inline size_t knn_buf_bytes(int k) {
  const size_t qb = (size_t)knn_queries(k) * knn_threads(k);
  return knn_reg_k(k) ? 0 : qb * KNN_BUF * sizeof(Key);
}

// Launch kernel of the variant that runs k with `fn`, or count its blocks.
template <typename Fn>
static void knn_dispatch(int k, Fn fn) {
  switch (knn_reg_k(k)) {
    case 1: fn(knn_kernel<KNN_T1, KNN_Q1, 1>); break;
    case 8: fn(knn_kernel<KNN_TS, KNN_QS, 8>); break;
    case 16: fn(knn_kernel<KNN_TS, KNN_QS, 16>); break;
    default: fn(knn_kernel<KNN_TL, KNN_QL, 0>);
  }
}

static int knn_run(const KnnArgs& a, cudaStream_t s) {
  const size_t smem = knn_buf_bytes(a.k);  // 16 KB at most: no opt-in past 48 KB
  const int qb = knn_queries(a.k) * knn_threads(a.k);
  const dim3 grid((a.nq + qb - 1) / qb, a.slices);
  knn_dispatch(a.k, [&](auto kernel) { kernel<<<grid, knn_threads(a.k), smem, s>>>(a); });
  return (int)cudaGetLastError();
}

}  // namespace ngpd

// points (n, 3) and queries (nq, 3) contiguous float32; out_d (nq, k)
// float32 and out_i (nq, k) int64, every slot written. Rows of points at
// or past nv are ignored; with exclude_self, query q skips point q. One
// launch over all the points (no split).
extern "C" int ngpd_knn_launch(const void* points, const void* queries, void* out_d,
                               void* out_i, int n, int nq, int nv, int k,
                               int exclude_self, void* stream) {
  using namespace ngpd;
  if (n < 0 || nq <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  KnnArgs a{static_cast<const float*>(points), static_cast<const float*>(queries),
            static_cast<float*>(out_d), static_cast<long long*>(out_i), nullptr,
            nq, nv < 0 ? 0 : (nv > n ? n : nv), k, exclude_self, 1};
  return knn_run(a, static_cast<cudaStream_t>(stream));
}

// The same search split into `slices` slices of the points: part (slices,
// nq, k) int64 receives each slice's sorted keys (distance bits << 32) +
// index, empty slots ~0; ngpd_knn_merge_launch then merges them.
extern "C" int ngpd_knn_split_launch(const void* points, const void* queries, void* part,
                                     int n, int nq, int nv, int k, int exclude_self,
                                     int slices, void* stream) {
  using namespace ngpd;
  if (n < 0 || nq <= 0 || k <= 0 || slices < 1 || slices > KNN_MAX_SLICES)
    return (int)cudaErrorInvalidValue;
  KnnArgs a{static_cast<const float*>(points), static_cast<const float*>(queries),
            nullptr, nullptr, static_cast<Key*>(part),
            nq, nv < 0 ? 0 : (nv > n ? n : nv), k, exclude_self, slices};
  return knn_run(a, static_cast<cudaStream_t>(stream));
}

// part (slices, nq, k) sorted keys -> out_d (nq, k) float32 and out_i (nq,
// k) int64, the k smallest keys of each query ((+inf, 0) for empty slots).
extern "C" int ngpd_knn_merge_launch(const void* part, void* out_d, void* out_i, int nq,
                                     int k, int slices, void* stream) {
  using namespace ngpd;
  if (nq <= 0 || k <= 0 || slices < 1 || slices > KNN_MAX_SLICES)
    return (int)cudaErrorInvalidValue;
  knn_merge_kernel<<<(nq + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Key*>(part), static_cast<float*>(out_d),
      static_cast<long long*>(out_i), nq, k, slices);
  return (int)cudaGetLastError();
}

// Blocks of the variant that runs k that one SM holds, as the runtime
// counts them from its registers and shared memory.
extern "C" int ngpd_knn_blocks_per_sm(int k) {
  using namespace ngpd;
  int blocks = 0;
  knn_dispatch(k, [&](auto kernel) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, knn_threads(k),
                                                  knn_buf_bytes(k));
  });
  return blocks;
}

// The slices a search of nq queries among nv points at k runs with: 1,
// or as many as bring the grid to KNN_WAVES waves of the card's SMs, each
// slice KNN_MIN_SLICE points or more, at most KNN_MAX_SLICES.
extern "C" int ngpd_knn_slices(int nq, int nv, int k) {
  using namespace ngpd;
  int dev = 0, sms = 0;
  if (nq <= 0 || nv <= 0 || k <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  const long long per_sm = ngpd_knn_blocks_per_sm(k);
  const long long qb = knn_queries(k) * knn_threads(k);
  const long long blocks = (nq + qb - 1) / qb;
  const long long want = ((long long)sms * per_sm * KNN_WAVES + blocks - 1) / blocks;
  const long long most = nv / KNN_MIN_SLICE;
  const long long s = want < most ? want : most;
  return (int)(s < 1 ? 1 : s > KNN_MAX_SLICES ? KNN_MAX_SLICES : s);
}
