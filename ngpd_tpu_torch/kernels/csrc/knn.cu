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
// The loop. Each warp works on its own. It stages points through shared
// memory a chunk of KNN_CHUNK at a time as (x, y, z, |p|^2), |p|^2
// computed in the order above, so that staging it changes no bit; a
// chunk's tail holds (0, 0, 0, +inf), whose distance is +inf. Each thread
// serves Q queries (4 at k 1), queries t, t + T, ... of the block, so one
// broadcast load of a staged point feeds Q distances. The hot loop is a
// shared-memory load a point, the eight float operations of each distance
// and a minimum over a batch of KNN_BATCH points (a tree, not a chain). A
// batch is tested once against each query's limit, the largest distance
// that can still enter its list, under a warp vote; only a batch that
// passes is walked point by point, over the distances already computed,
// with its clamp and self mask, and its candidates taken.
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
// enter the list. So a warp first scans its home tile, the KNN_TILE points
// of the tile that holds the index its queries map to (q * nv / nq), from
// its own queries outward; the k-th distance there caps every later
// candidate. The cap is at least the true k-th distance, so no member of
// the result is lost.
//
// The skip. Most tiles hold no candidate at all: on the dense roof (181
// points a row, 512 a tile) a query's neighbours lie in a few rows, in 5-8
// of its 64 tiles. knn_kernel_boxes boxes each tile and each of its
// KNN_CHUNKS chunks (their points with a finite |p|^2, and the largest
// |p|^2); a point outside a box has an infinite or NaN distance and never
// enters a list, whose limit is knn_max_finite. A warp takes a tile only
// where one of its queries may take a point of the tile's box at its limit
// (knn_needs), and in it scans only the chunks where one may take a point
// of the chunk's box. Limits only fall, and a skipped chunk holds no point
// at or below the limit its queries held then, so the result is the full
// scan's bit for bit, whatever is skipped and in whatever order.
//
// Why knn_needs is exact. Let u = 2^-24, Q = |q|^2, P = |p|^2 and D = Q + P
// - 2 q.p the true squared distance. The kernel's |q|^2 and |p|^2 round
// three times each: within gamma_3 Q and gamma_3 P (gamma_n = n u / (1 - n
// u)); q.p within gamma_3 sum |q_i p_i| <= gamma_3 (Q + P) / 2, and the
// doubling is exact; the sum |q|^2 + |p|^2 adds u (1 + gamma_3) (Q + P);
// the difference, at most 2 (Q + P) (1 + 7 u) in size, adds u of that. So
// the computed distance lies within (9 u + O(u^2)) (Q + P) of D, and of
// the kernel's (Q + P) too, since the computed norms are within gamma_3 of
// the true ones: KNN_ULPS = 16 u takes the margin with room, KNN_TINY
// covers results below 2^-126, whose error is absolute. The squared gap
// between a query and a box is at most D for every point of the box; it
// rounds upward at most 5 times (the differences, squares and sums, each
// (1 + u)), which 0.99999 outweighs; and a rounded difference exceeds a
// float only where the exact one does. So a gap that still exceeds the
// limit after the margin is taken off leaves every computed distance of
// the box above the limit. Past 2^126 for |q|^2 + |p|^2 the terms may
// overflow (an infinite 2 q.p clamps to 0), so such a box is always
// needed. Far from the origin the margin outgrows the gaps and nothing is
// skipped; that is right: losing a neighbour there would not be.
//
// The rounds. The tiles are visited outward from the home tile, in
// KNN_ROUNDS rounds; an early round takes only the chunks within the
// limits times KNN_NARROW^(rounds left). A query whose home tile lies far
// from its neighbours (the roof's repeated rows, drawn at random and
// appended) would otherwise test the chunks between at its loose cap and
// scan them all; the narrow rounds let it find its neighbours first. A
// warp tests 32 tiles at once, a lane loading each box, so that the tests
// wait on one load, and marks the chunks it scanned in shared memory.
//
// The split. Where the queries fill less than a KNN_WAVE_SHARE-th of a
// wave of the card's SMs (k 1 of 20,000 queries fills 79 blocks),
// ngpd_knn_slices splits the points into S slices of whole tiles. One
// launch (KNN_CAPS) takes each query's cap from its home tile once and
// boxes the tiles in the blocks past the queries'; a grid of (query
// blocks, S) then scans the slices under those caps (KNN_SLICES), each
// block writing its slice's sorted keys to a partial row, and
// knn_merge_kernel merges the S rows of each query by key. The union of
// the slices' k best holds the global k best, and every slice is capped
// by the same k-th distance, so the merge is exact. The caps are paid
// once, not once a slice: a slice's blocks start from them and scan no
// home tile of their own. A search whose blocks fill half a wave keeps one
// slice: with the skip a block holds its SM briefly, and each slice adds a
// partial row to write and merge.
//
// The counters: each warp adds the tiles it took and those a full scan
// takes (its home tile and the slice's), and the chunks it scanned and
// those of the offered tiles, to counts (kernels/knn.py::scan_counts).
//
// Left for later: cp.async double buffering of the chunks, a (q - p)^2
// prefilter, and a spatial order (a Morton sort of the points with their
// indices carried) for clouds whose index order is not spatial, where the
// skip engages little (the dense roof with its rows shuffled scans every
// tile).
#include <cuda_runtime.h>

namespace ngpd {

typedef unsigned long long Key;

constexpr int KNN_T1 = 64;  // threads a block at k 1
constexpr int KNN_TS = 128;  // ... at 2 <= k <= KNN_SMALL_K
constexpr int KNN_TL = 64;  // ... above
constexpr int KNN_TILE = 512;  // points a tile, which a warp takes or skips whole
constexpr int KNN_BATCH = 8;  // points tested against each query's limit at once
constexpr int KNN_BUF = 32;  // candidate keys a query buffers
constexpr int KNN_Q1 = 4;  // queries a thread at k 1
constexpr int KNN_QS = 1;  // ... at 2 <= k <= KNN_SMALL_K
constexpr int KNN_QL = 1;  // ... above
constexpr int KNN_SMALL_K = 16;
constexpr int KNN_MAX_SLICES = 64;
constexpr int KNN_MIN_SLICE = 8 * KNN_TILE;  // points a slice at least
constexpr int KNN_WAVE_SHARE = 2;  // the split aims at 1 / KNN_WAVE_SHARE of a wave of blocks
constexpr int KNN_CHUNK = 64;  // points a chunk of a tile, boxed on its own
constexpr int KNN_CHUNKS = KNN_TILE / KNN_CHUNK;
constexpr int KNN_BOX_WARPS = 8;  // tiles a block of knn_kernel_boxes boxes, a warp each
constexpr int KNN_ROUNDS = 3;  // rounds over a slice's tiles
constexpr float KNN_NARROW = 1.0f / 16;  // each earlier round's factor on the limits
constexpr int KNN_MARKED = 1024;  // tiles of a slice the early rounds visit, in visit order
constexpr Key KNN_NONE = ~0ULL;  // an empty slot, above every key
static_assert(KNN_TILE % KNN_BATCH == 0, "a tile holds whole batches");
static_assert(KNN_CHUNK % KNN_BATCH == 0 && KNN_CHUNK * 32 == KNN_TILE * 4,
              "a chunk holds whole batches and is the points of 4 lanes of a box warp");
static_assert(KNN_BUF >= KNN_BATCH && (KNN_BUF & (KNN_BUF - 1)) == 0,
              "a buffer takes a whole batch and is a power of two");
constexpr unsigned KNN_WARP = 0xffffffffu;
// The skip's margin, a bound on |computed - true| of a distance where
// |q|^2 + |p|^2 is at most s: KNN_ULPS s + KNN_TINY.
constexpr float KNN_ULPS = 9.5367431640625e-07f;  // 16 * 2^-24
constexpr float KNN_TINY = 1e-36f;  // the absolute error of results below 2^-126

__device__ __forceinline__ float knn_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float knn_max_finite() { return __int_as_float(0x7f7fffff); }
__device__ __forceinline__ float knn_two_126() { return __int_as_float(0x7e800000); }

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
  float4* boxes;     // tile boxes (tiles, 2), then chunk boxes (tiles, KNN_CHUNKS, 2)
  float* caps;       // (nq,): each query's cap, written by KNN_CAPS, read by KNN_SLICES
  unsigned long long* counts;  // summed over warps: tiles taken, offered; chunks scanned, offered
  int nq, nv, k, exclude_self, slices, phase;
};

// What a launch of knn_kernel does: the whole search (one slice), each
// query's cap from its home tile alone (and, in blocks past the queries',
// the tiles' boxes), or the slices' partial lists under those caps.
enum KnnPhase { KNN_WHOLE = 0, KNN_CAPS = 1, KNN_SLICES = 2 };

// The boxes of tile t, the points [t KNN_TILE, (t + 1) KNN_TILE) below nv
// that have a finite staged |p|^2, and of each of its KNN_CHUNKS chunks of
// KNN_CHUNK points: boxes[2 t] = (lo x, lo y, lo z, largest |p|^2),
// boxes[2 t + 1] = (hi x, hi y, hi z, 0), chunk c's at 2 tiles + 2 (t
// KNN_CHUNKS + c); a box with no such point holds (+inf, +inf, +inf, -1),
// (-inf, -inf, -inf, 0). All lanes of a warp, each 16 consecutive points.
__device__ __forceinline__ void knn_box_tile(const float* __restrict__ points, int nv, int t,
                                             float4* __restrict__ boxes) {
  const int lane = threadIdx.x & 31;
  const int tiles = (nv + KNN_TILE - 1) / KNN_TILE;
  constexpr int L = KNN_TILE / 32;
  float lo[3] = {knn_inf(), knn_inf(), knn_inf()};
  float hi[3] = {-knn_inf(), -knn_inf(), -knn_inf()};
  float pm = -1.0f;
  const int j0 = t * KNN_TILE + lane * L, j1 = min(j0 + L, nv);
  for (int j = j0; j < j1; ++j) {
    const float p[3] = {points[3 * (size_t)j], points[3 * (size_t)j + 1],
                        points[3 * (size_t)j + 2]};
    const float pw = knn_sq_norm(p[0], p[1], p[2]);
    if (!(pw <= knn_max_finite())) continue;  // inf or NaN: never a candidate
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], p[c]);
      hi[c] = fmaxf(hi[c], p[c]);
    }
    pm = fmaxf(pm, pw);
  }
  // Lanes 4c .. 4c + 3 hold chunk c, all 32 the tile.
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      lo[c] = fminf(lo[c], __shfl_xor_sync(KNN_WARP, lo[c], o));
      hi[c] = fmaxf(hi[c], __shfl_xor_sync(KNN_WARP, hi[c], o));
    }
    pm = fmaxf(pm, __shfl_xor_sync(KNN_WARP, pm, o));
    if (o == 2 && (lane & 3) == 0) {
      float4* cb = boxes + 2 * tiles + 2 * (t * KNN_CHUNKS + (lane >> 2));
      cb[0] = make_float4(lo[0], lo[1], lo[2], pm);
      cb[1] = make_float4(hi[0], hi[1], hi[2], 0.0f);
    }
  }
  if (lane == 0) {
    boxes[2 * t] = make_float4(lo[0], lo[1], lo[2], pm);
    boxes[2 * t + 1] = make_float4(hi[0], hi[1], hi[2], 0.0f);
  }
}

// The boxes of every tile below nv, a warp a tile.
__global__ void __launch_bounds__(32 * KNN_BOX_WARPS)
knn_kernel_boxes(const float* __restrict__ points, int nv, float4* __restrict__ boxes) {
  const int t = blockIdx.x * KNN_BOX_WARPS + (threadIdx.x >> 5);
  if (t < (nv + KNN_TILE - 1) / KNN_TILE) knn_box_tile(points, nv, t, boxes);
}

// A float4 from lane src of the warp.
__device__ __forceinline__ float4 knn_shfl(const float4 v, int src) {
  return make_float4(__shfl_sync(KNN_WARP, v.x, src), __shfl_sync(KNN_WARP, v.y, src),
                     __shfl_sync(KNN_WARP, v.z, src), __shfl_sync(KNN_WARP, v.w, src));
}

// Whether the query (x, y, z) with computed |q|^2 qq (finite) may take a
// point of the box lo, hi (lo.w the largest |p|^2 in it, -1 for none) at
// its limit lim. False only where the squared gap from the query to the
// box, rounded at most 5 times upward and lowered by 0.99999, still
// exceeds lim after the margin KNN_ULPS (qq + pp) + KNN_TINY is taken off:
// the gap is at most the true squared distance of every point of the box,
// and the computed distance lies within the margin of the true one (the
// header gives the proof), so every computed distance is then above lim.
// Past 2^126 for qq + pp the distance's terms may overflow: needed.
__device__ __forceinline__ bool knn_needs(float x, float y, float z, float qq, float lim,
                                          const float4 lo, const float4 hi) {
  if (!(lo.w >= 0.0f)) return false;
  const float s = __fadd_rn(qq, lo.w);
  if (!(s <= knn_two_126())) return true;
  const float gx = fmaxf(fmaxf(__fsub_rn(lo.x, x), __fsub_rn(x, hi.x)), 0.0f);
  const float gy = fmaxf(fmaxf(__fsub_rn(lo.y, y), __fsub_rn(y, hi.y)), 0.0f);
  const float gz = fmaxf(fmaxf(__fsub_rn(lo.z, z), __fsub_rn(z, hi.z)), 0.0f);
  const float margin = __fadd_rn(__fmul_rn(KNN_ULPS, s), KNN_TINY);
  return !(__fsub_rn(__fmul_rn(knn_sq_norm(gx, gy, gz), 0.99999f), margin) > lim);
}

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

// This warp's chunk: the points [c0, c0 + cnt), cnt <= KNN_CHUNK, staged
// into pts as (x, y, z, |p|^2), the rest as (0, 0, 0, +inf).
__device__ __forceinline__ void stage_chunk(const float* __restrict__ points, int c0, int cnt,
                                            float4* pts) {
  __syncwarp();  // the previous chunk is consumed
#pragma unroll
  for (int j = threadIdx.x & 31; j < KNN_CHUNK; j += 32) {
    float4 p = make_float4(0.0f, 0.0f, 0.0f, knn_inf());
    if (j < cnt) {
      const size_t g = 3 * (size_t)(c0 + j);
      p.x = points[g];
      p.y = points[g + 1];
      p.z = points[g + 2];
      p.w = knn_sq_norm(p.x, p.y, p.z);
    }
    pts[j] = p;
  }
  __syncwarp();
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
  float4* pts;  // this warp's staged chunk
  Key* buf;   // slot c of the block's query i at c * QB + i
  static constexpr int QB = Q * T;

  __device__ __forceinline__ Key kth(const Queries<Q, K>& st, int u) const {
    return K > 0 ? st.reg[u][K > 0 ? K - 1 : 0] : st.list[u][k - 1];
  }

  // Whether query u can take a candidate at all: active, with a finite
  // |q|^2 (else every distance is infinite or NaN).
  __device__ __forceinline__ bool finite(const Queries<Q, K>& st, int u) const {
    return st.self[u] != -2 && st.qq[u] <= knn_max_finite();
  }

  // Whether any of this thread's queries may take a point of the box lo,
  // hi at its limit times f (a power of two, at most 1).
  __device__ __forceinline__ bool needs(const Queries<Q, K>& st, const float4 lo,
                                        const float4 hi, float f = 1.0f) const {
    bool need = false;
#pragma unroll
    for (int u = 0; u < Q; ++u)
      need |= finite(st, u) && knn_needs(st.x[u], st.y[u], st.z[u], st.qq[u],
                                         __fmul_rn(st.lim[u], f), lo, hi);
    return need;
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

  // The staged chunk of cnt points from index c0, KNN_BATCH at a time,
  // from the batch at `from` round to the chunk's end and on from its
  // start. All lanes of the warp together.
  __device__ __forceinline__ void scan(int c0, int cnt, Queries<Q, K>& st, int from = 0) {
    const int end = (cnt + KNN_BATCH - 1) / KNN_BATCH * KNN_BATCH;
    for (int jb = 0; jb < end; jb += KNN_BATCH) {
      const int j = jb + from < end ? jb + from : jb + from - end;
      float4 p[KNN_BATCH];
#pragma unroll
      for (int e = 0; e < KNN_BATCH; ++e) p[e] = pts[j + e];
      // Each query's distances to the batch, kept for its candidates, and
      // their minimum (a tree).
      float v[Q][KNN_BATCH], m[Q];
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        float w[KNN_BATCH];
#pragma unroll
        for (int e = 0; e < KNN_BATCH; ++e)
          w[e] = v[u][e] = knn_raw(st.x[u], st.y[u], st.z[u], st.qq[u], p[e]);
#pragma unroll
        for (int h = KNN_BATCH / 2; h > 0; h /= 2)
#pragma unroll
          for (int e = 0; e < h; ++e) w[e] = fminf(w[e], w[e + h]);
        m[u] = w[0];
      }
      bool hit = false;
#pragma unroll
      for (int u = 0; u < Q; ++u) hit |= m[u] <= st.lim[u];
      if (!__any_sync(KNN_WARP, hit)) continue;
      // The batch point by point, clamped and masked, for each query whose
      // minimum passed.
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        if (!(m[u] <= st.lim[u])) continue;
#pragma unroll
        for (int e = 0; e < KNN_BATCH; ++e) {
          const float d = knn_clamp(v[u][e]);
          const int g = c0 + j + e;
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
  // Each buffer is declared with the type it holds: each warp's staged
  // chunk of points static, the candidate keys (K = 0) in the dynamic part.
  __shared__ float4 chunk[T / 32][KNN_CHUNK];
  extern __shared__ Key knn_buf[];
  constexpr int QB = Q * T;
  const int q0 = blockIdx.x * QB;
  const int slice = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (a.nv + KNN_TILE - 1) / KNN_TILE;
  if (a.phase == KNN_CAPS && q0 >= a.nq) {  // the blocks past the queries box the tiles
    const int t = (blockIdx.x - (a.nq + QB - 1) / QB) * (T / 32) + warp;
    if (t < tiles) knn_box_tile(a.points, a.nv, t, a.boxes);
    return;
  }
  KnnBlock<T, Q, K> blk{a.k, chunk[warp], knn_buf};

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

  // Every warp works on its own from here. The grid's tiles over [0, nv);
  // the slice is whole tiles [b0, b1).
  const int per = (tiles + a.slices - 1) / a.slices;
  const int b0 = min(slice * per, tiles), b1 = min(b0 + per, tiles);
  // This warp's tiles taken and offered (the home tile and every tile of
  // the slice), and its chunks scanned and those of the offered tiles.
  unsigned taken = 0, offered = 0, chunks = 0, chunks_offered = 0;
  // The home tile: the tile that holds the index the warp's queries map to.
  const long long centre = ((long long)q0 + 32 * warp + 16) * a.nv / a.nq;
  const int home = (int)min(centre / KNN_TILE, (long long)max(tiles - 1, 0));
  if (a.phase == KNN_SLICES) {
    // Every slice under the caps of the home tile, its list empty.
#pragma unroll
    for (int u = 0; u < Q; ++u)
      if (st.self[u] != -2) st.cap[u] = a.caps[q0 + u * T + threadIdx.x];
    blk.restart(st);
  } else if (tiles) {
    // The home tile whole, from the warp's own queries outward so that the
    // list fills with near points first. The whole search keeps its list;
    // the caps pass keeps its k-th distance as the cap of every slice.
    const int h0 = home * KNN_TILE, hn = min(KNN_TILE, a.nv - h0);
    const int hc = (hn + KNN_CHUNK - 1) / KNN_CHUNK;
    const int at = (int)min(centre - h0, (long long)hn - 1);
    for (int i = 0; i < hc; ++i) {
      const int c0 = h0 + (at / KNN_CHUNK + i) % hc * KNN_CHUNK;
      const int cn = min(KNN_CHUNK, h0 + hn - c0);
      stage_chunk(a.points, c0, cn, blk.pts);
      blk.scan(c0, cn, st, i ? 0 : (at % KNN_CHUNK) / KNN_BATCH * KNN_BATCH);
    }
    if (K == 0) blk.flush(st);
    taken = offered = 1;
    chunks = chunks_offered = hc;
    if (a.phase == KNN_CAPS) {
#pragma unroll
      for (int u = 0; u < Q; ++u)
        if (st.self[u] != -2)
          a.caps[q0 + u * T + threadIdx.x] = knn_limit(blk.kth(st, u), knn_max_finite());
    }
  }

  // The slice's other tiles, outward from the home tile (or from the
  // slice's tile nearest to it): place i of the visit holds tile first +
  // (i + 1) / 2 for odd i, first - i / 2 for even i. In KNN_ROUNDS rounds
  // over the places, a warp takes a tile where one of its queries may take
  // a point of the tile's box, and in it scans each chunk left where one
  // may take a point of the chunk's box: in the last round at the
  // queries' limits, in an earlier round at their limits times
  // KNN_NARROW^(rounds left). So a query whose home tile lies far from its
  // neighbours (a cloud whose index order strays) finds them before the
  // chunks between are tested at its loose limit. The warp tests 32 places
  // at once, a lane loading each place's box, and a taken tile's chunk
  // boxes likewise. Which chunks of the first KNN_MARKED places are done:
  // bit c of the warp's byte i; later places wait for the last round.
  if (a.phase != KNN_CAPS && b0 < b1) {
    __shared__ unsigned char done_of[T / 32][KNN_MARKED];
    unsigned char* done = done_of[warp];
    for (int i = lane; i < KNN_MARKED; i += 32) done[i] = 0;
    __syncwarp();
    const float4* chunk_boxes = a.boxes + 2 * tiles;
    const int first = min(max(home, b0), b1 - 1);
    const int places = 2 * max(first - b0, b1 - 1 - first) + 1;
    auto tile_at = [&](int i) { return i & 1 ? first + (i + 1) / 2 : first - i / 2; };
    float f = 1.0f;
    for (int r = 1; r < KNN_ROUNDS; ++r) f *= KNN_NARROW;
    for (int r = 0; r < KNN_ROUNDS; ++r, f *= 1.0f / KNN_NARROW) {
      const bool last = r == KNN_ROUNDS - 1;
      for (int g = 0; g < (last ? places : min(places, KNN_MARKED)); g += 32) {
        // This lane's place: its tile, its chunks left, its box.
        const int i = g + lane, t = tile_at(i);
        const bool valid = i < places && t >= b0 && t < b1 && (i || a.phase != KNN_WHOLE);
        const int nc = valid ? (min(KNN_TILE, a.nv - t * KNN_TILE) + KNN_CHUNK - 1) / KNN_CHUNK
                             : 0;
        const unsigned was = valid && i < KNN_MARKED ? done[i] : 0u;
        const unsigned left = valid && (last || i < KNN_MARKED) ? ((1u << nc) - 1) & ~was : 0u;
        if (last) {
          offered += __popc(__ballot_sync(KNN_WARP, valid));
          chunks_offered += __reduce_add_sync(KNN_WARP, (unsigned)nc);
        }
        float4 lo = make_float4(0.0f, 0.0f, 0.0f, -1.0f), hi = lo;
        if (left) {
          lo = a.boxes[2 * t];
          hi = a.boxes[2 * t + 1];
        }
        unsigned want = 0u;  // the places whose tile a query of the warp may need
        for (unsigned open = __ballot_sync(KNN_WARP, left != 0u); open; open &= open - 1) {
          const int j = __ffs(open) - 1;
          if (__any_sync(KNN_WARP, blk.needs(st, knn_shfl(lo, j), knn_shfl(hi, j), f)))
            want |= 1u << j;
        }
        for (; want; want &= want - 1) {
          const int j = __ffs(want) - 1, ij = g + j, tj = tile_at(ij);
          const int t0 = tj * KNN_TILE, cnt = min(KNN_TILE, a.nv - t0);
          const unsigned before = __shfl_sync(KNN_WARP, was, j);
          unsigned rest = __shfl_sync(KNN_WARP, left, j), now = before;
          const float4 cb = lane < 2 * KNN_CHUNKS
                                ? chunk_boxes[2 * KNN_CHUNKS * tj + lane] : make_float4(0, 0, 0, 0);
          for (; rest; rest &= rest - 1) {
            const int c = __ffs(rest) - 1;
            if (!__any_sync(KNN_WARP, blk.needs(st, knn_shfl(cb, 2 * c), knn_shfl(cb, 2 * c + 1),
                                                f)))
              continue;
            const int c0 = t0 + c * KNN_CHUNK, cn = min(KNN_CHUNK, t0 + cnt - c0);
            stage_chunk(a.points, c0, cn, blk.pts);
            blk.scan(c0, cn, st);
            now |= 1u << c;
            ++chunks;
          }
          taken += before == 0u && now != 0u;  // a tile counts once, at its first chunk
          if (ij < KNN_MARKED && lane == 0) done[ij] = (unsigned char)now;
        }
        __syncwarp();
      }
    }
  }
  if (lane == 0) {
    atomicAdd(a.counts, (unsigned long long)taken);
    atomicAdd(a.counts + 1, (unsigned long long)offered);
    atomicAdd(a.counts + 2, (unsigned long long)chunks);
    atomicAdd(a.counts + 3, (unsigned long long)chunks_offered);
  }
  if (a.phase == KNN_CAPS) return;
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
  const int qb = knn_queries(a.k) * knn_threads(a.k), warps = knn_threads(a.k) / 32;
  const int tiles = (a.nv + KNN_TILE - 1) / KNN_TILE;
  const dim3 grid((a.nq + qb - 1) / qb + (a.phase == KNN_CAPS ? (tiles + warps - 1) / warps : 0),
                  a.slices);
  knn_dispatch(a.k, [&](auto kernel) { kernel<<<grid, knn_threads(a.k), smem, s>>>(a); });
  return (int)cudaGetLastError();
}

}  // namespace ngpd

// The boxes of the tiles of points (n, 3) contiguous float32 below nv and
// of their chunks into boxes ((1 + KNN_CHUNKS) ceil(nv / KNN_TILE), 2)
// float4, for the searches that follow.
extern "C" int ngpd_knn_boxes_launch(const void* points, void* boxes, int nv, void* stream) {
  using namespace ngpd;
  if (nv <= 0) return (int)cudaErrorInvalidValue;
  const int tiles = (nv + KNN_TILE - 1) / KNN_TILE;
  knn_kernel_boxes<<<(tiles + KNN_BOX_WARPS - 1) / KNN_BOX_WARPS, 32 * KNN_BOX_WARPS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), nv, static_cast<float4*>(boxes));
  return (int)cudaGetLastError();
}

// points (n, 3) and queries (nq, 3) contiguous float32; out_d (nq, k)
// float32 and out_i (nq, k) int64, every slot written. Rows of points at
// or past nv are ignored; with exclude_self, query q skips point q. boxes
// as ngpd_knn_boxes_launch wrote them for these points and nv; counts (4)
// uint64 receives, summed over warps, the tiles the search took and those
// a full scan takes, and the chunks it scanned and those a full scan
// scans. One launch over all the points (no split).
extern "C" int ngpd_knn_launch(const void* points, const void* queries, void* out_d,
                               void* out_i, void* boxes, void* counts, int n, int nq, int nv,
                               int k, int exclude_self, void* stream) {
  using namespace ngpd;
  if (n < 0 || nq <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  KnnArgs a{static_cast<const float*>(points), static_cast<const float*>(queries),
            static_cast<float*>(out_d), static_cast<long long*>(out_i), nullptr,
            static_cast<float4*>(boxes), nullptr, static_cast<unsigned long long*>(counts),
            nq, nv < 0 ? 0 : (nv > n ? n : nv), k, exclude_self, 1, KNN_WHOLE};
  return knn_run(a, static_cast<cudaStream_t>(stream));
}

// The split search's first launch: each query's cap, the k-th distance
// among its home tile, into caps (nq) float32 (the largest finite float
// where the tile holds fewer than k candidates), and the boxes as
// ngpd_knn_boxes_launch writes them; part (slices, nq, k) int64 as
// ngpd_knn_split_launch takes it, its first slice's rows used as the
// lists past k 16. Arguments otherwise as ngpd_knn_launch's.
extern "C" int ngpd_knn_caps_launch(const void* points, const void* queries, void* part,
                                    void* boxes, void* caps, void* counts, int n, int nq,
                                    int nv, int k, int exclude_self, void* stream) {
  using namespace ngpd;
  if (n < 0 || nq <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  KnnArgs a{static_cast<const float*>(points), static_cast<const float*>(queries),
            nullptr, nullptr, static_cast<Key*>(part), static_cast<float4*>(boxes),
            static_cast<float*>(caps), static_cast<unsigned long long*>(counts),
            nq, nv < 0 ? 0 : (nv > n ? n : nv), k, exclude_self, 1, KNN_CAPS};
  return knn_run(a, static_cast<cudaStream_t>(stream));
}

// The same search split into `slices` slices of whole tiles, each under
// the caps and boxes of ngpd_knn_caps_launch: part (slices, nq, k) int64
// receives each slice's sorted keys (distance bits << 32) + index, empty
// slots ~0; ngpd_knn_merge_launch then merges them.
extern "C" int ngpd_knn_split_launch(const void* points, const void* queries, void* part,
                                     void* boxes, void* caps, void* counts, int n, int nq,
                                     int nv, int k, int exclude_self, int slices,
                                     void* stream) {
  using namespace ngpd;
  if (n < 0 || nq <= 0 || k <= 0 || slices < 1 || slices > KNN_MAX_SLICES)
    return (int)cudaErrorInvalidValue;
  KnnArgs a{static_cast<const float*>(points), static_cast<const float*>(queries),
            nullptr, nullptr, static_cast<Key*>(part), static_cast<float4*>(boxes),
            static_cast<float*>(caps), static_cast<unsigned long long*>(counts),
            nq, nv < 0 ? 0 : (nv > n ? n : nv), k, exclude_self, slices, KNN_SLICES};
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
// or as many as bring the grid to a KNN_WAVE_SHARE-th of a wave of the
// card's SMs, each slice KNN_MIN_SLICE points or more, at most
// KNN_MAX_SLICES. A block whose warps skip most tiles holds its SM
// briefly, so a search whose blocks fill a fraction of a wave keeps its
// lists whole; a few blocks of scattered queries split.
extern "C" int ngpd_knn_slices(int nq, int nv, int k) {
  using namespace ngpd;
  int dev = 0, sms = 0;
  if (nq <= 0 || nv <= 0 || k <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  const long long per_sm = ngpd_knn_blocks_per_sm(k);
  const long long qb = knn_queries(k) * knn_threads(k);
  const long long blocks = (nq + qb - 1) / qb;
  const long long wave = (long long)sms * per_sm;
  const long long want = (wave + KNN_WAVE_SHARE * blocks - 1) / (KNN_WAVE_SHARE * blocks);
  const long long most = nv / KNN_MIN_SLICE;
  const long long s = want < most ? want : most;
  return (int)(s < 1 ? 1 : s > KNN_MAX_SLICES ? KNN_MAX_SLICES : s);
}
