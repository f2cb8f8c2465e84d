// ngpd_native — the port's host-side native runtime (ngpd_tpu_torch).
//
// A copy of ngpd_tpu/native/ngpd_native.cpp with the same C ABI (obj_load,
// obj_nv/nn/nf, obj_has_fn, obj_v/vn/fv/fn, obj_free, grid_knn) and the
// same parsing and search, so both packages read the same mesh from a file
// and find the same neighbours. It is host code: a fast OBJ parser (the
// Python parser is the bottleneck on files of millions of lines) and an
// exact grid-hash kNN, which chip_smoke.py uses as the exact oracle for the
// port's device kNN (ops/knn.py).
//
// Four behaviours of the reference are kept on purpose, each marked below
// with "Reference behaviour": whitespace handling that differs from the
// Python parser, unresolved negative indices, the 64-corner polygon cap
// and grid_knn's tie order.
//
// Exposed with a plain C ABI for ctypes; built with g++ at first use
// (ngpd_tpu_torch/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------
// OBJ parsing
// ---------------------------------------------------------------------

struct ObjData {
  float* v;        // (nv, 3)
  float* vn;       // (nn, 3)
  int32_t* fv;     // (nf, 3) 0-based, fan-triangulated
  int32_t* fn;     // (nf, 3) 0-based or all -1 when absent
  int64_t nv, nn, nf;
  int has_fn;
};

static const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
  return p;
}

static const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') p++;
  return p < end ? p + 1 : end;
}

ObjData* obj_load(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (fread(buf.data(), 1, size, f) != (size_t)size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  buf[size] = '\n';
  const char* p = buf.data();
  const char* end = buf.data() + size;

  std::vector<float> v, vn;
  std::vector<int32_t> fv, fn;
  bool any_fn = false;

  while (p < end) {
    // Reference behaviour (ngpd_tpu/native/ngpd_native.cpp:67-77): leading
    // blanks are skipped and a tab may follow the tag, so "  v 1 0 0" and
    // "v\t0 0 0" are vertices here, while the Python path (io/obj.py, as the
    // reference's obj.py:88-92) tests line.startswith("v ") and drops them.
    p = skip_ws(p, end);
    if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      char* q = const_cast<char*>(p + 1);
      for (int i = 0; i < 3; i++) v.push_back(strtof(q, &q));
    } else if (p + 2 < end && p[0] == 'v' && p[1] == 'n' &&
               (p[2] == ' ' || p[2] == '\t')) {
      char* q = const_cast<char*>(p + 2);
      for (int i = 0; i < 3; i++) vn.push_back(strtof(q, &q));
    } else if (p + 1 < end && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      // Parse a polygon of v[/vt][/vn] tokens; fan-triangulate.
      // Reference behaviour (ngpd_tpu/native/ngpd_native.cpp:78-79): at most
      // 64 corners of a polygon are kept; the rest of the line is ignored.
      int vi[64], ni[64], cnt = 0;
      const char* q = p + 1;
      while (q < end && *q != '\n' && cnt < 64) {
        q = skip_ws(q, end);
        if (q >= end || *q == '\n' || *q == '#') break;
        char* r = const_cast<char*>(q);
        long a = strtol(r, &r, 10);
        long c = 0;
        if (*r == '/') {
          r++;
          if (*r != '/') strtol(r, &r, 10);  // vt, ignored
          if (*r == '/') {
            r++;
            c = strtol(r, &r, 10);
          }
        }
        // Reference behaviour (ngpd_tpu/native/ngpd_native.cpp:93): a negative
        // (relative) index is not resolved, "f -3 -2 -1" gives -4 -3 -2, as
        // the Python path does (the reference's obj.py:61 says "clip 0";
        // nothing clips).
        vi[cnt] = (int)a - 1;
        ni[cnt] = (int)c - 1;
        if (c != 0) any_fn = true;
        cnt++;
        q = r;
      }
      for (int t = 1; t + 1 < cnt; t++) {
        fv.push_back(vi[0]); fv.push_back(vi[t]); fv.push_back(vi[t + 1]);
        fn.push_back(ni[0]); fn.push_back(ni[t]); fn.push_back(ni[t + 1]);
      }
    }
    p = next_line(p, end);
  }

  ObjData* out = new ObjData();
  out->nv = (int64_t)v.size() / 3;
  out->nn = (int64_t)vn.size() / 3;
  out->nf = (int64_t)fv.size() / 3;
  out->has_fn = any_fn ? 1 : 0;
  out->v = (float*)malloc(v.size() * sizeof(float));
  memcpy(out->v, v.data(), v.size() * sizeof(float));
  out->vn = (float*)malloc(vn.size() * sizeof(float));
  memcpy(out->vn, vn.data(), vn.size() * sizeof(float));
  out->fv = (int32_t*)malloc(fv.size() * sizeof(int32_t));
  memcpy(out->fv, fv.data(), fv.size() * sizeof(int32_t));
  out->fn = (int32_t*)malloc(fn.size() * sizeof(int32_t));
  memcpy(out->fn, fn.data(), fn.size() * sizeof(int32_t));
  return out;
}

int64_t obj_nv(ObjData* o) { return o->nv; }
int64_t obj_nn(ObjData* o) { return o->nn; }
int64_t obj_nf(ObjData* o) { return o->nf; }
int obj_has_fn(ObjData* o) { return o->has_fn; }
float* obj_v(ObjData* o) { return o->v; }
float* obj_vn(ObjData* o) { return o->vn; }
int32_t* obj_fv(ObjData* o) { return o->fv; }
int32_t* obj_fn(ObjData* o) { return o->fn; }

void obj_free(ObjData* o) {
  if (!o) return;
  free(o->v); free(o->vn); free(o->fv); free(o->fn);
  delete o;
}

// ---------------------------------------------------------------------
// Exact grid-hash kNN (the FLANN/scipy-KDTree replacement on host)
// ---------------------------------------------------------------------

// For each query, search expanding shells of grid cells until the k-th
// best distance is guaranteed covered. Exact for any inputs.
int grid_knn(const float* pts, int64_t n, const float* queries, int64_t nq,
             int k, int32_t* out_idx, float* out_d) {
  if (n == 0 || k <= 0) return -1;
  float mn[3] = {1e30f, 1e30f, 1e30f}, mx[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < n; i++)
    for (int c = 0; c < 3; c++) {
      mn[c] = std::min(mn[c], pts[i * 3 + c]);
      mx[c] = std::max(mx[c], pts[i * 3 + c]);
    }
  double vol = 1.0;
  for (int c = 0; c < 3; c++) vol *= std::max(1e-12f, mx[c] - mn[c]);
  // Aim for ~2-8 points per cell.
  double cell = std::cbrt(vol * 4.0 / (double)n);
  int dims[3];
  for (int c = 0; c < 3; c++)
    dims[c] = std::max(1, std::min(512, (int)((mx[c] - mn[c]) / cell) + 1));
  auto cell_of = [&](const float* p, int* cc) {
    for (int c = 0; c < 3; c++) {
      int x = (int)((p[c] - mn[c]) / cell);
      cc[c] = std::max(0, std::min(dims[c] - 1, x));
    }
  };
  int64_t ncells = (int64_t)dims[0] * dims[1] * dims[2];
  std::vector<int32_t> counts(ncells + 1, 0);
  std::vector<int32_t> cidx(n);
  for (int64_t i = 0; i < n; i++) {
    int cc[3];
    cell_of(pts + i * 3, cc);
    int64_t ci = ((int64_t)cc[0] * dims[1] + cc[1]) * dims[2] + cc[2];
    cidx[i] = (int32_t)ci;
    counts[ci + 1]++;
  }
  for (int64_t i = 0; i < ncells; i++) counts[i + 1] += counts[i];
  std::vector<int32_t> order(n);
  {
    std::vector<int32_t> cursor(counts.begin(), counts.end() - 1);
    for (int64_t i = 0; i < n; i++) order[cursor[cidx[i]]++] = (int32_t)i;
  }

#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t q = 0; q < nq; q++) {
    const float* qp = queries + q * 3;
    int qc[3];
    cell_of(qp, qc);
    std::vector<std::pair<float, int32_t>> best;
    best.reserve(k + 1);
    float worst = 1e30f;
    int max_shell = std::max(dims[0], std::max(dims[1], dims[2]));
    for (int shell = 0; shell <= max_shell; shell++) {
      // Stop when the shell's minimum possible distance exceeds worst.
      if ((int)best.size() == k) {
        float min_shell_d = (shell - 1) > 0 ? (float)(shell - 1) * cell : 0.f;
        if (min_shell_d * min_shell_d > worst) break;
      }
      int x0 = std::max(0, qc[0] - shell), x1 = std::min(dims[0] - 1, qc[0] + shell);
      int y0 = std::max(0, qc[1] - shell), y1 = std::min(dims[1] - 1, qc[1] + shell);
      int z0 = std::max(0, qc[2] - shell), z1 = std::min(dims[2] - 1, qc[2] + shell);
      for (int x = x0; x <= x1; x++)
        for (int y = y0; y <= y1; y++)
          for (int z = z0; z <= z1; z++) {
            // Only the shell surface (interior cells already done).
            if (shell > 0 && x != qc[0] - shell && x != qc[0] + shell &&
                y != qc[1] - shell && y != qc[1] + shell &&
                z != qc[2] - shell && z != qc[2] + shell)
              continue;
            int64_t ci = ((int64_t)x * dims[1] + y) * dims[2] + z;
            for (int32_t s = counts[ci]; s < counts[ci + 1]; s++) {
              int32_t pi = order[s];
              const float* pp = pts + (int64_t)pi * 3;
              float dx = pp[0] - qp[0], dy = pp[1] - qp[1], dz = pp[2] - qp[2];
              float d = dx * dx + dy * dy + dz * dz;
              if ((int)best.size() < k) {
                best.emplace_back(d, pi);
                std::push_heap(best.begin(), best.end());
                worst = best.front().first;
              } else if (d < worst) {
                // Reference behaviour (ngpd_tpu/native/ngpd_native.cpp:219):
                // points are visited in grid-cell order and replace the worst
                // only when strictly nearer, so among points tied at the k-th
                // distance the one kept may have a higher index than the lower
                // index jax.lax.top_k keeps. Distances are exact.
                std::pop_heap(best.begin(), best.end());
                best.back() = {d, pi};
                std::push_heap(best.begin(), best.end());
                worst = best.front().first;
              }
            }
          }
    }
    std::sort_heap(best.begin(), best.end());
    for (int j = 0; j < k; j++) {
      if (j < (int)best.size()) {
        out_d[q * k + j] = best[j].first;
        out_idx[q * k + j] = best[j].second;
      } else {
        out_d[q * k + j] = 1e30f;
        out_idx[q * k + j] = 0;
      }
    }
  }
  return 0;
}

}  // extern "C"
