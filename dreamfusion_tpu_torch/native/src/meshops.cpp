// meshops: native mesh pipeline of dreamfusion_tpu_torch, a copy of
// dreamfusion_tpu/native/src/meshops.cpp (the two packages give identical
// meshes; tests/test_torch_export.py checks it).
//
// Replaces the stable-dreamfusion mesh-export tool stack (its
// nerf/renderer.py:366-558 uses PyMCubes, pymeshlab and xatlas; its
// meshutils.py wraps pymeshlab), all of it CPU-side C++.
// Re-implemented from scratch:
//   * marching cubes         (PyMCubes equivalent; renderer.py:410)
//   * weld / clean / filter  (meshutils.clean_mesh equivalent; :75-116)
//   * quadric edge-collapse  (meshutils.decimate_mesh equivalent; :39-72)
//   * chart-growth UV atlas  (xatlas equivalent; renderer.py:442-447)
//
// Plain C ABI for ctypes.  Results are returned via an opaque handle with
// count/copy getters so Python owns allocation of the final numpy arrays.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <queue>
#include <unordered_map>
#include <vector>

#include "mc_tables.h"

namespace {

struct V3 {
  float x, y, z;
};
static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline float norm(V3 a) { return std::sqrt(dot(a, a)); }
static inline V3 normalize(V3 a) {
  float n = norm(a);
  return n > 1e-20f ? mul(a, 1.0f / n) : V3{0, 0, 0};
}

}  // namespace

struct MeshHandle {
  std::vector<float> verts;   // 3*nv
  std::vector<int32_t> tris;  // 3*nt
  std::vector<float> uv;      // 2*nv (unwrap only)
  std::vector<int32_t> src;   // nv   (unwrap only: source vertex id)
};

extern "C" {

void mops_counts(const MeshHandle* h, int64_t* nv, int64_t* nt) {
  *nv = (int64_t)(h->verts.size() / 3);
  *nt = (int64_t)(h->tris.size() / 3);
}

void mops_copy(const MeshHandle* h, float* verts, int32_t* tris) {
  if (verts && !h->verts.empty())
    std::memcpy(verts, h->verts.data(), h->verts.size() * sizeof(float));
  if (tris && !h->tris.empty())
    std::memcpy(tris, h->tris.data(), h->tris.size() * sizeof(int32_t));
}

void mops_get_uv(const MeshHandle* h, float* uv) {
  if (uv && !h->uv.empty())
    std::memcpy(uv, h->uv.data(), h->uv.size() * sizeof(float));
}

void mops_get_src(const MeshHandle* h, int32_t* src) {
  if (src && !h->src.empty())
    std::memcpy(src, h->src.data(), h->src.size() * sizeof(int32_t));
}

void mops_free(MeshHandle* h) { delete h; }

// ---------------------------------------------------------------------------
// Marching cubes.  grid is [nx, ny, nz] row-major (z fastest).  Surface at
// grid > iso (matches mcubes.marching_cubes(density, thresh) orientation).
// Vertices are in index space; Python rescales to world coordinates.
// ---------------------------------------------------------------------------
MeshHandle* mops_marching_cubes(const float* grid, int32_t nx, int32_t ny,
                                int32_t nz, float iso) {
  auto* h = new MeshHandle();
  auto gid = [&](int64_t x, int64_t y, int64_t z) -> int64_t {
    return (x * ny + y) * nz + z;
  };
  // global edge id: 3 canonical axis edges per grid point
  auto eid = [&](int64_t x, int64_t y, int64_t z, int axis) -> int64_t {
    return gid(x, y, z) * 3 + axis;
  };
  std::unordered_map<int64_t, int32_t> edge_vert;
  edge_vert.reserve(1 << 16);

  float corner[8];
  int64_t cx[8], cy[8], cz[8];
  for (int64_t x = 0; x + 1 < nx; ++x)
    for (int64_t y = 0; y + 1 < ny; ++y)
      for (int64_t z = 0; z + 1 < nz; ++z) {
        int cubeindex = 0;
        for (int c = 0; c < 8; ++c) {
          cx[c] = x + kCornerOffset[c][0];
          cy[c] = y + kCornerOffset[c][1];
          cz[c] = z + kCornerOffset[c][2];
          corner[c] = grid[gid(cx[c], cy[c], cz[c])];
          if (corner[c] > iso) cubeindex |= (1 << c);
        }
        if (cubeindex == 0 || cubeindex == 255) continue;
        const int8_t* tt = kTriTable[cubeindex];
        int32_t ev[12];
        for (int t = 0; tt[t] != -1; ++t) {
          int e = tt[t];
          int a = kEdgeCorners[e][0], b = kEdgeCorners[e][1];
          // canonical global edge: from the lower corner along its axis
          int lo = a, hi = b;
          if (cx[a] + cy[a] + cz[a] > cx[b] + cy[b] + cz[b]) std::swap(lo, hi);
          int axis = (cx[hi] != cx[lo]) ? 0 : (cy[hi] != cy[lo]) ? 1 : 2;
          int64_t key = eid(cx[lo], cy[lo], cz[lo], axis);
          auto it = edge_vert.find(key);
          if (it == edge_vert.end()) {
            float va = corner[a], vb = corner[b];
            float denom = vb - va;
            float tt2 = std::fabs(denom) < 1e-12f ? 0.5f : (iso - va) / denom;
            tt2 = std::min(1.0f, std::max(0.0f, tt2));
            float px = (float)cx[a] + tt2 * ((float)cx[b] - (float)cx[a]);
            float py = (float)cy[a] + tt2 * ((float)cy[b] - (float)cy[a]);
            float pz = (float)cz[a] + tt2 * ((float)cz[b] - (float)cz[a]);
            int32_t id = (int32_t)(h->verts.size() / 3);
            h->verts.insert(h->verts.end(), {px, py, pz});
            it = edge_vert.emplace(key, id).first;
          }
          ev[t % 3] = it->second;
          if (t % 3 == 2) {
            // inside = grid > iso; table winding gives outward normals for
            // "inside < iso", so flip to keep outward orientation.
            h->tris.insert(h->tris.end(), {ev[0], ev[2], ev[1]});
          }
        }
      }
  return h;
}

// ---------------------------------------------------------------------------
// Clean: weld (quantized grid), drop degenerate faces, remove small
// connected components (faces < max(min_faces, min_frac * largest)).
// ---------------------------------------------------------------------------
MeshHandle* mops_clean(const float* verts, int64_t nv, const int32_t* tris,
                       int64_t nt, float weld_eps, int32_t min_faces,
                       float min_frac) {
  std::vector<int32_t> remap(nv, -1);
  std::vector<float> wv;
  wv.reserve(nv * 3);
  if (weld_eps > 0) {
    struct KeyHash {
      size_t operator()(const std::array<int64_t, 3>& k) const {
        return (size_t)(k[0] * 73856093LL ^ k[1] * 19349663LL ^
                        k[2] * 83492791LL);
      }
    };
    std::unordered_map<std::array<int64_t, 3>, int32_t, KeyHash> cells;
    cells.reserve(nv);
    for (int64_t i = 0; i < nv; ++i) {
      std::array<int64_t, 3> key = {
          (int64_t)std::floor(verts[3 * i + 0] / weld_eps),
          (int64_t)std::floor(verts[3 * i + 1] / weld_eps),
          (int64_t)std::floor(verts[3 * i + 2] / weld_eps)};
      auto it = cells.find(key);
      if (it == cells.end()) {
        int32_t id = (int32_t)(wv.size() / 3);
        wv.insert(wv.end(), verts + 3 * i, verts + 3 * i + 3);
        cells.emplace(key, id);
        remap[i] = id;
      } else {
        remap[i] = it->second;
      }
    }
  } else {
    wv.assign(verts, verts + 3 * nv);
    for (int64_t i = 0; i < nv; ++i) remap[i] = (int32_t)i;
  }

  std::vector<int32_t> wt;
  wt.reserve(nt * 3);
  for (int64_t f = 0; f < nt; ++f) {
    int32_t a = remap[tris[3 * f]], b = remap[tris[3 * f + 1]],
            c = remap[tris[3 * f + 2]];
    if (a == b || b == c || a == c) continue;
    wt.insert(wt.end(), {a, b, c});
  }
  int64_t nwv = (int64_t)(wv.size() / 3), nwt = (int64_t)(wt.size() / 3);

  // connected components (union-find over vertices)
  std::vector<int32_t> parent(nwv);
  for (int64_t i = 0; i < nwv; ++i) parent[i] = (int32_t)i;
  std::function<int32_t(int32_t)> find = [&](int32_t a) {
    while (parent[a] != a) {
      parent[a] = parent[parent[a]];
      a = parent[a];
    }
    return a;
  };
  for (int64_t f = 0; f < nwt; ++f) {
    int32_t ra = find(wt[3 * f]), rb = find(wt[3 * f + 1]),
            rc = find(wt[3 * f + 2]);
    parent[rb] = ra;
    parent[rc] = ra;
  }
  std::unordered_map<int32_t, int64_t> comp_faces;
  for (int64_t f = 0; f < nwt; ++f) comp_faces[find(wt[3 * f])]++;
  int64_t largest = 0;
  for (auto& kv : comp_faces) largest = std::max(largest, kv.second);
  int64_t thresh =
      std::max((int64_t)min_faces, (int64_t)(min_frac * (double)largest));

  auto* h = new MeshHandle();
  std::vector<int32_t> vmap(nwv, -1);
  for (int64_t f = 0; f < nwt; ++f) {
    if (comp_faces[find(wt[3 * f])] < thresh) continue;
    int32_t out[3];
    for (int k = 0; k < 3; ++k) {
      int32_t v = wt[3 * f + k];
      if (vmap[v] < 0) {
        vmap[v] = (int32_t)(h->verts.size() / 3);
        h->verts.insert(h->verts.end(), wv.begin() + 3 * v,
                        wv.begin() + 3 * v + 3);
      }
      out[k] = vmap[v];
    }
    h->tris.insert(h->tris.end(), out, out + 3);
  }
  return h;
}

// ---------------------------------------------------------------------------
// Quadric edge-collapse decimation (Garland–Heckbert), lazy-heap variant.
// ---------------------------------------------------------------------------
namespace {

struct Quadric {
  // symmetric 4x4: a2 ab ac ad b2 bc bd c2 cd d2
  double q[10] = {0};
  void add_plane(double a, double b, double c, double d, double w) {
    q[0] += w * a * a;
    q[1] += w * a * b;
    q[2] += w * a * c;
    q[3] += w * a * d;
    q[4] += w * b * b;
    q[5] += w * b * c;
    q[6] += w * b * d;
    q[7] += w * c * c;
    q[8] += w * c * d;
    q[9] += w * d * d;
  }
  void add(const Quadric& o) {
    for (int i = 0; i < 10; ++i) q[i] += o.q[i];
  }
  double eval(double x, double y, double z) const {
    return q[0] * x * x + 2 * q[1] * x * y + 2 * q[2] * x * z + 2 * q[3] * x +
           q[4] * y * y + 2 * q[5] * y * z + 2 * q[6] * y + q[7] * z * z +
           2 * q[8] * z + q[9];
  }
  // solve for minimizing point; false if singular
  bool optimum(double* out) const {
    double A[9] = {q[0], q[1], q[2], q[1], q[4], q[5], q[2], q[5], q[7]};
    double b[3] = {-q[3], -q[6], -q[8]};
    double det = A[0] * (A[4] * A[8] - A[5] * A[7]) -
                 A[1] * (A[3] * A[8] - A[5] * A[6]) +
                 A[2] * (A[3] * A[7] - A[4] * A[6]);
    if (std::fabs(det) < 1e-12) return false;
    double inv = 1.0 / det;
    out[0] = inv * (b[0] * (A[4] * A[8] - A[5] * A[7]) -
                    A[1] * (b[1] * A[8] - A[5] * b[2]) +
                    A[2] * (b[1] * A[7] - A[4] * b[2]));
    out[1] = inv * (A[0] * (b[1] * A[8] - A[5] * b[2]) -
                    b[0] * (A[3] * A[8] - A[5] * A[6]) +
                    A[2] * (A[3] * b[2] - b[1] * A[6]));
    out[2] = inv * (A[0] * (A[4] * b[2] - b[1] * A[7]) -
                    A[1] * (A[3] * b[2] - b[1] * A[6]) +
                    b[0] * (A[3] * A[7] - A[4] * A[6]));
    return true;
  }
};

struct HeapEdge {
  double cost;
  int32_t v0, v1;
  uint32_t stamp0, stamp1;
  bool operator<(const HeapEdge& o) const { return cost > o.cost; }  // min-heap
};

}  // namespace

MeshHandle* mops_decimate(const float* verts_in, int64_t nv,
                          const int32_t* tris_in, int64_t nt,
                          int64_t target_faces) {
  std::vector<V3> V(nv);
  for (int64_t i = 0; i < nv; ++i)
    V[i] = {verts_in[3 * i], verts_in[3 * i + 1], verts_in[3 * i + 2]};
  std::vector<std::array<int32_t, 3>> F(nt);
  for (int64_t f = 0; f < nt; ++f)
    F[f] = {tris_in[3 * f], tris_in[3 * f + 1], tris_in[3 * f + 2]};

  std::vector<Quadric> Q(nv);
  std::vector<std::vector<int32_t>> vfaces(nv);
  std::vector<uint8_t> falive(nt, 1);
  for (int64_t f = 0; f < nt; ++f) {
    V3 p0 = V[F[f][0]], p1 = V[F[f][1]], p2 = V[F[f][2]];
    V3 n = cross(sub(p1, p0), sub(p2, p0));
    double area2 = norm(n);
    if (area2 < 1e-20) {
      falive[f] = 0;
      continue;
    }
    V3 un = mul(n, 1.0f / (float)area2);
    double d = -dot(un, p0);
    for (int k = 0; k < 3; ++k) {
      Q[F[f][k]].add_plane(un.x, un.y, un.z, d, 0.5 * area2);
      vfaces[F[f][k]].push_back((int32_t)f);
    }
  }

  std::vector<uint32_t> stamp(nv, 0);
  std::vector<uint8_t> valive(nv, 1);
  std::priority_queue<HeapEdge> heap;

  auto edge_cost = [&](int32_t a, int32_t b, V3* pos) -> double {
    Quadric q = Q[a];
    q.add(Q[b]);
    double p[3];
    if (q.optimum(p)) {
      *pos = {(float)p[0], (float)p[1], (float)p[2]};
    } else {
      V3 mid = mul(add(V[a], V[b]), 0.5f);
      double cm = q.eval(mid.x, mid.y, mid.z);
      double ca = q.eval(V[a].x, V[a].y, V[a].z);
      double cb = q.eval(V[b].x, V[b].y, V[b].z);
      *pos = (cm <= ca && cm <= cb) ? mid : (ca <= cb ? V[a] : V[b]);
    }
    return q.eval(pos->x, pos->y, pos->z);
  };
  auto push_edge = [&](int32_t a, int32_t b) {
    if (a == b) return;
    V3 pos;
    double c = edge_cost(a, b, &pos);
    heap.push({c, a, b, stamp[a], stamp[b]});
  };

  for (int64_t f = 0; f < nt; ++f) {
    if (!falive[f]) continue;
    for (int k = 0; k < 3; ++k) {
      int32_t a = F[f][k], b = F[f][(k + 1) % 3];
      if (a < b) push_edge(a, b);
    }
  }

  int64_t live_faces = 0;
  for (int64_t f = 0; f < nt; ++f) live_faces += falive[f];

  while (live_faces > target_faces && !heap.empty()) {
    HeapEdge e = heap.top();
    heap.pop();
    int32_t a = e.v0, b = e.v1;
    if (!valive[a] || !valive[b] || stamp[a] != e.stamp0 ||
        stamp[b] != e.stamp1)
      continue;
    V3 pos;
    edge_cost(a, b, &pos);

    // flip guard: faces around a and b that survive must not reverse normal
    bool flips = false;
    for (int pass = 0; pass < 2 && !flips; ++pass) {
      int32_t v = pass == 0 ? a : b;
      for (int32_t f : vfaces[v]) {
        if (!falive[f]) continue;
        auto& t = F[f];
        bool has_a = t[0] == a || t[1] == a || t[2] == a;
        bool has_b = t[0] == b || t[1] == b || t[2] == b;
        if (has_a && has_b) continue;  // face dies
        V3 p[3], pn[3];
        for (int k = 0; k < 3; ++k) {
          p[k] = V[t[k]];
          pn[k] = (t[k] == a || t[k] == b) ? pos : V[t[k]];
        }
        V3 n0 = cross(sub(p[1], p[0]), sub(p[2], p[0]));
        V3 n1 = cross(sub(pn[1], pn[0]), sub(pn[2], pn[0]));
        if (dot(n0, n1) <= 0) {
          flips = true;
          break;
        }
      }
    }
    if (flips) continue;

    // collapse b into a
    V[a] = pos;
    Q[a].add(Q[b]);
    valive[b] = 0;
    stamp[a]++;
    for (int32_t f : vfaces[b]) {
      if (!falive[f]) continue;
      auto& t = F[f];
      bool has_a = t[0] == a || t[1] == a || t[2] == a;
      if (has_a) {
        falive[f] = 0;
        live_faces--;
      } else {
        for (int k = 0; k < 3; ++k)
          if (t[k] == b) t[k] = a;
        vfaces[a].push_back(f);
      }
    }
    vfaces[b].clear();
    vfaces[b].shrink_to_fit();
    // re-push edges around a
    std::vector<int32_t> nbrs;
    for (int32_t f : vfaces[a]) {
      if (!falive[f]) continue;
      for (int k = 0; k < 3; ++k)
        if (F[f][k] != a) nbrs.push_back(F[f][k]);
    }
    std::sort(nbrs.begin(), nbrs.end());
    nbrs.erase(std::unique(nbrs.begin(), nbrs.end()), nbrs.end());
    for (int32_t n : nbrs) push_edge(std::min(a, n), std::max(a, n));
  }

  auto* h = new MeshHandle();
  std::vector<int32_t> vmap(nv, -1);
  for (int64_t f = 0; f < nt; ++f) {
    if (!falive[f]) continue;
    auto& t = F[f];
    if (t[0] == t[1] || t[1] == t[2] || t[0] == t[2]) continue;
    int32_t out[3];
    for (int k = 0; k < 3; ++k) {
      int32_t v = t[k];
      if (vmap[v] < 0) {
        vmap[v] = (int32_t)(h->verts.size() / 3);
        h->verts.insert(h->verts.end(), {V[v].x, V[v].y, V[v].z});
      }
      out[k] = vmap[v];
    }
    h->tris.insert(h->tris.end(), out, out + 3);
  }
  return h;
}

// ---------------------------------------------------------------------------
// UV atlas: greedy normal-clustered chart growth + planar projection +
// shelf packing.  Output duplicates vertices per chart; `src` maps each
// output vertex to its input vertex for attribute transfer.
// ---------------------------------------------------------------------------
MeshHandle* mops_unwrap(const float* verts_in, int64_t nv,
                        const int32_t* tris_in, int64_t nt, int32_t atlas_res,
                        float padding_px, float max_angle_deg) {
  std::vector<V3> V(nv);
  for (int64_t i = 0; i < nv; ++i)
    V[i] = {verts_in[3 * i], verts_in[3 * i + 1], verts_in[3 * i + 2]};

  // face normals + edge adjacency
  std::vector<V3> fn(nt);
  for (int64_t f = 0; f < nt; ++f) {
    V3 p0 = V[tris_in[3 * f]], p1 = V[tris_in[3 * f + 1]],
       p2 = V[tris_in[3 * f + 2]];
    fn[f] = normalize(cross(sub(p1, p0), sub(p2, p0)));
  }
  std::unordered_map<int64_t, std::vector<int32_t>> edge_faces;
  edge_faces.reserve(nt * 3);
  auto ekey = [&](int32_t a, int32_t b) -> int64_t {
    if (a > b) std::swap(a, b);
    return ((int64_t)a << 32) | (uint32_t)b;
  };
  for (int64_t f = 0; f < nt; ++f)
    for (int k = 0; k < 3; ++k)
      edge_faces[ekey(tris_in[3 * f + k], tris_in[3 * f + (k + 1) % 3])]
          .push_back((int32_t)f);

  const float cos_thresh = std::cos(max_angle_deg * 3.14159265f / 180.0f);
  const int64_t max_chart_faces = std::max<int64_t>(64, nt / 8);
  std::vector<int32_t> chart_of(nt, -1);
  std::vector<std::vector<int32_t>> charts;
  for (int64_t seed = 0; seed < nt; ++seed) {
    if (chart_of[seed] >= 0) continue;
    int32_t cid = (int32_t)charts.size();
    charts.emplace_back();
    V3 cn = fn[seed];
    std::queue<int32_t> q;
    q.push((int32_t)seed);
    chart_of[seed] = cid;
    int64_t assigned = 1;  // faces with chart_of == cid (incl. queued)
    while (!q.empty()) {
      int32_t f = q.front();
      q.pop();
      charts[cid].push_back(f);
      if (assigned >= max_chart_faces) continue;  // drain queue, stop growing
      for (int k = 0; k < 3; ++k) {
        for (int32_t g :
             edge_faces[ekey(tris_in[3 * f + k], tris_in[3 * f + (k + 1) % 3])]) {
          if (chart_of[g] >= 0) continue;
          if (dot(fn[g], cn) < cos_thresh) continue;
          chart_of[g] = cid;
          q.push(g);
          ++assigned;
        }
      }
    }
  }

  // per-chart planar projection
  struct Chart {
    std::vector<int32_t> faces;
    std::vector<int32_t> overts;            // output vertex ids
    std::unordered_map<int32_t, int32_t> v2o;  // input vert -> output vert
    std::vector<float> u, v;                // local 2D coords
    float w = 0, hgt = 0;                   // bbox size (world units)
    float ox = 0, oy = 0;                   // pack offset (atlas units)
  };
  auto* h = new MeshHandle();
  std::vector<Chart> C(charts.size());
  for (size_t c = 0; c < charts.size(); ++c) {
    Chart& ch = C[c];
    ch.faces = charts[c];
    V3 n = {0, 0, 0};
    for (int32_t f : ch.faces) n = add(n, fn[f]);
    n = normalize(n);
    if (norm(n) < 0.5f) n = fn[ch.faces[0]];
    V3 up = std::fabs(n.z) < 0.9f ? V3{0, 0, 1} : V3{1, 0, 0};
    V3 t0 = normalize(cross(up, n));
    V3 t1 = cross(n, t0);
    float umin = 1e30f, vmin = 1e30f, umax = -1e30f, vmax = -1e30f;
    for (int32_t f : ch.faces) {
      for (int k = 0; k < 3; ++k) {
        int32_t vi = tris_in[3 * f + k];
        if (ch.v2o.count(vi)) continue;
        int32_t oid = (int32_t)(h->verts.size() / 3);
        ch.v2o.emplace(vi, oid);
        ch.overts.push_back(oid);
        h->verts.insert(h->verts.end(), {V[vi].x, V[vi].y, V[vi].z});
        h->src.push_back(vi);
        float uu = dot(V[vi], t0), vv = dot(V[vi], t1);
        ch.u.push_back(uu);
        ch.v.push_back(vv);
        umin = std::min(umin, uu);
        umax = std::max(umax, uu);
        vmin = std::min(vmin, vv);
        vmax = std::max(vmax, vv);
      }
      int32_t o0 = ch.v2o[tris_in[3 * f]], o1 = ch.v2o[tris_in[3 * f + 1]],
              o2 = ch.v2o[tris_in[3 * f + 2]];
      h->tris.insert(h->tris.end(), {o0, o1, o2});
    }
    for (size_t i = 0; i < ch.u.size(); ++i) {
      ch.u[i] -= umin;
      ch.v[i] -= vmin;
    }
    ch.w = umax - umin;
    ch.hgt = vmax - vmin;
  }

  // shelf packing with binary search on global scale
  float pad = padding_px / (float)atlas_res;
  double total_area = 0;
  for (auto& ch : C) total_area += (double)ch.w * ch.hgt;
  float scale = total_area > 0 ? (float)std::sqrt(0.6 / total_area) : 1.0f;
  std::vector<int32_t> order(C.size());
  for (size_t i = 0; i < C.size(); ++i) order[i] = (int32_t)i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return C[a].hgt > C[b].hgt;
  });
  auto try_pack = [&](float s) -> bool {
    float x = pad, y = pad, shelf_h = 0;
    for (int32_t ci : order) {
      Chart& ch = C[ci];
      float cw = ch.w * s + pad, chh = ch.hgt * s + pad;
      if (cw > 1.0f - pad || chh > 1.0f - pad) return false;
      if (x + cw > 1.0f - pad * 0.5f) {
        x = pad;
        y += shelf_h;
        shelf_h = 0;
      }
      if (y + chh > 1.0f - pad * 0.5f) return false;
      ch.ox = x;
      ch.oy = y;
      x += cw;
      shelf_h = std::max(shelf_h, chh);
    }
    return true;
  };
  float lo = 0.0f, hi = scale * 2.0f;
  for (int it = 0; it < 40; ++it) {
    float mid = 0.5f * (lo + hi);
    if (try_pack(mid))
      lo = mid;
    else
      hi = mid;
  }
  try_pack(lo);

  h->uv.resize(h->verts.size() / 3 * 2);
  for (auto& ch : C) {
    for (size_t i = 0; i < ch.overts.size(); ++i) {
      int32_t o = ch.overts[i];
      h->uv[2 * o] = ch.ox + ch.u[i] * lo;
      h->uv[2 * o + 1] = ch.oy + ch.v[i] * lo;
    }
  }
  return h;
}

}  // extern "C"
