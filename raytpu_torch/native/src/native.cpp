// The host library of raytpu_torch: the OBJ parser, the binned-SAH BVH
// builder whose leaf order sets the triangle order of meshes over 256
// faces, the Morton order, a CPU BVH closest hit (an oracle for the
// closest-hit kernels), the BMP writer and a monotonic clock.
//
// A copy of raytpu/native/src/native.cpp, function for function, built with
// the same g++ flags (raytpu_torch/native/runtime.py).  The SAH leaf order
// decides the triangle order, and the triangle order decides closest-hit
// ties, so the port must reproduce raytpu's permutation bit for bit: change
// nothing here that raytpu's copy does not change too.
//
// Built as a plain shared library; Python binds via ctypes (no pybind11).

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <numeric>
#include <sstream>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Timer
// ---------------------------------------------------------------------------

double rt_monotonic() {
  using clock = std::chrono::steady_clock;
  return std::chrono::duration<double>(clock::now().time_since_epoch()).count();
}

// ---------------------------------------------------------------------------
// OBJ parser — same observable semantics as the reference parser:
// only 'v' and 'f' records, first '/'-field of each face index, 1-based,
// per-face normals normalize(cross(v1-v0, v2-v0)).
// ---------------------------------------------------------------------------

struct ObjData {
  std::vector<float> positions;  // V*3
  std::vector<float> normals;    // F*3
  std::vector<int32_t> indices;  // F*3
};

static ObjData* g_last_obj = nullptr;

int rt_parse_obj(const char* path, const float** positions, int* num_pos,
                 const float** normals, const int32_t** indices, int* num_faces) {
  std::ifstream file(path, std::ios::binary);
  if (!file) return -1;
  std::string buf((std::istreambuf_iterator<char>(file)), std::istreambuf_iterator<char>());
  auto* d = new ObjData();
  const char* p = buf.c_str();
  const char* end = p + buf.size();
  auto skip_ws = [&](const char*& c) {
    while (c < end && (*c == ' ' || *c == '\t' || *c == '\r')) ++c;
  };
  auto skip_line = [&](const char*& c) {
    while (c < end && *c != '\n') ++c;
    if (c < end) ++c;
  };
  while (p < end) {
    skip_ws(p);
    if (p + 1 < end && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      ++p;
      char* q;
      float x = std::strtof(p, &q);
      float y = std::strtof(q, &q);
      float z = std::strtof(q, &q);
      p = q;
      d->positions.push_back(x);
      d->positions.push_back(y);
      d->positions.push_back(z);
    } else if (p + 1 < end && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      ++p;
      // first '/'-delimited field of each of three tokens, parsed as float
      // then truncated, 1-based -> 0-based (the reference's stof path)
      for (int k = 0; k < 3; ++k) {
        char* q;
        float idx = std::strtof(p, &q);
        p = q;
        d->indices.push_back(static_cast<int32_t>(idx) - 1);
        while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') ++p;  // skip /n/m
      }
    }
    skip_line(p);
  }
  size_t nf = d->indices.size() / 3;
  d->normals.resize(nf * 3);
  for (size_t f = 0; f < nf; ++f) {
    int32_t i0 = d->indices[f * 3], i1 = d->indices[f * 3 + 1], i2 = d->indices[f * 3 + 2];
    const float* p0 = &d->positions[i0 * 3];
    const float* p1 = &d->positions[i1 * 3];
    const float* p2 = &d->positions[i2 * 3];
    float e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
    float e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
    float n[3] = {e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                  e1[0] * e2[1] - e1[1] * e2[0]};
    float len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len > 0) {
      n[0] /= len;
      n[1] /= len;
      n[2] /= len;
    }
    d->normals[f * 3] = n[0];
    d->normals[f * 3 + 1] = n[1];
    d->normals[f * 3 + 2] = n[2];
  }
  delete g_last_obj;
  g_last_obj = d;
  *positions = d->positions.data();
  *num_pos = static_cast<int>(d->positions.size() / 3);
  *normals = d->normals.data();
  *indices = d->indices.data();
  *num_faces = static_cast<int>(nf);
  return 0;
}

// ---------------------------------------------------------------------------
// Morton spatial ordering: sort triangles by the Morton code of their
// centroid so contiguous chunks are spatially coherent (tight chunk AABBs
// for chunk culling).
// ---------------------------------------------------------------------------

static uint32_t expand_bits10(uint32_t v) {
  v &= 0x3ff;
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

// tri_verts: T x 9 floats (v0 v1 v2). perm_out: T indices (new order).
void rt_morton_order(const float* tri_verts, int num_tris, int32_t* perm_out) {
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  std::vector<float> cent(num_tris * 3);
  for (int t = 0; t < num_tris; ++t) {
    for (int a = 0; a < 3; ++a) {
      float c = (tri_verts[t * 9 + a] + tri_verts[t * 9 + 3 + a] + tri_verts[t * 9 + 6 + a]) / 3.0f;
      cent[t * 3 + a] = c;
      lo[a] = std::min(lo[a], c);
      hi[a] = std::max(hi[a], c);
    }
  }
  std::vector<std::pair<uint32_t, int32_t>> keys(num_tris);
  for (int t = 0; t < num_tris; ++t) {
    uint32_t code = 0;
    uint32_t xyz[3];
    for (int a = 0; a < 3; ++a) {
      float range = hi[a] - lo[a];
      float u = range > 0 ? (cent[t * 3 + a] - lo[a]) / range : 0.5f;
      xyz[a] = static_cast<uint32_t>(std::min(1023.0f, std::max(0.0f, u * 1023.0f)));
    }
    code = (expand_bits10(xyz[0]) << 2) | (expand_bits10(xyz[1]) << 1) | expand_bits10(xyz[2]);
    keys[t] = {code, t};
  }
  std::stable_sort(keys.begin(), keys.end());
  for (int t = 0; t < num_tris; ++t) perm_out[t] = keys[t].second;
}

// ---------------------------------------------------------------------------
// Binned-SAH BVH builder (flat nodes, left child = leftNode, right = +1).
// TPU-side consumption: either full traversal order, or leaf order as the
// triangle permutation for chunked culling.
// ---------------------------------------------------------------------------

struct BuildTri {
  float lo[3], hi[3], cent[3];
  int32_t id;
};

struct Node {
  float lo[3], hi[3];
  int32_t first, count, left;  // count>0 => leaf over prim_order[first..first+count)
};

struct BvhState {
  std::vector<Node> nodes;
  std::vector<BuildTri> tris;
  int leaf_size, bins;
};

static void node_bounds(BvhState& st, Node& n) {
  for (int a = 0; a < 3; ++a) {
    n.lo[a] = INFINITY;
    n.hi[a] = -INFINITY;
  }
  for (int i = n.first; i < n.first + n.count; ++i) {
    for (int a = 0; a < 3; ++a) {
      n.lo[a] = std::min(n.lo[a], st.tris[i].lo[a]);
      n.hi[a] = std::max(n.hi[a], st.tris[i].hi[a]);
    }
  }
}

static float half_area(const float lo[3], const float hi[3]) {
  float e[3] = {std::max(0.0f, hi[0] - lo[0]), std::max(0.0f, hi[1] - lo[1]),
                std::max(0.0f, hi[2] - lo[2])};
  return e[0] * e[1] + e[1] * e[2] + e[2] * e[0];
}

static void subdivide(BvhState& st, int32_t node_idx) {
  Node& n = st.nodes[node_idx];
  if (n.count <= st.leaf_size) return;

  // binned SAH over the centroid extent of each axis
  int best_axis = -1, best_split = -1;
  float best_cost = half_area(n.lo, n.hi) * n.count;
  float cb_lo[3] = {INFINITY, INFINITY, INFINITY}, cb_hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int i = n.first; i < n.first + n.count; ++i)
    for (int a = 0; a < 3; ++a) {
      cb_lo[a] = std::min(cb_lo[a], st.tris[i].cent[a]);
      cb_hi[a] = std::max(cb_hi[a], st.tris[i].cent[a]);
    }
  const int B = st.bins;
  std::vector<float> blo(B * 3), bhi(B * 3);
  std::vector<int> bcount(B);
  float best_pos = 0;
  for (int axis = 0; axis < 3; ++axis) {
    float extent = cb_hi[axis] - cb_lo[axis];
    if (extent <= 0) continue;
    std::fill(bcount.begin(), bcount.end(), 0);
    std::fill(blo.begin(), blo.end(), INFINITY);
    std::fill(bhi.begin(), bhi.end(), -INFINITY);
    float scale = B / extent;
    for (int i = n.first; i < n.first + n.count; ++i) {
      int b = std::min(B - 1, static_cast<int>((st.tris[i].cent[axis] - cb_lo[axis]) * scale));
      bcount[b]++;
      for (int a = 0; a < 3; ++a) {
        blo[b * 3 + a] = std::min(blo[b * 3 + a], st.tris[i].lo[a]);
        bhi[b * 3 + a] = std::max(bhi[b * 3 + a], st.tris[i].hi[a]);
      }
    }
    // prefix/suffix sweeps of area*count
    std::vector<float> left_cost(B), right_cost(B);
    float alo[3] = {INFINITY, INFINITY, INFINITY}, ahi[3] = {-INFINITY, -INFINITY, -INFINITY};
    int acount = 0;
    for (int b = 0; b < B - 1; ++b) {
      acount += bcount[b];
      for (int a = 0; a < 3; ++a) {
        alo[a] = std::min(alo[a], blo[b * 3 + a]);
        ahi[a] = std::max(ahi[a], bhi[b * 3 + a]);
      }
      left_cost[b] = acount ? half_area(alo, ahi) * acount : 0;
    }
    float zlo[3] = {INFINITY, INFINITY, INFINITY}, zhi[3] = {-INFINITY, -INFINITY, -INFINITY};
    int zcount = 0;
    for (int b = B - 1; b >= 1; --b) {
      zcount += bcount[b];
      for (int a = 0; a < 3; ++a) {
        zlo[a] = std::min(zlo[a], blo[b * 3 + a]);
        zhi[a] = std::max(zhi[a], bhi[b * 3 + a]);
      }
      right_cost[b - 1] = zcount ? half_area(zlo, zhi) * zcount : 0;
    }
    for (int b = 0; b < B - 1; ++b) {
      float cost = left_cost[b] + right_cost[b];
      if (cost > 0 && cost < best_cost) {
        best_cost = cost;
        best_axis = axis;
        best_split = b;
        best_pos = cb_lo[axis] + (b + 1) * (extent / B);
      }
    }
  }
  if (best_axis < 0) return;  // leaf is cheaper

  // in-place partition by bin boundary
  int i = n.first, j = n.first + n.count - 1;
  while (i <= j) {
    if (st.tris[i].cent[best_axis] < best_pos) {
      ++i;
    } else {
      std::swap(st.tris[i], st.tris[j]);
      --j;
    }
  }
  int left_count = i - n.first;
  if (left_count == 0 || left_count == n.count) return;

  int32_t li = static_cast<int32_t>(st.nodes.size());
  st.nodes.push_back({});
  st.nodes.push_back({});
  Node& nn = st.nodes[node_idx];  // re-reference (vector may have grown)
  st.nodes[li].first = nn.first;
  st.nodes[li].count = left_count;
  st.nodes[li].left = 0;
  st.nodes[li + 1].first = nn.first + left_count;
  st.nodes[li + 1].count = nn.count - left_count;
  st.nodes[li + 1].left = 0;
  node_bounds(st, st.nodes[li]);
  node_bounds(st, st.nodes[li + 1]);
  nn.left = li;
  nn.count = 0;
  subdivide(st, li);
  subdivide(st, li + 1);
}

// tri_verts: T x 9.  Outputs (caller-allocated):
//   node_bounds_out: (2T, 6) [lo, hi]
//   node_meta_out:   (2T, 3) [first, count, left]
//   prim_order_out:  (T,) original triangle ids in BVH order
// Returns node count (or -1 on error).
int rt_build_bvh(const float* tri_verts, int num_tris, int leaf_size, int bins,
                 float* node_bounds_out, int32_t* node_meta_out, int32_t* prim_order_out) {
  if (num_tris <= 0) return 0;
  BvhState st;
  st.leaf_size = std::max(1, leaf_size);
  st.bins = std::max(2, bins);
  st.tris.resize(num_tris);
  for (int t = 0; t < num_tris; ++t) {
    BuildTri& bt = st.tris[t];
    bt.id = t;
    for (int a = 0; a < 3; ++a) {
      float v0 = tri_verts[t * 9 + a], v1 = tri_verts[t * 9 + 3 + a], v2 = tri_verts[t * 9 + 6 + a];
      bt.lo[a] = std::min(v0, std::min(v1, v2));
      bt.hi[a] = std::max(v0, std::max(v1, v2));
      bt.cent[a] = (v0 + v1 + v2) / 3.0f;
    }
  }
  st.nodes.reserve(2 * num_tris);
  st.nodes.push_back({});
  st.nodes[0].first = 0;
  st.nodes[0].count = num_tris;
  st.nodes[0].left = 0;
  node_bounds(st, st.nodes[0]);
  subdivide(st, 0);

  int nn = static_cast<int>(st.nodes.size());
  for (int i = 0; i < nn; ++i) {
    const Node& n = st.nodes[i];
    for (int a = 0; a < 3; ++a) {
      node_bounds_out[i * 6 + a] = n.lo[a];
      node_bounds_out[i * 6 + 3 + a] = n.hi[a];
    }
    node_meta_out[i * 3] = n.first;
    node_meta_out[i * 3 + 1] = n.count;
    node_meta_out[i * 3 + 2] = n.left;
  }
  for (int t = 0; t < num_tris; ++t) prim_order_out[t] = st.tris[t].id;
  return nn;
}

// ---------------------------------------------------------------------------
// CPU BVH closest-hit traversal (validation oracle for the builder)
// ---------------------------------------------------------------------------

static bool slab_test(const float lo[3], const float hi[3], const float ro[3],
                      const float inv_d[3], float tmax) {
  float tmin_v = -INFINITY, tmax_v = INFINITY;
  for (int a = 0; a < 3; ++a) {
    float t1 = (lo[a] - ro[a]) * inv_d[a];
    float t2 = (hi[a] - ro[a]) * inv_d[a];
    tmin_v = std::max(tmin_v, std::min(t1, t2));
    tmax_v = std::min(tmax_v, std::max(t1, t2));
  }
  return tmax_v > 0 && tmax_v >= tmin_v && tmin_v <= tmax;
}

// Returns closest triangle id (original numbering) or -1; writes t.
int rt_bvh_closest_hit(const float* tri_verts, const float* node_bounds,
                       const int32_t* node_meta, const int32_t* prim_order, int num_nodes,
                       const float* ro, const float* rd, float tmin, float* t_out) {
  (void)num_nodes;
  float inv_d[3] = {1.0f / rd[0], 1.0f / rd[1], 1.0f / rd[2]};
  float best_t = INFINITY;
  int best_id = -1;
  int32_t stack[128];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    int32_t ni = stack[--sp];
    const float* lo = &node_bounds[ni * 6];
    const float* hi = &node_bounds[ni * 6 + 3];
    if (!slab_test(lo, hi, ro, inv_d, best_t)) continue;
    int32_t first = node_meta[ni * 3], count = node_meta[ni * 3 + 1], left = node_meta[ni * 3 + 2];
    if (count > 0) {
      for (int k = first; k < first + count; ++k) {
        int32_t id = prim_order[k];
        const float* v0 = &tri_verts[id * 9];
        const float* v1 = &tri_verts[id * 9 + 3];
        const float* v2 = &tri_verts[id * 9 + 6];
        float e1[3] = {v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2]};
        float e2[3] = {v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2]};
        float h[3] = {rd[1] * e2[2] - rd[2] * e2[1], rd[2] * e2[0] - rd[0] * e2[2],
                      rd[0] * e2[1] - rd[1] * e2[0]};
        float a = e1[0] * h[0] + e1[1] * h[1] + e1[2] * h[2];
        if (std::fabs(a) < 1.1920929e-07f) continue;
        float f = 1.0f / a;
        float s[3] = {ro[0] - v0[0], ro[1] - v0[1], ro[2] - v0[2]};
        float u = f * (s[0] * h[0] + s[1] * h[1] + s[2] * h[2]);
        if (u < 0 || u > 1) continue;
        float q[3] = {s[1] * e1[2] - s[2] * e1[1], s[2] * e1[0] - s[0] * e1[2],
                      s[0] * e1[1] - s[1] * e1[0]};
        float v = f * (rd[0] * q[0] + rd[1] * q[1] + rd[2] * q[2]);
        if (v < 0 || u + v > 1) continue;
        float t = f * (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]);
        if (t < tmin || t >= best_t) continue;
        best_t = t;
        best_id = id;
      }
    } else {
      stack[sp++] = left + 1;
      stack[sp++] = left;
    }
  }
  *t_out = best_t;
  return best_id;
}

// ---------------------------------------------------------------------------
// BMP writer (24-bit BI_RGB, bottom-up) — screenshot parity with SDL_SaveBMP
// ---------------------------------------------------------------------------

int rt_write_bmp(const char* path, int w, int h, const uint8_t* rgb) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  int row = (w * 3 + 3) & ~3;
  uint32_t pixel_bytes = row * h;
  uint32_t off = 14 + 40;
  uint8_t hdr[54] = {0};
  hdr[0] = 'B';
  hdr[1] = 'M';
  uint32_t fsize = off + pixel_bytes;
  std::memcpy(hdr + 2, &fsize, 4);
  std::memcpy(hdr + 10, &off, 4);
  uint32_t hsz = 40;
  std::memcpy(hdr + 14, &hsz, 4);
  std::memcpy(hdr + 18, &w, 4);
  std::memcpy(hdr + 22, &h, 4);
  uint16_t planes = 1, bpp = 24;
  std::memcpy(hdr + 26, &planes, 2);
  std::memcpy(hdr + 28, &bpp, 2);
  std::memcpy(hdr + 34, &pixel_bytes, 4);
  std::fwrite(hdr, 1, 54, f);
  std::vector<uint8_t> line(row, 0);
  for (int y = h - 1; y >= 0; --y) {
    for (int x = 0; x < w; ++x) {
      line[x * 3] = rgb[(y * w + x) * 3 + 2];
      line[x * 3 + 1] = rgb[(y * w + x) * 3 + 1];
      line[x * 3 + 2] = rgb[(y * w + x) * 3];
    }
    std::fwrite(line.data(), 1, row, f);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
