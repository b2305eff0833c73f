// Native BVH builder — binned-SAH build + octant-ordered skip-pointer
// flatten + packed primitive rows, emitted directly into caller-allocated
// buffers (ctypes interface, no pybind11 dependency).
//
// Counterpart of the reference's C++ `BVHAccel` constructor +
// the CUDA tracer's host-side "flatten BVH → linear node array" step
// (SURVEY.md §2 rows 9, 14).  The Python fallback (tpu_pt/bvh/sah.py +
// packed.py) implements the identical layout; tests assert equivalence.
//
// Build: tpu_pt/bvh/native.py compiles it at first use
// (g++ -O3 -shared -fPIC) into build/, which git ignores.
//
// Layout contract (must match tpu_pt/bvh/packed.py):
//   nodes:  8 octants × N nodes × 8 f32 rows
//           [min.xyz, max.xyz, skip(i32 bits), meta(i32 bits)]
//           meta = -1 for inner, else prim_start | (count << 26)
//   prims:  P × 16 f32 rows; tri: [v0, e1, e2, matf, 0type, pad...]
//                            sphere: [c, r, 0,0, 0,0,0, matf, 1, pad...]
//   prim_gid: P × i32 global primitive ids (leaf-order permutation)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int N_BINS = 16;

struct V3 {
  float x, y, z;
  V3() : x(0), y(0), z(0) {}
  V3(float a, float b, float c) : x(a), y(b), z(c) {}
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

static inline V3 vmin(const V3 &a, const V3 &b) {
  return V3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
static inline V3 vmax(const V3 &a, const V3 &b) {
  return V3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct AABB {
  V3 lo{1e30f, 1e30f, 1e30f};
  V3 hi{-1e30f, -1e30f, -1e30f};
  void grow(const AABB &o) {
    lo = vmin(lo, o.lo);
    hi = vmax(hi, o.hi);
  }
  float area() const {
    float dx = std::max(hi.x - lo.x, 0.f);
    float dy = std::max(hi.y - lo.y, 0.f);
    float dz = std::max(hi.z - lo.z, 0.f);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Node {
  AABB bb;
  int left = -1;   // -1 = leaf
  int right = -1;
  int start = 0;   // leaf: offset into prim permutation
  int count = 0;
};

struct Builder {
  const float *lo, *hi;  // (P,3) primitive bounds
  int n;
  int max_leaf;
  std::vector<V3> cent;
  std::vector<int> perm;       // leaf-order primitive permutation
  std::vector<Node> nodes;

  int build(int *ids, int count, int offset) {
    int me = (int)nodes.size();
    nodes.emplace_back();
    AABB bb;
    for (int i = 0; i < count; i++) {
      AABB p;
      p.lo = V3(lo[3 * ids[i]], lo[3 * ids[i] + 1], lo[3 * ids[i] + 2]);
      p.hi = V3(hi[3 * ids[i]], hi[3 * ids[i] + 1], hi[3 * ids[i] + 2]);
      bb.grow(p);
    }
    nodes[me].bb = bb;
    if (count <= max_leaf) {
      nodes[me].start = offset;
      nodes[me].count = count;
      std::memcpy(&perm[offset], ids, count * sizeof(int));
      return me;
    }
    // Centroid bounds + widest axis.
    V3 cmin(1e30f, 1e30f, 1e30f), cmax(-1e30f, -1e30f, -1e30f);
    for (int i = 0; i < count; i++) {
      cmin = vmin(cmin, cent[ids[i]]);
      cmax = vmax(cmax, cent[ids[i]]);
    }
    float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int axis = ext[1] > ext[0] ? 1 : 0;
    if (ext[2] > ext[axis]) axis = 2;
    int mid;
    if (ext[axis] <= 1e-12f) {
      mid = count / 2;
    } else {
      // Binned SAH.
      AABB bins_bb[N_BINS];
      int bins_n[N_BINS] = {0};
      float inv = (float)N_BINS / ext[axis];
      float base = cmin[axis];
      auto bin_of = [&](int id) {
        int b = (int)((cent[id][axis] - base) * inv);
        return std::min(std::max(b, 0), N_BINS - 1);
      };
      for (int i = 0; i < count; i++) {
        int b = bin_of(ids[i]);
        AABB p;
        p.lo = V3(lo[3 * ids[i]], lo[3 * ids[i] + 1], lo[3 * ids[i] + 2]);
        p.hi = V3(hi[3 * ids[i]], hi[3 * ids[i] + 1], hi[3 * ids[i] + 2]);
        bins_bb[b].grow(p);
        bins_n[b]++;
      }
      AABB suf[N_BINS];
      AABB acc;
      for (int b = N_BINS - 1; b >= 0; b--) {
        acc.grow(bins_bb[b]);
        suf[b] = acc;
      }
      float best = 1e30f;
      int best_s = -1;
      AABB pre;
      int nl = 0;
      for (int s = 0; s < N_BINS - 1; s++) {
        pre.grow(bins_bb[s]);
        nl += bins_n[s];
        int nr = count - nl;
        if (nl == 0 || nr == 0) continue;
        float c = pre.area() * nl + suf[s + 1].area() * nr;
        if (c < best) {
          best = c;
          best_s = s;
        }
      }
      if (best_s < 0) {
        // Degenerate: median split on centroid.
        std::nth_element(ids, ids + count / 2, ids + count,
                         [&](int a, int b) {
                           return cent[a][axis] < cent[b][axis];
                         });
        mid = count / 2;
      } else {
        mid = (int)(std::partition(ids, ids + count, [&](int id) {
                      return bin_of(id) <= best_s;
                    }) -
                    ids);
        if (mid == 0 || mid == count) mid = count / 2;  // safety
      }
    }
    int l = build(ids, mid, offset);
    int r = build(ids + mid, count - mid, offset + mid);
    nodes[me].left = l;
    nodes[me].right = r;
    return me;
  }
};

// Iterative DFS emit for one octant ordering.
static void emit_octant(const std::vector<Node> &nodes, int octant,
                        float *out /* N x 8 */) {
  int n = (int)nodes.size();
  // subtree sizes
  std::vector<int> size(n, 1);
  for (int i = n - 1; i >= 0; i--) {
    if (nodes[i].left >= 0) size[i] = 1 + size[nodes[i].left] + size[nodes[i].right];
  }
  bool sign[3] = {bool(octant & 1), bool(octant & 2), bool(octant & 4)};
  struct Item {
    int node, skip;
  };
  std::vector<Item> stack;
  stack.push_back({0, n});
  int cursor = 0;
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    const Node &nd = nodes[it.node];
    float *row = out + 8 * cursor;
    row[0] = nd.bb.lo.x;
    row[1] = nd.bb.lo.y;
    row[2] = nd.bb.lo.z;
    row[3] = nd.bb.hi.x;
    row[4] = nd.bb.hi.y;
    row[5] = nd.bb.hi.z;
    int32_t skip = it.skip;
    std::memcpy(&row[6], &skip, 4);
    int32_t meta;
    if (nd.left < 0) {
      meta = nd.start | (nd.count << 26);
    } else {
      meta = -1;
      // Order children near-first for this octant by widest parent axis.
      float ext[3] = {nd.bb.hi.x - nd.bb.lo.x, nd.bb.hi.y - nd.bb.lo.y,
                      nd.bb.hi.z - nd.bb.lo.z};
      int axis = ext[1] > ext[0] ? 1 : 0;
      if (ext[2] > ext[axis]) axis = 2;
      const Node &L = nodes[nd.left];
      const Node &R = nodes[nd.right];
      float cl = L.bb.lo[axis] + L.bb.hi[axis];
      float cr = R.bb.lo[axis] + R.bb.hi[axis];
      int first = nd.left, second = nd.right;
      if (cr < cl) {
        first = nd.right;
        second = nd.left;
      }
      if (sign[axis]) std::swap(first, second);
      stack.push_back({second, it.skip});
      stack.push_back({first, cursor + 1 + size[first]});
    }
    std::memcpy(&row[7], &meta, 4);
    cursor++;
  }
}

}  // namespace

extern "C" {

// Pass 1: build tree, report node count.  Returns an opaque handle.
void *bvh_build(const float *lo, const float *hi, int n_prims, int max_leaf,
                int *out_n_nodes) {
  auto *b = new Builder();
  b->lo = lo;
  b->hi = hi;
  b->n = n_prims;
  b->max_leaf = max_leaf;
  b->cent.resize(n_prims);
  for (int i = 0; i < n_prims; i++) {
    b->cent[i] = V3((lo[3 * i] + hi[3 * i]) * .5f,
                    (lo[3 * i + 1] + hi[3 * i + 1]) * .5f,
                    (lo[3 * i + 2] + hi[3 * i + 2]) * .5f);
  }
  b->perm.resize(n_prims);
  b->nodes.reserve(2 * n_prims);
  std::vector<int> ids(n_prims);
  for (int i = 0; i < n_prims; i++) ids[i] = i;
  b->build(ids.data(), n_prims, 0);
  *out_n_nodes = (int)b->nodes.size();
  return b;
}

// Pass 2: emit the 8 octant tables (8*N*8 f32) + permutation, free handle.
void bvh_emit(void *handle, float *nodes_out, int *perm_out) {
  auto *b = static_cast<Builder *>(handle);
  int n = (int)b->nodes.size();
  for (int o = 0; o < 8; o++) {
    emit_octant(b->nodes, o, nodes_out + (size_t)o * n * 8);
  }
  std::memcpy(perm_out, b->perm.data(), b->n * sizeof(int));
  delete b;
}

// Cluster-BVH support (tpu_pt/bvh/cluster.py): emit leaves (= clusters)
// instead of octant tables.  Leaves appear in DFS pre-order — spatially
// coherent, which the implicit 8-ary pyramid's consecutive-8 grouping
// relies on.  Does NOT free the handle (call bvh_emit_leaves once).
int bvh_count_leaves(void *handle) {
  auto *b = static_cast<Builder *>(handle);
  int c = 0;
  for (const Node &nd : b->nodes)
    if (nd.left < 0) c++;
  return c;
}

void bvh_emit_leaves(void *handle, float *leaf_lo /* L x 3 */,
                     float *leaf_hi /* L x 3 */, int *leaf_start,
                     int *leaf_count, int *perm_out) {
  auto *b = static_cast<Builder *>(handle);
  int li = 0;
  for (const Node &nd : b->nodes) {
    if (nd.left >= 0) continue;
    leaf_lo[3 * li] = nd.bb.lo.x;
    leaf_lo[3 * li + 1] = nd.bb.lo.y;
    leaf_lo[3 * li + 2] = nd.bb.lo.z;
    leaf_hi[3 * li] = nd.bb.hi.x;
    leaf_hi[3 * li + 1] = nd.bb.hi.y;
    leaf_hi[3 * li + 2] = nd.bb.hi.z;
    leaf_start[li] = nd.start;
    leaf_count[li] = nd.count;
    li++;
  }
  std::memcpy(perm_out, b->perm.data(), b->n * sizeof(int));
  delete b;
}

}  // extern "C"
