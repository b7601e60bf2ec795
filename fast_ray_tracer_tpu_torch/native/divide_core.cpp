// Native host runtime: BVH-divide simulation -> shadow-walk leaf ranks.
//
// The reference's BVH build is native C (group_divide,
// src/shapes/group.c:299-370); its child ordering determines the
// early-exit shadow walk the renderer must replicate
// (scene/divide.py docstring). This is the port's copy of the JAX
// package's native/divide_core.cpp, a line-for-line port of
// scene/divide.py's simulation into C++ for large meshes (the Python walk
// takes seconds for tens of thousands of triangles). Semantics must match
// the Python walk bit-for-bit: IEEE double arithmetic with the same
// operation order (build with -ffp-contract=off), NaN-ignoring fmax,
// `equal` with EPSILON 1e-5, NaN containment false.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double EPS = 1e-5;
const double INF = INFINITY;

inline bool feq(double a, double b) {
  double d = a - b;
  if (d != d) return false;  // NaN
  return std::fabs(d) < EPS;
}

inline double fmax_c(double a, double b) {
  if (a != a) return b;
  if (b != b) return a;
  return a > b ? a : b;
}

struct Box {
  double mn[3] = {INF, INF, INF};
  double mx[3] = {-INF, -INF, -INF};

  void add_array(const double p[3]) {
    for (int i = 0; i < 3; ++i) {
      if (p[i] < mn[i]) mn[i] = p[i];
      if (p[i] > mx[i]) mx[i] = p[i];
    }
  }
  void add_box(const Box &o) {
    add_array(o.mn);
    add_array(o.mx);
  }
  bool contains_array(const double p[3]) const {
    return mn[0] <= p[0] && p[0] <= mx[0] && mn[1] <= p[1] &&
           p[1] <= mx[1] && mn[2] <= p[2] && p[2] <= mx[2];
  }
  bool contains_box(const Box &o) const {
    return contains_array(o.mn) && contains_array(o.mx);
  }
  Box transform(const double *m) const {
    Box res;
    const double cs[8][3] = {
        {mn[0], mn[1], mn[2]}, {mn[0], mn[1], mx[2]}, {mn[0], mx[1], mn[2]},
        {mn[0], mx[1], mx[2]}, {mx[0], mn[1], mn[2]}, {mx[0], mn[1], mx[2]},
        {mx[0], mx[1], mn[2]}, {mx[0], mx[1], mx[2]}};
    for (const auto &c : cs) {
      double p[3];
      for (int r = 0; r < 3; ++r)
        p[r] = m[r * 4 + 0] * c[0] + m[r * 4 + 1] * c[1] +
               m[r * 4 + 2] * c[2] + m[r * 4 + 3];
      res.add_array(p);
    }
    return res;
  }
  void split(Box &left, Box &right) const {
    double dx = std::fabs(mx[0] - mn[0]);
    double dy = std::fabs(mx[1] - mn[1]);
    double dz = std::fabs(mx[2] - mn[2]);
    double greatest = fmax_c(fmax_c(dx, dy), dz);
    double x0 = mn[0], y0 = mn[1], z0 = mn[2];
    double x1 = mx[0], y1 = mx[1], z1 = mx[2];
    if (feq(greatest, dx)) {
      x0 = x1 = x0 + dx / 2.0;
    } else if (feq(greatest, dy)) {
      y0 = y1 = y0 + dy / 2.0;
    } else {
      z0 = z1 = z0 + dz / 2.0;
    }
    left.mn[0] = mn[0]; left.mn[1] = mn[1]; left.mn[2] = mn[2];
    left.mx[0] = x1; left.mx[1] = y1; left.mx[2] = z1;
    right.mn[0] = x0; right.mn[1] = y0; right.mn[2] = z0;
    right.mx[0] = mx[0]; right.mx[1] = mx[1]; right.mx[2] = mx[2];
  }
};

// kinds match the Python serializer (native/__init__.py: shadow_ranks)
enum Kind : int8_t { KGROUP = 0, KCSG = 1, KLEAF = 2 };

struct NodeC {
  int8_t kind;
  double tf[16];
  int32_t leaf_id;
  Box obj_box;
  std::vector<int32_t> ch;  // group children / csg {left, right}
  Box bbox, bbox_inv;
  bool valid = false;
};

struct Forest {
  std::vector<NodeC> nodes;

  const Box &bounds(int32_t ni) {
    NodeC &n = nodes[ni];
    if (!n.valid) {
      Box b;
      if (n.kind == KGROUP || n.kind == KCSG) {
        for (int32_t c : n.ch) b.add_box(parent_space_bounds(c));
      } else {
        b = n.obj_box;
      }
      n.bbox = b;
      n.bbox_inv = b.transform(n.tf);
      n.valid = true;
    }
    return n.bbox;
  }
  const Box &parent_space_bounds(int32_t ni) {
    bounds(ni);
    return nodes[ni].bbox_inv;
  }

  // partition_children (group.c:183-297) — exact swap passes
  void partition(int32_t ni, int32_t &left_count, int32_t &middle_count,
                 int32_t &right_count, int32_t &left_start,
                 int32_t &middle_start, int32_t &right_start) {
    Box box = bounds(ni);
    Box left_box, right_box;
    box.split(left_box, right_box);
    std::vector<int32_t> &ch = nodes[ni].ch;
    const int32_t n = static_cast<int32_t>(ch.size());
    std::vector<uint8_t> lm(n, 0), rm(n, 0);
    left_count = middle_count = right_count = 0;
    for (int32_t i = 0; i < n; ++i) {
      const Box &cb = parent_space_bounds(ch[i]);
      if (left_box.contains_box(cb)) {
        lm[i] = 1;
        ++left_count;
      } else if (right_box.contains_box(cb)) {
        rm[i] = 1;
        ++right_count;
      } else {
        ++middle_count;
      }
    }
    left_start = middle_start = right_start = -1;
    int32_t i = 0, j = 0;
    while (i < n && j < n) {
      if (lm[i]) {
        if (left_start < 0) left_start = i;
        ++i;
        ++j;
      } else {
        while (j < n && !lm[j]) ++j;
        if (j < n) {
          std::swap(ch[i], ch[j]);
          std::swap(lm[i], lm[j]);
          std::swap(rm[i], rm[j]);
        }
      }
    }
    j = i;
    while (i < n && j < n) {
      if (!rm[i]) {
        if (middle_start < 0) middle_start = i;
        ++i;
        ++j;
      } else {
        while (j < n && rm[j]) ++j;
        if (j < n) {
          std::swap(ch[i], ch[j]);
          std::swap(lm[i], lm[j]);
          std::swap(rm[i], rm[j]);
        }
      }
    }
    if (i < n) right_start = i;
  }

  void divide(int32_t ni, int64_t threshold) {
    if (nodes[ni].kind == KCSG) {
      divide(nodes[ni].ch[0], threshold);
      divide(nodes[ni].ch[1], threshold);
      return;
    }
    if (nodes[ni].kind != KGROUP) return;

    if (threshold < static_cast<int64_t>(nodes[ni].ch.size())) {
      int32_t lc, mc, rc, ls, ms, rs;
      partition(ni, lc, mc, rc, ls, ms, rs);
      if (mc != static_cast<int32_t>(nodes[ni].ch.size())) {
        std::vector<int32_t> nc;
        if (lc > 0) {
          NodeC sub;
          sub.kind = KGROUP;
          static const double ident[16] = {1, 0, 0, 0, 0, 1, 0, 0,
                                           0, 0, 1, 0, 0, 0, 0, 1};
          std::memcpy(sub.tf, ident, sizeof(ident));
          sub.leaf_id = -1;
          sub.ch.assign(nodes[ni].ch.begin() + ls,
                        nodes[ni].ch.begin() + ls + lc);
          nodes.push_back(std::move(sub));
          nc.push_back(static_cast<int32_t>(nodes.size() - 1));
        }
        if (rc > 0) {
          NodeC sub;
          sub.kind = KGROUP;
          static const double ident[16] = {1, 0, 0, 0, 0, 1, 0, 0,
                                           0, 0, 1, 0, 0, 0, 0, 1};
          std::memcpy(sub.tf, ident, sizeof(ident));
          sub.leaf_id = -1;
          sub.ch.assign(nodes[ni].ch.begin() + rs,
                        nodes[ni].ch.begin() + rs + rc);
          nodes.push_back(std::move(sub));
          nc.push_back(static_cast<int32_t>(nodes.size() - 1));
        }
        if (mc > 0)
          nc.insert(nc.end(), nodes[ni].ch.begin() + ms,
                    nodes[ni].ch.begin() + ms + mc);
        nodes[ni].ch = std::move(nc);
        nodes[ni].valid = false;
      }
    }
    // iterate by index: divide() may reallocate `nodes`
    for (size_t k = 0; k < nodes[ni].ch.size(); ++k)
      divide(nodes[ni].ch[k], threshold);
  }

  void collect(int32_t ni, std::vector<int32_t> &out) {
    if (nodes[ni].kind == KGROUP) {
      for (size_t k = 0; k < nodes[ni].ch.size(); ++k)
        collect(nodes[ni].ch[k], out);
    } else {
      out.push_back(nodes[ni].leaf_id);
    }
  }
};

}  // namespace

extern "C" {

// Returns 0 on success, -1 if the collected leaf ids are not a
// permutation of [0, n_leaves).
int64_t frt_shadow_ranks(int64_t n_nodes, int64_t root,
                         const int8_t *kind,
                         const double *transform, const int32_t *leaf_id,
                         const double *obj_box, const int32_t *n_children,
                         const int32_t *child_idx, int64_t threshold,
                         int64_t n_leaves, int32_t *out_rank) {
  Forest f;
  f.nodes.resize(n_nodes);
  int64_t off = 0;
  for (int64_t i = 0; i < n_nodes; ++i) {
    NodeC &n = f.nodes[i];
    n.kind = kind[i];
    std::memcpy(n.tf, transform + i * 16, 16 * sizeof(double));
    n.leaf_id = leaf_id[i];
    for (int k = 0; k < 3; ++k) {
      n.obj_box.mn[k] = obj_box[i * 6 + k];
      n.obj_box.mx[k] = obj_box[i * 6 + 3 + k];
    }
    n.ch.assign(child_idx + off, child_idx + off + n_children[i]);
    off += n_children[i];
  }
  f.divide(static_cast<int32_t>(root), threshold);
  std::vector<int32_t> order;
  order.reserve(n_leaves);
  f.collect(static_cast<int32_t>(root), order);
  if (static_cast<int64_t>(order.size()) != n_leaves) return -1;
  std::vector<uint8_t> seen(n_leaves, 0);
  for (int64_t pos = 0; pos < n_leaves; ++pos) {
    int32_t lid = order[pos];
    if (lid < 0 || lid >= n_leaves || seen[lid]) return -1;
    seen[lid] = 1;
    out_rank[lid] = static_cast<int32_t>(pos);
  }
  return 0;
}

}  // extern "C"
