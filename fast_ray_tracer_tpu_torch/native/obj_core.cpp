// Native host runtime: Wavefront OBJ geometry core.
//
// The reference's data loader is native C (src/libs/obj_loader/
// obj_loader.c): a line scanner that fan-triangulates faces into
// triangle records. This is the port's copy of the JAX package's
// native/obj_core.cpp — the hot text-parsing and triangle-assembly loops
// in C++, exposed through a small C ABI consumed via ctypes
// (fast_ray_tracer_tpu_torch/native/__init__.py).
// Policy (MTL semantics, material resolution, transforms into world
// space) stays in Python: the parser returns raw indices plus an ordered
// mtllib/usemtl event stream the Python side replays, so behavior is
// identical to the pure-Python scanner (scene/obj_loader.py).
//
// Line semantics mirror scene/obj_loader.py exactly (which mirrors
// obj_loader.c:339-440): prefix match at column 0 for
// "v ", "vt ", "vn ", "f ", "g ", "usemtl", "mtllib"; faces with <3
// vertex tokens are skipped; the FIRST vertex token of a face decides
// use_n/use_t for all its fan triangles (obj_loader.c:237-259).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ObjData {
  std::vector<double> v;    // 3 per vertex
  std::vector<double> vt;   // 3 per texcoord (z = 0 when absent)
  std::vector<double> vn;   // 3 per normal
  // per fan-triangle: v0,t0,n0,v1,t1,n1,v2,t2,n2 (1-based, 0 = absent)
  std::vector<int32_t> tri;
  std::vector<int32_t> tri_flags;  // use_n, use_t per triangle
  std::vector<int32_t> tri_group;  // group index (0 = default group)
  std::vector<int32_t> tri_event;  // #events seen when the tri was emitted
  std::string group_names;         // '\n'-joined, first-use order
  std::string events;              // '\n'-joined "m <file>" / "u <name>"
  int32_t n_events = 0;
};

struct Tok {
  int32_t v = 0, t = 0, n = 0;
};

// "v", "v/t", "v//n", "v/t/n" -> (v, t, n), 0 = absent.
Tok parse_face_token(const char *s, const char *end) {
  Tok tok;
  char *next = nullptr;
  tok.v = static_cast<int32_t>(strtol(s, &next, 10));
  if (next >= end || *next != '/') return tok;
  const char *p = next + 1;
  if (p < end && *p != '/') tok.t = static_cast<int32_t>(strtol(p, &next, 10));
  else next = const_cast<char *>(p);
  if (next < end && *next == '/') {
    p = next + 1;
    if (p < end) tok.n = static_cast<int32_t>(strtol(p, &next, 10));
  }
  return tok;
}

inline bool starts_with(const char *line, const char *pfx) {
  return std::strncmp(line, pfx, std::strlen(pfx)) == 0;
}

}  // namespace

extern "C" {

void *frt_obj_load(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto *d = new ObjData();

  std::unordered_map<std::string, int32_t> group_ids;
  auto intern_group = [&](const std::string &name) -> int32_t {
    auto it = group_ids.find(name);
    if (it != group_ids.end()) return it->second;
    int32_t id = static_cast<int32_t>(group_ids.size());
    group_ids.emplace(name, id);
    if (id > 0) d->group_names += '\n';
    d->group_names += name;
    return id;
  };
  int32_t current_group = intern_group("##default_group");

  std::vector<Tok> face;   // reused per face line
  char *line = nullptr;
  size_t cap = 0;
  ssize_t len;
  while ((len = getline(&line, &cap, f)) != -1) {
    if (starts_with(line, "v ")) {
      double x = 0, y = 0, z = 0;
      std::sscanf(line + 2, "%lf %lf %lf", &x, &y, &z);
      d->v.push_back(x); d->v.push_back(y); d->v.push_back(z);
    } else if (starts_with(line, "vt ")) {
      double x = 0, y = 0, z = 0;
      int n = std::sscanf(line + 3, "%lf %lf %lf", &x, &y, &z);
      if (n < 3) z = 0.0;
      d->vt.push_back(x); d->vt.push_back(y); d->vt.push_back(z);
    } else if (starts_with(line, "vn ")) {
      double x = 0, y = 0, z = 0;
      std::sscanf(line + 3, "%lf %lf %lf", &x, &y, &z);
      d->vn.push_back(x); d->vn.push_back(y); d->vn.push_back(z);
    } else if (starts_with(line, "f ")) {
      face.clear();
      const char *p = line + 2, *end = line + len;
      while (p < end) {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' ||
                           *p == '\n'))
          ++p;
        if (p >= end) break;
        const char *tok_end = p;
        while (tok_end < end && *tok_end != ' ' && *tok_end != '\t' &&
               *tok_end != '\r' && *tok_end != '\n')
          ++tok_end;
        face.push_back(parse_face_token(p, tok_end));
        p = tok_end;
      }
      if (face.size() < 3) continue;
      const bool use_n = face[0].n > 0;
      const bool use_t = face[0].t > 0;
      for (size_t i = 1; i + 1 < face.size(); ++i) {
        const Tok &a = face[0], &b = face[i], &c = face[i + 1];
        int32_t rec[9] = {a.v, a.t, a.n, b.v, b.t, b.n, c.v, c.t, c.n};
        d->tri.insert(d->tri.end(), rec, rec + 9);
        d->tri_flags.push_back(use_n ? 1 : 0);
        d->tri_flags.push_back(use_t ? 1 : 0);
        d->tri_group.push_back(current_group);
        d->tri_event.push_back(d->n_events);
      }
    } else if (starts_with(line, "g ")) {
      // name = second whitespace token, "" when absent
      const char *p = line + 2, *end = line + len;
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
      const char *e = p;
      while (e < end && *e != ' ' && *e != '\t' && *e != '\r' && *e != '\n')
        ++e;
      current_group = intern_group(std::string(p, e));
    } else if (starts_with(line, "usemtl")) {
      const char *p = line + 6, *end = line + len;
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
      const char *e = p;
      while (e < end && *e != ' ' && *e != '\t' && *e != '\r' && *e != '\n')
        ++e;
      if (!d->events.empty()) d->events += '\n';
      d->events += "u ";
      d->events.append(p, e);
      d->n_events++;
    } else if (starts_with(line, "mtllib")) {
      const char *p = line + 6, *end = line + len;
      while (p < end && (*p == ' ' || *p == '\t')) ++p;
      const char *e = p;
      while (e < end && *e != ' ' && *e != '\t' && *e != '\r' && *e != '\n')
        ++e;
      if (!d->events.empty()) d->events += '\n';
      d->events += "m ";
      d->events.append(p, e);
      d->n_events++;
    }
  }
  std::free(line);
  std::fclose(f);
  return d;
}

// counts: nv, nvt, nvn, ntri, group_names_bytes, events_bytes
void frt_obj_counts(void *h, int64_t *out) {
  auto *d = static_cast<ObjData *>(h);
  out[0] = static_cast<int64_t>(d->v.size() / 3);
  out[1] = static_cast<int64_t>(d->vt.size() / 3);
  out[2] = static_cast<int64_t>(d->vn.size() / 3);
  out[3] = static_cast<int64_t>(d->tri.size() / 9);
  out[4] = static_cast<int64_t>(d->group_names.size());
  out[5] = static_cast<int64_t>(d->events.size());
}

void frt_obj_fill(void *h, double *v, double *vt, double *vn, int32_t *tri,
                  int32_t *flags, int32_t *tgroup, int32_t *tevent,
                  char *group_names, char *events) {
  auto *d = static_cast<ObjData *>(h);
  std::memcpy(v, d->v.data(), d->v.size() * sizeof(double));
  std::memcpy(vt, d->vt.data(), d->vt.size() * sizeof(double));
  std::memcpy(vn, d->vn.data(), d->vn.size() * sizeof(double));
  std::memcpy(tri, d->tri.data(), d->tri.size() * sizeof(int32_t));
  std::memcpy(flags, d->tri_flags.data(),
              d->tri_flags.size() * sizeof(int32_t));
  std::memcpy(tgroup, d->tri_group.data(),
              d->tri_group.size() * sizeof(int32_t));
  std::memcpy(tevent, d->tri_event.data(),
              d->tri_event.size() * sizeof(int32_t));
  std::memcpy(group_names, d->group_names.data(), d->group_names.size());
  std::memcpy(events, d->events.data(), d->events.size());
}

void frt_obj_free(void *h) { delete static_cast<ObjData *>(h); }

}  // extern "C"
