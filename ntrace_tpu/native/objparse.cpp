// Fast Wavefront OBJ geometry parser (native path of ntrace_tpu.io.obj).
//
// Capability parity: the reference's OBJ importer is native C++
// (~ framework/io/MeshWavefrontIO.cpp, expected path; mount empty -- see
// SURVEY.md SS0) because the 10M-triangle San Miguel scene is impractical
// to parse in a scripting language. This is a from-scratch two-pass
// scanner: pass 1 counts records, pass 2 fills preallocated arrays.
// Python (ctypes) reads the filled buffers zero-copy into numpy and frees
// them via obj_free. Material resolution (mtllib/Kd/Ks/Ke) stays in
// Python; this parser records usemtl switches as per-face material ids
// plus the name table.
//
// Supported: v, vn, vt, f with v / v/vt / v//vn / v/vt/vn forms,
// arbitrary polygon fan triangulation, negative (relative) indices,
// usemtl/mtllib, comments, \r\n. Unknown keywords are skipped. Per-corner
// vt indices are recorded (-1 where a corner has none) so textured OBJs
// keep the native speed win (texture parity).
//
// Build: g++ -O3 -shared -fPIC objparse.cpp -o libobjparse.so (driven by
// ntrace_tpu/native/build.py, cached by source hash).

#include <climits>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <vector>
#include <string>

namespace {

struct Buf {
  const char* p;
  const char* end;
};

inline void skip_ws(Buf& b) {
  while (b.p < b.end && (*b.p == ' ' || *b.p == '\t')) ++b.p;
}

inline void skip_line(Buf& b) {
  while (b.p < b.end && *b.p != '\n') ++b.p;
  if (b.p < b.end) ++b.p;
}

// Fast float parse: common OBJ numbers are plain decimals; falls back to
// strtod for exponents/specials.
inline float parse_float(Buf& b) {
  skip_ws(b);
  const char* s = b.p;
  bool neg = false;
  if (b.p < b.end && (*b.p == '-' || *b.p == '+')) {
    neg = (*b.p == '-');
    ++b.p;
  }
  double v = 0.0;
  bool any = false;
  while (b.p < b.end && *b.p >= '0' && *b.p <= '9') {
    v = v * 10.0 + (*b.p - '0');
    ++b.p;
    any = true;
  }
  if (b.p < b.end && *b.p == '.') {
    ++b.p;
    double scale = 0.1;
    while (b.p < b.end && *b.p >= '0' && *b.p <= '9') {
      v += (*b.p - '0') * scale;
      scale *= 0.1;
      ++b.p;
      any = true;
    }
  }
  if (b.p < b.end && (*b.p == 'e' || *b.p == 'E')) {
    char* endp = nullptr;
    double full = strtod(s, &endp);
    b.p = endp;
    return static_cast<float>(full);
  }
  if (!any) return 0.0f;
  return static_cast<float>(neg ? -v : v);
}

inline long parse_int(Buf& b) {
  bool neg = false;
  if (b.p < b.end && (*b.p == '-' || *b.p == '+')) {
    neg = (*b.p == '-');
    ++b.p;
  }
  long v = 0;
  while (b.p < b.end && *b.p >= '0' && *b.p <= '9') {
    v = v * 10 + (*b.p - '0');
    ++b.p;
  }
  return neg ? -v : v;
}

}  // namespace

extern "C" {

struct ObjData {
  float* positions;     // 3 * n_pos
  int64_t n_pos;
  float* normals;       // 3 * n_norm
  int64_t n_norm;
  int32_t* faces;       // 3 * n_tris (position indices, triangulated)
  int32_t* face_mat;    // n_tris
  int64_t n_tris;
  char* mat_names;      // '\n'-joined material names in first-use order
  int64_t mat_names_len;
  char* error;          // non-null on failure
  float* texcoords;     // 2 * n_vt
  int64_t n_vt;
  int32_t* face_vt;     // 3 * n_tris per-corner vt index, -1 if absent
};

void obj_free(ObjData* d) {
  if (!d) return;
  free(d->positions);
  free(d->normals);
  free(d->faces);
  free(d->face_mat);
  free(d->mat_names);
  free(d->error);
  free(d->texcoords);
  free(d->face_vt);
  free(d);
}

ObjData* obj_parse(const char* path) {
  ObjData* out = static_cast<ObjData*>(calloc(1, sizeof(ObjData)));
  FILE* f = fopen(path, "rb");
  if (!f) {
    out->error = strdup("cannot open file");
    return out;
  }
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* data = static_cast<char*>(malloc(size + 1));
  if (!data || fread(data, 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    free(data);
    out->error = strdup("read failed");
    return out;
  }
  fclose(f);
  data[size] = '\n';

  // Pass 1: count records (faces counted as fan triangles).
  int64_t n_v = 0, n_vn = 0, n_vt = 0, n_tri = 0;
  {
    Buf b{data, data + size};
    while (b.p < b.end) {
      if (b.p[0] == 'v') {
        if (b.p + 1 < b.end && b.p[1] == ' ') ++n_v;
        else if (b.p + 2 < b.end && b.p[1] == 'n' && b.p[2] == ' ') ++n_vn;
        else if (b.p + 2 < b.end && b.p[1] == 't' && b.p[2] == ' ') ++n_vt;
      } else if (b.p[0] == 'f' && b.p + 1 < b.end && b.p[1] == ' ') {
        // count vertices on the face line
        Buf l = b;
        l.p += 1;
        int verts = 0;
        while (l.p < l.end && *l.p != '\n') {
          skip_ws(l);
          if (l.p < l.end && (*l.p == '-' || (*l.p >= '0' && *l.p <= '9'))) {
            ++verts;
            while (l.p < l.end && *l.p != ' ' && *l.p != '\t' && *l.p != '\n'
                   && *l.p != '\r') ++l.p;
          } else if (l.p < l.end && *l.p != '\n') {
            ++l.p;
          }
        }
        if (verts >= 3) n_tri += verts - 2;
      }
      skip_line(b);
    }
  }

  out->positions = static_cast<float*>(malloc(sizeof(float) * 3 * (n_v ? n_v : 1)));
  out->normals = static_cast<float*>(malloc(sizeof(float) * 3 * (n_vn ? n_vn : 1)));
  out->faces = static_cast<int32_t*>(malloc(sizeof(int32_t) * 3 * (n_tri ? n_tri : 1)));
  out->face_mat = static_cast<int32_t*>(malloc(sizeof(int32_t) * (n_tri ? n_tri : 1)));
  out->texcoords = static_cast<float*>(malloc(sizeof(float) * 2 * (n_vt ? n_vt : 1)));
  out->face_vt = static_cast<int32_t*>(malloc(sizeof(int32_t) * 3 * (n_tri ? n_tri : 1)));
  if (!out->positions || !out->normals || !out->faces || !out->face_mat ||
      !out->texcoords || !out->face_vt) {
    free(data);
    out->error = strdup("out of memory");
    return out;
  }

  std::vector<std::string> mat_names;
  std::string mat_blob;
  int cur_mat = 0;
  mat_names.push_back("default");

  // Pass 2: fill.
  int64_t iv = 0, ivn = 0, ivt = 0, it = 0;
  std::vector<long> face_idx;
  std::vector<long> face_vti;
  face_idx.reserve(16);
  face_vti.reserve(16);
  Buf b{data, data + size};
  while (b.p < b.end) {
    if (b.p[0] == 'v' && b.p + 1 < b.end && b.p[1] == ' ') {
      b.p += 2;
      out->positions[3 * iv + 0] = parse_float(b);
      out->positions[3 * iv + 1] = parse_float(b);
      out->positions[3 * iv + 2] = parse_float(b);
      ++iv;
    } else if (b.p[0] == 'v' && b.p + 2 < b.end && b.p[1] == 'n' && b.p[2] == ' ') {
      b.p += 3;
      out->normals[3 * ivn + 0] = parse_float(b);
      out->normals[3 * ivn + 1] = parse_float(b);
      out->normals[3 * ivn + 2] = parse_float(b);
      ++ivn;
    } else if (b.p[0] == 'v' && b.p + 2 < b.end && b.p[1] == 't' && b.p[2] == ' ') {
      b.p += 3;
      out->texcoords[2 * ivt + 0] = parse_float(b);
      out->texcoords[2 * ivt + 1] = parse_float(b);
      ++ivt;
    } else if (b.p[0] == 'f' && b.p + 1 < b.end && b.p[1] == ' ') {
      b.p += 2;
      face_idx.clear();
      face_vti.clear();
      while (b.p < b.end && *b.p != '\n' && *b.p != '\r') {
        skip_ws(b);
        if (b.p >= b.end ||
            !(*b.p == '-' || (*b.p >= '0' && *b.p <= '9'))) break;
        long idx = parse_int(b);
        long vti = LONG_MIN;  // absent
        if (b.p < b.end && *b.p == '/') {
          ++b.p;  // v/vt, v//vn, v/vt/vn
          if (b.p < b.end && (*b.p == '-' || (*b.p >= '0' && *b.p <= '9')))
            vti = parse_int(b);
        }
        // skip /vn tail (or any residue)
        while (b.p < b.end && *b.p != ' ' && *b.p != '\t' && *b.p != '\n'
               && *b.p != '\r') ++b.p;
        face_idx.push_back(idx > 0 ? idx - 1 : iv + idx);
        face_vti.push_back(vti == LONG_MIN ? -1
                           : (vti > 0 ? vti - 1 : ivt + vti));
      }
      for (size_t k = 1; k + 1 < face_idx.size(); ++k) {
        out->faces[3 * it + 0] = static_cast<int32_t>(face_idx[0]);
        out->faces[3 * it + 1] = static_cast<int32_t>(face_idx[k]);
        out->faces[3 * it + 2] = static_cast<int32_t>(face_idx[k + 1]);
        out->face_vt[3 * it + 0] = static_cast<int32_t>(face_vti[0]);
        out->face_vt[3 * it + 1] = static_cast<int32_t>(face_vti[k]);
        out->face_vt[3 * it + 2] = static_cast<int32_t>(face_vti[k + 1]);
        out->face_mat[it] = cur_mat;
        ++it;
      }
    } else if (!strncmp(b.p, "usemtl", 6)) {
      b.p += 6;
      skip_ws(b);
      const char* s = b.p;
      while (b.p < b.end && *b.p != '\n' && *b.p != '\r') ++b.p;
      std::string name(s, b.p - s);
      int found = -1;
      for (size_t i = 0; i < mat_names.size(); ++i)
        if (mat_names[i] == name) { found = static_cast<int>(i); break; }
      if (found < 0) {
        mat_names.push_back(name);
        found = static_cast<int>(mat_names.size()) - 1;
      }
      cur_mat = found;
    }
    skip_line(b);
  }
  free(data);

  out->n_pos = iv;
  out->n_norm = ivn;
  out->n_vt = ivt;
  out->n_tris = it;
  for (size_t i = 0; i < mat_names.size(); ++i) {
    if (i) mat_blob += '\n';
    mat_blob += mat_names[i];
  }
  out->mat_names = strdup(mat_blob.c_str());
  out->mat_names_len = static_cast<int64_t>(mat_blob.size());
  return out;
}

}  // extern "C"
