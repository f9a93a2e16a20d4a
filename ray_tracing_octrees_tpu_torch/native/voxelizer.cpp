// Native ingest runtime: CSV parsing, OpenMP triangle voxelization, and
// binary grid cache IO, exposed through a plain C ABI for ctypes.
//
// The PyTorch port's own copy of the reference package's native runtime:
// the CSV loaders of BuildingLoader.cpp:10-129, the OpenMP voxelizer of
// BuildingLoader.cpp:231-287 and the cache serializer of CacheUtils.cpp.
// ray_tracing_octrees_tpu_torch/native/runtime.py builds it with
// -ffp-contract=off, so every operation rounds alone, as the port's dense
// voxelizer (ingest/voxelize.py) rounds it on the card.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// Projected barycentric point-in-triangle (isPointInTriangle semantics).
static inline bool point_in_triangle(const float p[3], const float a[3],
                                     const float b[3], const float c[3]) {
  float v0[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
  float v1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
  float v2[3] = {p[0] - a[0], p[1] - a[1], p[2] - a[2]};
  float dot00 = v0[0] * v0[0] + v0[1] * v0[1] + v0[2] * v0[2];
  float dot01 = v0[0] * v1[0] + v0[1] * v1[1] + v0[2] * v1[2];
  float dot02 = v0[0] * v2[0] + v0[1] * v2[1] + v0[2] * v2[2];
  float dot11 = v1[0] * v1[0] + v1[1] * v1[1] + v1[2] * v1[2];
  float dot12 = v1[0] * v2[0] + v1[1] * v2[1] + v1[2] * v2[2];
  float denom = dot00 * dot11 - dot01 * dot01;
  if (std::fabs(denom) < 1e-7f) return false;
  // u and v in double from the f32 numerators, as the reference package's
  // numpy voxelizer rounds them (its guard term is a float64 array): a
  // voxel centre on a face's diagonal then lands on the same side
  double inv = 1.0 / (double)denom;
  double u = (double)(dot11 * dot02 - dot01 * dot12) * inv;
  double v = (double)(dot00 * dot12 - dot01 * dot02) * inv;
  return u >= 0.0 && v >= 0.0 && (u + v) <= 1.0;
}

// Fill `occ` (dimZ*dimY*dimX, x-major) from triangles [n_tris][3][3] float32.
// Returns the number of marked voxel writes (>= filled voxels).
long long voxelize_tris(const float* tris, long long n_tris,
                        const float min_x, const float min_y, const float min_z,
                        const float voxel_size,
                        const int dim_x, const int dim_y, const int dim_z,
                        uint8_t* occ) {
  std::atomic<long long> filled(0);
#pragma omp parallel for schedule(dynamic)
  for (long long i = 0; i < n_tris; ++i) {
    const float* t = tris + i * 9;
    const float* v1 = t;
    const float* v2 = t + 3;
    const float* v3 = t + 6;
    float tmin[3], tmax[3];
    for (int k = 0; k < 3; ++k) {
      tmin[k] = std::min(std::min(v1[k], v2[k]), v3[k]);
      tmax[k] = std::max(std::max(v1[k], v2[k]), v3[k]);
    }
    const float gmin[3] = {min_x, min_y, min_z};
    const int dims[3] = {dim_x, dim_y, dim_z};
    int s[3], e[3];
    for (int k = 0; k < 3; ++k) {
      s[k] = std::max(0, (int)((tmin[k] - gmin[k]) / voxel_size));
      e[k] = std::min(dims[k] - 1, (int)((tmax[k] - gmin[k]) / voxel_size) + 1);
    }
    if (e[0] < s[0] || e[1] < s[1] || e[2] < s[2]) continue;
    long long local = 0;
    for (int z = s[2]; z <= e[2]; ++z) {
      for (int y = s[1]; y <= e[1]; ++y) {
        for (int x = s[0]; x <= e[0]; ++x) {
          float center[3] = {
              min_x + (x + 0.5f) * voxel_size,
              min_y + (y + 0.5f) * voxel_size,
              min_z + (z + 0.5f) * voxel_size,
          };
          if (point_in_triangle(center, v1, v2, v3)) {
            size_t idx = (size_t)x + (size_t)y * dim_x +
                         (size_t)z * dim_x * dim_y;
#pragma omp atomic write
            occ[idx] = 1;
            ++local;
          }
        }
      }
    }
    filled += local;
  }
  return filled.load();
}

// Binary grid cache (CacheUtils.cpp format): header 3xint32 + 4xfloat32 +
// uint64 count, then count bytes.
int save_voxel_grid(const char* path, int dim_x, int dim_y, int dim_z,
                    float min_x, float min_y, float min_z, float voxel_size,
                    const uint8_t* data) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 0;
  uint64_t count = (uint64_t)dim_x * dim_y * dim_z;
  std::fwrite(&dim_x, 4, 1, f);
  std::fwrite(&dim_y, 4, 1, f);
  std::fwrite(&dim_z, 4, 1, f);
  std::fwrite(&min_x, 4, 1, f);
  std::fwrite(&min_y, 4, 1, f);
  std::fwrite(&min_z, 4, 1, f);
  std::fwrite(&voxel_size, 4, 1, f);
  std::fwrite(&count, 8, 1, f);
  std::fwrite(data, 1, count, f);
  std::fclose(f);
  return 1;
}

// Reads the header; returns 1 on success.
int read_grid_header(const char* path, int* dims, float* mins,
                     float* voxel_size, uint64_t* count) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 0;
  int ok = std::fread(dims, 4, 3, f) == 3 && std::fread(mins, 4, 3, f) == 3 &&
           std::fread(voxel_size, 4, 1, f) == 1 && std::fread(count, 8, 1, f) == 1;
  std::fclose(f);
  return ok ? 1 : 0;
}

// Loads a Z-slab [start_layer, start_layer + num_layers) into `out`
// (CacheUtils.cpp:60-111 semantics). num_layers == dimZ loads everything.
int load_voxel_grid_slab(const char* path, int start_layer, int num_layers,
                         uint8_t* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 0;
  int dims[3];
  float mins[3], vs;
  uint64_t count;
  if (std::fread(dims, 4, 3, f) != 3 || std::fread(mins, 4, 3, f) != 3 ||
      std::fread(&vs, 4, 1, f) != 1 || std::fread(&count, 8, 1, f) != 1) {
    std::fclose(f);
    return 0;
  }
  if (start_layer < 0 || start_layer >= dims[2] ||
      start_layer + num_layers > dims[2]) {
    std::fclose(f);
    return 0;
  }
  size_t layer = (size_t)dims[0] * dims[1];
  std::fseek(f, (long)(start_layer * layer), SEEK_CUR);
  size_t want = layer * num_layers;
  size_t got = std::fread(out, 1, want, f);
  std::fclose(f);
  return got == want ? 1 : 0;
}

// --------------------------------------------------------------------------
// CSV ingest (loadCSVVertices / loadCSVFaces, BuildingLoader.cpp:10-129):
// skip the header line, trim tokens, require >= min_tokens per row, parse
// the first n_numeric tokens as doubles, recover per line on malformed
// numbers — same tolerant semantics as ingest/csv_loader.py.
// Two-call protocol: out == nullptr counts rows; second call fills
// out[rows * n_numeric]. Returns the row count, or -1 on IO error.
long long parse_csv(const char* path, int min_tokens, int n_numeric,
                    double* out, long long cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::string line;
  line.reserve(512);
  long long rows = 0;
  bool header = true;
  std::vector<double> vals((size_t)n_numeric);
  int c;
  bool eof = false;
  while (!eof) {
    line.clear();
    for (;;) {
      c = std::fgetc(f);
      if (c == EOF) { eof = true; break; }
      if (c == '\n') break;
      line.push_back((char)c);
    }
    if (header) { header = false; continue; }
    // strip
    size_t b = line.find_first_not_of(" \t\r\n");
    if (b == std::string::npos) continue;
    size_t e = line.find_last_not_of(" \t\r\n");
    line = line.substr(b, e - b + 1);
    if (line.empty()) continue;
    // split on ',', trim tokens
    int n_tokens = 0;
    bool ok = true;
    size_t pos = 0;
    int filled = 0;
    while (pos <= line.size()) {
      size_t comma = line.find(',', pos);
      size_t end = (comma == std::string::npos) ? line.size() : comma;
      size_t tb = pos;
      while (tb < end && (line[tb] == ' ' || line[tb] == '\t')) ++tb;
      size_t te = end;
      while (te > tb && (line[te - 1] == ' ' || line[te - 1] == '\t')) --te;
      if (filled < n_numeric) {
        if (tb == te) { ok = false; }
        else {
          std::string tok = line.substr(tb, te - tb);
          // strtod accepts hex floats; Python's float() does not
          if (tok.find('x') != std::string::npos ||
              tok.find('X') != std::string::npos) { ok = false; }
          else {
            char* endp = nullptr;
            double v = std::strtod(tok.c_str(), &endp);
            if (endp != tok.c_str() + tok.size()) ok = false;
            else vals[(size_t)filled] = v;
          }
        }
        ++filled;
      }
      ++n_tokens;
      if (comma == std::string::npos) break;
      pos = comma + 1;
    }
    if (n_tokens < min_tokens || filled < n_numeric || !ok) continue;
    if (out) {
      if (rows >= cap) break;
      std::memcpy(out + rows * n_numeric, vals.data(),
                  sizeof(double) * n_numeric);
    }
    ++rows;
  }
  std::fclose(f);
  return rows;
}

// Face assembly (BuildingLoader.cpp:236-245): resolve (mesh#, vertex#)
// references through a hash map, drop faces with missing vertices. verts
// are the 8-column rows (mesh#, vertex#, easting, northing, elevation, ...),
// faces the 4-column rows. tri_out (may be null) holds float32[K, 3, 3];
// kept (may be null) flags each face. Returns K.
long long assemble_triangles(const double* verts, long long n_verts,
                             const double* faces, long long n_faces,
                             float* tri_out, uint8_t* kept) {
  std::unordered_map<long long, long long> key;
  key.reserve((size_t)n_verts * 2);
  for (long long i = 0; i < n_verts; ++i) {
    long long m = (long long)verts[i * 8 + 0];
    long long v = (long long)verts[i * 8 + 1];
    key[(m << 32) ^ (v & 0xffffffffLL)] = i;  // later rows win, as dict
  }
  long long k = 0;
  for (long long j = 0; j < n_faces; ++j) {
    long long m = (long long)faces[j * 4 + 0];
    long long ids[3];
    bool ok = true;
    for (int t = 0; t < 3; ++t) {
      long long v = (long long)faces[j * 4 + 1 + t];
      auto it = key.find((m << 32) ^ (v & 0xffffffffLL));
      if (it == key.end()) { ok = false; break; }
      ids[t] = it->second;
    }
    if (kept) kept[j] = ok ? 1 : 0;
    if (!ok) continue;
    if (tri_out) {
      for (int t = 0; t < 3; ++t)
        for (int cmp = 0; cmp < 3; ++cmp)
          tri_out[(k * 3 + t) * 3 + cmp] =
              (float)verts[ids[t] * 8 + 2 + cmp];
    }
    ++k;
  }
  return k;
}

}  // extern "C"
