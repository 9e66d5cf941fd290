// Native IO runtime for jax_bvh: fast OBJ mesh loading and PNG output.
//
// Plays the role of the reference's vendored tinyobjloader
// (the reference's src/tiny_obj_loader.h, used by MeshLoader::loadScene)
// and stb_image_write (PNG output) — re-implemented from scratch as a thin
// C ABI consumed from Python via ctypes (jax_bvh/utils/native.py). The JAX
// compute path never touches this; it is host-side IO only.
//
// Build: see native/Makefile (produces libtbvh_native.so).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------- OBJ load
// Parses v/f records (polygon faces fan-triangulated, negative indices
// supported, v/vt/vn index forms accepted). Returns a malloc'd flat
// [n_tris, 3 vertices, 3 coords] float array; caller frees via tbvh_free.
int tbvh_load_obj(const char* path, float** out_tris, int64_t* out_n) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(size);
  if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);

  std::vector<float> verts;  // xyz triples
  std::vector<float> tris;   // 9 floats per triangle
  std::vector<int64_t> face;

  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end) {
    // skip leading whitespace on the line
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) eol = end;
    if (p + 1 < eol && p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      char* q = const_cast<char*>(p) + 2;
      float x = std::strtof(q, &q);
      float y = std::strtof(q, &q);
      float z = std::strtof(q, &q);
      verts.push_back(x);
      verts.push_back(y);
      verts.push_back(z);
    } else if (p + 1 < eol && p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      face.clear();
      const char* q = p + 2;
      while (q < eol) {
        while (q < eol && (*q == ' ' || *q == '\t')) ++q;
        if (q >= eol || !(*q == '-' || std::isdigit(static_cast<unsigned char>(*q)))) break;
        char* r;
        long idx = std::strtol(q, &r, 10);
        q = r;
        // skip /vt/vn part of the token
        while (q < eol && *q != ' ' && *q != '\t') ++q;
        int64_t nverts = static_cast<int64_t>(verts.size() / 3);
        int64_t vi = idx > 0 ? idx - 1 : nverts + idx;
        if (vi < 0 || vi >= nverts) return -3;
        face.push_back(vi);
      }
      for (size_t k = 1; k + 1 < face.size(); ++k) {  // fan triangulation
        const int64_t ids[3] = {face[0], face[k], face[k + 1]};
        for (int64_t vi : ids) {
          tris.push_back(verts[vi * 3 + 0]);
          tris.push_back(verts[vi * 3 + 1]);
          tris.push_back(verts[vi * 3 + 2]);
        }
      }
    }
    p = eol + 1;
  }

  int64_t n = static_cast<int64_t>(tris.size() / 9);
  float* out = static_cast<float*>(std::malloc(tris.size() * sizeof(float)));
  if (!out && !tris.empty()) return -4;
  std::memcpy(out, tris.data(), tris.size() * sizeof(float));
  *out_tris = out;
  *out_n = n;
  return 0;
}

void tbvh_free(void* ptr) { std::free(ptr); }

// ---------------------------------------------------------------- PNG out
static void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

static void put_chunk(std::vector<uint8_t>& out, const char tag[4],
                      const uint8_t* data, size_t len) {
  put_be32(out, static_cast<uint32_t>(len));
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc =
      crc32(0, out.data() + start, static_cast<uInt>(out.size() - start));
  put_be32(out, crc);
}

// rgba: u8[h][w][4] row-major. Returns 0 on success.
int tbvh_write_png(const char* path, const uint8_t* rgba, int w, int h) {
  std::vector<uint8_t> raw;
  raw.reserve(static_cast<size_t>(h) * (1 + static_cast<size_t>(w) * 4));
  for (int r = 0; r < h; ++r) {
    raw.push_back(0);  // filter: none
    raw.insert(raw.end(), rgba + static_cast<size_t>(r) * w * 4,
               rgba + static_cast<size_t>(r + 1) * w * 4);
  }
  uLongf comp_cap = compressBound(raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), raw.size(), 6) != Z_OK)
    return -1;
  comp.resize(comp_cap);

  std::vector<uint8_t> out;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = w >> 24; ihdr[1] = (w >> 16) & 0xff; ihdr[2] = (w >> 8) & 0xff; ihdr[3] = w & 0xff;
  ihdr[4] = h >> 24; ihdr[5] = (h >> 16) & 0xff; ihdr[6] = (h >> 8) & 0xff; ihdr[7] = h & 0xff;
  ihdr[8] = 8;   // bit depth
  ihdr[9] = 6;   // RGBA
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  put_chunk(out, "IHDR", ihdr, 13);
  put_chunk(out, "IDAT", comp.data(), comp.size());
  put_chunk(out, "IEND", nullptr, 0);

  FILE* f = std::fopen(path, "wb");
  if (!f) return -2;
  size_t written = std::fwrite(out.data(), 1, out.size(), f);
  std::fclose(f);
  return written == out.size() ? 0 : -3;
}

}  // extern "C"
