// Native OBJ/MTL parser — the string-heavy host loader, in C++.
//
// C++ twin of models/objio.py, covering the tinyobjloader subset the
// reference exercises (tiny_obj_loader.cc:661-884): v/vn/vt/f lines with
// triangle-fan conversion of polygons (tiny_obj_loader.cc:382-402),
// (v,vt,vn)-triple vertex dedup per shape (tiny_obj_loader.cc:304-339),
// negative-index fixup (tiny_obj_loader.cc:77-81), usemtl/mtllib/g/o
// handling, and MTL keys Ka/Kd/Ks/Ke/Ns/Ni/d/Tr/illum
// (tiny_obj_loader.cc:413-615). This is a from-scratch implementation —
// not tinyobj — exposing a flat C ABI for ctypes (accel/native.py).
// Per-face material ids are preserved (the reference then collapsed them
// to material_ids[0], modelLoader.h:189 — a quirk we fix at the loader
// level, SURVEY.md §7).
//
// Build: make -C cudapathtracer_tpu/native

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <string>
#include <tuple>
#include <vector>

namespace {

struct Mtl {
  std::string name;
  float ambient[3] = {0, 0, 0};
  float diffuse[3] = {0, 0, 0};
  float specular[3] = {0, 0, 0};
  float emission[3] = {0, 0, 0};
  float shininess = 1, ior = 1, dissolve = 1;
  int illum = 0;
  // texture map names (tiny_obj_loader.cc:552-575): parsed for parity
  // completeness, unused by the renderer (no reference scene has textures)
  std::string ambient_texname, diffuse_texname, specular_texname,
      normal_texname;
};

struct Shape {
  std::vector<float> positions;   // 3 per vertex
  std::vector<float> normals;
  std::vector<float> texcoords;
  std::vector<int32_t> indices;   // 3 per face
  std::vector<int32_t> material_ids;  // per face
};

struct ParseResult {
  std::vector<Shape> shapes;
  std::vector<Mtl> materials;
  std::string error;
};

static std::string dir_of(const std::string& path) {
  size_t p = path.find_last_of("/\\");
  return p == std::string::npos ? std::string(".") : path.substr(0, p);
}

static void strip(std::string& s) {
  size_t h = s.find('#');
  if (h != std::string::npos) s.erase(h);
  size_t b = s.find_first_not_of(" \t\r\n");
  size_t e = s.find_last_not_of(" \t\r\n");
  s = (b == std::string::npos) ? "" : s.substr(b, e - b + 1);
}

static std::vector<std::string> split_ws(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size()) {
    while (i < s.size() && (s[i] == ' ' || s[i] == '\t')) ++i;
    size_t j = i;
    while (j < s.size() && s[j] != ' ' && s[j] != '\t') ++j;
    if (j > i) out.push_back(s.substr(i, j - i));
    i = j;
  }
  return out;
}

// OBJ 1-based; negative = relative (tiny_obj_loader.cc:77-81)
static bool fix_index(long idx, long n, int32_t* out) {
  if (idx > 0) { *out = (int32_t)(idx - 1); return true; }
  if (idx < 0) { *out = (int32_t)(n + idx); return true; }
  return false;
}

static void parse_mtl_file(const std::string& path,
                           std::vector<Mtl>& materials,
                           std::map<std::string, int>& mat_index) {
  FILE* f = fopen(path.c_str(), "r");
  if (!f) return;
  char buf[4096];
  Mtl* cur = nullptr;
  while (fgets(buf, sizeof(buf), f)) {
    std::string line(buf);
    strip(line);
    if (line.empty()) continue;
    auto tok = split_ws(line);
    const std::string& key = tok[0];
    auto f3 = [&](float* dst) {
      for (int i = 0; i < 3 && i + 1 < (int)tok.size(); ++i)
        dst[i] = strtof(tok[i + 1].c_str(), nullptr);
    };
    if (key == "newmtl") {
      std::string name = tok.size() > 1 ? tok[1] : "";
      if (!mat_index.count(name)) {
        mat_index[name] = (int)materials.size();
        materials.push_back(Mtl());
        materials.back().name = name;
      }
      cur = &materials[mat_index[name]];
    } else if (!cur) {
      continue;
    } else if (key == "Ka") f3(cur->ambient);
    else if (key == "Kd") f3(cur->diffuse);
    else if (key == "Ks") f3(cur->specular);
    else if (key == "Ke") f3(cur->emission);
    else if (key == "Ns" && tok.size() > 1)
      cur->shininess = strtof(tok[1].c_str(), nullptr);
    else if (key == "Ni" && tok.size() > 1)
      cur->ior = strtof(tok[1].c_str(), nullptr);
    else if (key == "d" && tok.size() > 1)
      cur->dissolve = strtof(tok[1].c_str(), nullptr);
    else if (key == "Tr" && tok.size() > 1)
      cur->dissolve = 1.0f - strtof(tok[1].c_str(), nullptr);
    else if (key == "illum" && tok.size() > 1)
      cur->illum = (int)strtol(tok[1].c_str(), nullptr, 10);
    else if (key == "map_Ka" && tok.size() > 1) cur->ambient_texname = tok[1];
    else if (key == "map_Kd" && tok.size() > 1) cur->diffuse_texname = tok[1];
    else if (key == "map_Ks" && tok.size() > 1) cur->specular_texname = tok[1];
    else if (key == "map_Ns" && tok.size() > 1) cur->normal_texname = tok[1];
  }
  fclose(f);
}

using Corner = std::tuple<int32_t, int32_t, int32_t>;  // v, vt, vn (-1 none)

static void flush_shape(std::vector<Shape>& shapes,
                        const std::vector<float>& positions,
                        const std::vector<float>& normals,
                        const std::vector<float>& texcoords,
                        std::vector<std::vector<Corner>>& faces,
                        std::vector<int32_t>& face_mats) {
  if (faces.empty()) return;
  Shape sh;
  std::map<Corner, int32_t> cache;
  for (size_t fi = 0; fi < faces.size(); ++fi) {
    const auto& corners = faces[fi];
    for (size_t k = 2; k < corners.size(); ++k) {  // fan-triangulate
      Corner tri[3] = {corners[0], corners[k - 1], corners[k]};
      for (const Corner& cnr : tri) {
        auto it = cache.find(cnr);
        int32_t id;
        if (it == cache.end()) {
          id = (int32_t)(sh.positions.size() / 3);
          cache[cnr] = id;
          int32_t vi = std::get<0>(cnr), ti = std::get<1>(cnr),
                  ni = std::get<2>(cnr);
          for (int c = 0; c < 3; ++c)
            sh.positions.push_back(positions[3 * vi + c]);
          if (ti >= 0 && !texcoords.empty())
            for (int c = 0; c < 2; ++c)
              sh.texcoords.push_back(texcoords[2 * ti + c]);
          if (ni >= 0 && !normals.empty())
            for (int c = 0; c < 3; ++c)
              sh.normals.push_back(normals[3 * ni + c]);
        } else {
          id = it->second;
        }
        sh.indices.push_back(id);
      }
      sh.material_ids.push_back(face_mats[fi]);
    }
  }
  shapes.push_back(std::move(sh));
  faces.clear();
  face_mats.clear();
}

static ParseResult* parse_obj_impl(const char* path, const char* mtl_dir_c) {
  auto* res = new ParseResult();
  FILE* f = fopen(path, "r");
  if (!f) {
    res->error = std::string("cannot open ") + path;
    return res;
  }
  std::string mtl_dir = mtl_dir_c && *mtl_dir_c ? mtl_dir_c : dir_of(path);

  std::vector<float> positions, normals, texcoords;
  std::map<std::string, int> mat_index;
  std::vector<std::vector<Corner>> faces;
  std::vector<int32_t> face_mats;
  int cur_mat = -1;

  char buf[8192];
  while (fgets(buf, sizeof(buf), f)) {
    std::string line(buf);
    strip(line);
    if (line.empty()) continue;
    auto tok = split_ws(line);
    const std::string& key = tok[0];
    if (key == "v") {
      for (int i = 0; i < 3 && i + 1 < (int)tok.size(); ++i)
        positions.push_back(strtof(tok[i + 1].c_str(), nullptr));
    } else if (key == "vn") {
      for (int i = 0; i < 3 && i + 1 < (int)tok.size(); ++i)
        normals.push_back(strtof(tok[i + 1].c_str(), nullptr));
    } else if (key == "vt") {
      for (int i = 0; i < 2 && i + 1 < (int)tok.size(); ++i)
        texcoords.push_back(strtof(tok[i + 1].c_str(), nullptr));
    } else if (key == "f") {
      std::vector<Corner> corners;
      for (size_t i = 1; i < tok.size(); ++i) {
        const std::string& c = tok[i];
        long vi = 0, ti = 0, ni = 0;
        int slot = 0;
        std::string num;
        auto commit = [&](int s, const std::string& v) {
          if (v.empty()) return;
          long val = strtol(v.c_str(), nullptr, 10);
          if (s == 0) vi = val;
          else if (s == 1) ti = val;
          else ni = val;
        };
        for (char ch : c) {
          if (ch == '/') { commit(slot, num); num.clear(); ++slot; }
          else num.push_back(ch);
        }
        commit(slot, num);
        int32_t fvi, fti = -1, fni = -1;
        if (!fix_index(vi, (long)(positions.size() / 3), &fvi)) {
          res->error = "OBJ index 0 is invalid";
          fclose(f);
          return res;
        }
        if (ti) fix_index(ti, (long)(texcoords.size() / 2), &fti);
        if (ni) fix_index(ni, (long)(normals.size() / 3), &fni);
        corners.emplace_back(fvi, fti, fni);
      }
      faces.push_back(std::move(corners));
      face_mats.push_back(cur_mat);
    } else if (key == "usemtl") {
      std::string name = tok.size() > 1 ? tok[1] : "";
      auto it = mat_index.find(name);
      cur_mat = it == mat_index.end() ? -1 : it->second;
    } else if (key == "mtllib") {
      for (size_t i = 1; i < tok.size(); ++i)
        parse_mtl_file(mtl_dir + "/" + tok[i], res->materials, mat_index);
    } else if (key == "g" || key == "o") {
      flush_shape(res->shapes, positions, normals, texcoords, faces,
                  face_mats);
    }
  }
  flush_shape(res->shapes, positions, normals, texcoords, faces, face_mats);
  fclose(f);
  return res;
}

}  // namespace

extern "C" {

void* cpt_parse_obj(const char* path, const char* mtl_dir) {
  return parse_obj_impl(path, mtl_dir);
}

const char* cpt_obj_error(void* h) {
  auto* r = (ParseResult*)h;
  return r->error.empty() ? nullptr : r->error.c_str();
}

int64_t cpt_obj_num_shapes(void* h) {
  return (int64_t)((ParseResult*)h)->shapes.size();
}

int64_t cpt_obj_num_materials(void* h) {
  return (int64_t)((ParseResult*)h)->materials.size();
}

// material accessors: 13 floats per material + name
void cpt_obj_material(void* h, int64_t i, float* out13) {
  const Mtl& m = ((ParseResult*)h)->materials[i];
  float* o = out13;
  memcpy(o, m.ambient, 12); o += 3;
  memcpy(o, m.diffuse, 12); o += 3;
  memcpy(o, m.specular, 12); o += 3;
  memcpy(o, m.emission, 12); o += 3;
  o[0] = m.shininess;
  // (ior, dissolve, illum fetched via cpt_obj_material_extra)
}

void cpt_obj_material_extra(void* h, int64_t i, float* out3) {
  const Mtl& m = ((ParseResult*)h)->materials[i];
  out3[0] = m.ior;
  out3[1] = m.dissolve;
  out3[2] = (float)m.illum;
}

const char* cpt_obj_material_name(void* h, int64_t i) {
  return ((ParseResult*)h)->materials[i].name.c_str();
}

// shape accessors
int64_t cpt_obj_shape_num_verts(void* h, int64_t s) {
  return (int64_t)(((ParseResult*)h)->shapes[s].positions.size() / 3);
}
int64_t cpt_obj_shape_num_faces(void* h, int64_t s) {
  return (int64_t)(((ParseResult*)h)->shapes[s].material_ids.size());
}
int64_t cpt_obj_shape_num_normals(void* h, int64_t s) {
  return (int64_t)(((ParseResult*)h)->shapes[s].normals.size() / 3);
}
int64_t cpt_obj_shape_num_texcoords(void* h, int64_t s) {
  return (int64_t)(((ParseResult*)h)->shapes[s].texcoords.size() / 2);
}
void cpt_obj_shape_data(void* h, int64_t s, float* positions,
                        int32_t* indices, int32_t* material_ids,
                        float* normals, float* texcoords) {
  const Shape& sh = ((ParseResult*)h)->shapes[s];
  if (positions)
    memcpy(positions, sh.positions.data(),
           sh.positions.size() * sizeof(float));
  if (indices)
    memcpy(indices, sh.indices.data(), sh.indices.size() * sizeof(int32_t));
  if (material_ids)
    memcpy(material_ids, sh.material_ids.data(),
           sh.material_ids.size() * sizeof(int32_t));
  if (normals && !sh.normals.empty())
    memcpy(normals, sh.normals.data(), sh.normals.size() * sizeof(float));
  if (texcoords && !sh.texcoords.empty())
    memcpy(texcoords, sh.texcoords.data(),
           sh.texcoords.size() * sizeof(float));
}

void cpt_obj_free(void* h) { delete (ParseResult*)h; }

}  // extern "C"
