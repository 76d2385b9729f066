// Native URDF -> primitive-scene compiler (host-side data loader).
//
// A copy of the JAX package's native/scene_compiler.cpp. It parses URDF
// XML, walks the joint tree, aggregates mass/inertia with the parallel-axis
// theorem, and extracts box/cylinder/sphere collision primitives into flat
// arrays: the same contract as the Python parser in assets/urdf.py, which
// takes the URDFs this compiler declines. A mesh here becomes a box of
// 0.1 x scale (assets/urdf.py sends URDFs with meshes to the Python parser,
// which makes triangles of them; the folder batch does not). A threaded
// batch entry point compiles whole asset folders in parallel at startup.
//
// Build: at first use, by the host compiler (g++ -O2 -std=c++17 -fPIC
// -shared -pthread) into aerial_gym_simulator_tpu_torch/_build/
// (ops/_build.HostLibrary). Python binding: ctypes (assets/native_loader.py).

#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// minimal XML parser (elements + attributes; enough for URDF)
// ---------------------------------------------------------------------------

struct XmlNode {
  std::string tag;
  std::map<std::string, std::string> attrs;
  std::vector<std::unique_ptr<XmlNode>> children;

  const XmlNode* find(const std::string& t) const {
    for (const auto& c : children)
      if (c->tag == t) return c.get();
    return nullptr;
  }
  std::vector<const XmlNode*> find_all(const std::string& t) const {
    std::vector<const XmlNode*> out;
    for (const auto& c : children)
      if (c->tag == t) out.push_back(c.get());
    return out;
  }
  std::string attr(const std::string& k, const std::string& dflt = "") const {
    auto it = attrs.find(k);
    return it == attrs.end() ? dflt : it->second;
  }
};

class XmlParser {
 public:
  explicit XmlParser(const std::string& text) : s_(text), i_(0) {}

  std::unique_ptr<XmlNode> parse() {
    skip_misc();
    return parse_element();
  }

 private:
  const std::string& s_;
  size_t i_;

  void skip_ws() {
    while (i_ < s_.size() && std::isspace((unsigned char)s_[i_])) ++i_;
  }

  void skip_misc() {
    // whitespace, <?...?>, <!--...-->, <!DOCTYPE...>
    for (;;) {
      skip_ws();
      if (i_ + 3 < s_.size() && s_.compare(i_, 4, "<!--") == 0) {
        size_t e = s_.find("-->", i_ + 4);
        i_ = (e == std::string::npos) ? s_.size() : e + 3;
      } else if (i_ + 1 < s_.size() && s_[i_] == '<' &&
                 (s_[i_ + 1] == '?' || s_[i_ + 1] == '!')) {
        size_t e = s_.find('>', i_);
        i_ = (e == std::string::npos) ? s_.size() : e + 1;
      } else {
        return;
      }
    }
  }

  std::string parse_name() {
    size_t start = i_;
    while (i_ < s_.size() &&
           (std::isalnum((unsigned char)s_[i_]) || s_[i_] == '_' ||
            s_[i_] == '-' || s_[i_] == ':' || s_[i_] == '.'))
      ++i_;
    return s_.substr(start, i_ - start);
  }

  std::unique_ptr<XmlNode> parse_element() {
    if (i_ >= s_.size() || s_[i_] != '<') return nullptr;
    ++i_;  // consume '<'
    auto node = std::make_unique<XmlNode>();
    node->tag = parse_name();
    // attributes
    for (;;) {
      skip_ws();
      if (i_ >= s_.size()) return node;
      if (s_[i_] == '/') {          // self-closing
        i_ += 2;                    // "/>"
        return node;
      }
      if (s_[i_] == '>') {
        ++i_;
        break;
      }
      std::string key = parse_name();
      if (key.empty()) {
        ++i_;  // malformed character: consume it so the loop always advances
        continue;
      }
      skip_ws();
      if (i_ < s_.size() && s_[i_] == '=') {
        ++i_;
        skip_ws();
        if (i_ >= s_.size()) return node;
        char quote = s_[i_];
        ++i_;
        size_t start = i_;
        while (i_ < s_.size() && s_[i_] != quote) ++i_;
        node->attrs[key] = s_.substr(start, i_ - start);
        ++i_;  // closing quote
      }
    }
    // children / text until closing tag
    for (;;) {
      skip_misc();
      if (i_ >= s_.size()) return node;
      if (s_[i_] == '<') {
        if (i_ + 1 < s_.size() && s_[i_ + 1] == '/') {
          size_t e = s_.find('>', i_);
          i_ = (e == std::string::npos) ? s_.size() : e + 1;
          return node;
        }
        auto child = parse_element();
        if (child) node->children.push_back(std::move(child));
      } else {
        ++i_;  // text content: URDF carries data in attributes, skip
      }
    }
  }
};

// ---------------------------------------------------------------------------
// small linear algebra
// ---------------------------------------------------------------------------

struct Vec3 {
  double x = 0, y = 0, z = 0;
};
struct Mat3 {
  double m[9] = {1, 0, 0, 0, 1, 0, 0, 0, 1};
};

Vec3 add(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
Vec3 scale(Vec3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
Vec3 matvec(const Mat3& R, Vec3 v) {
  return {R.m[0] * v.x + R.m[1] * v.y + R.m[2] * v.z,
          R.m[3] * v.x + R.m[4] * v.y + R.m[5] * v.z,
          R.m[6] * v.x + R.m[7] * v.y + R.m[8] * v.z};
}
Mat3 matmul(const Mat3& A, const Mat3& B) {
  Mat3 C;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0;
      for (int k = 0; k < 3; ++k) s += A.m[i * 3 + k] * B.m[k * 3 + j];
      C.m[i * 3 + j] = s;
    }
  return C;
}
Mat3 transpose(const Mat3& A) {
  Mat3 T;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) T.m[i * 3 + j] = A.m[j * 3 + i];
  return T;
}

Mat3 rpy_to_matrix(double r, double p, double y) {
  // URDF convention: R = Rz(yaw) * Ry(pitch) * Rx(roll)
  double cr = std::cos(r), sr = std::sin(r);
  double cp = std::cos(p), sp = std::sin(p);
  double cy = std::cos(y), sy = std::sin(y);
  Mat3 R;
  R.m[0] = cy * cp;
  R.m[1] = cy * sp * sr - sy * cr;
  R.m[2] = cy * sp * cr + sy * sr;
  R.m[3] = sy * cp;
  R.m[4] = sy * sp * sr + cy * cr;
  R.m[5] = sy * sp * cr - cy * sr;
  R.m[6] = -sp;
  R.m[7] = cp * sr;
  R.m[8] = cp * cr;
  return R;
}

std::vector<double> parse_floats(const std::string& s) {
  std::vector<double> out;
  std::istringstream iss(s);
  double v;
  while (iss >> v) out.push_back(v);
  return out;
}

void parse_origin(const XmlNode* elem, Vec3* xyz, Mat3* R) {
  *xyz = {0, 0, 0};
  *R = Mat3();
  if (!elem) return;
  const XmlNode* o = elem->find("origin");
  if (!o) return;
  auto p = parse_floats(o->attr("xyz", "0 0 0"));
  if (p.size() == 3) *xyz = {p[0], p[1], p[2]};
  auto rpy = parse_floats(o->attr("rpy", "0 0 0"));
  if (rpy.size() == 3) *R = rpy_to_matrix(rpy[0], rpy[1], rpy[2]);
}

// ---------------------------------------------------------------------------
// URDF compilation (mirrors assets/urdf.py exactly)
// ---------------------------------------------------------------------------

struct CompiledModel {
  double mass = 0;
  Vec3 com;
  double inertia[9] = {0};
  double bound_radius = 0.05;
  std::vector<int> kind;       // 0 box, 1 cylinder, 2 sphere
  std::vector<float> size;     // 3 per prim
  std::vector<float> pos;      // 3 per prim
  std::vector<float> rot;      // 9 per prim
  std::vector<int> semantic;
  bool ok = false;
  std::string error;
};

CompiledModel compile_urdf_text(const std::string& text, int semantic_id,
                                bool per_link_semantic) {
  CompiledModel out;
  XmlParser parser(text);
  auto root = parser.parse();
  if (!root || root->tag != "robot") {
    out.error = "no <robot> root";
    return out;
  }

  // joint tree -> link transforms in root-link frame (zero joint pose)
  struct Joint {
    std::string parent, child;
    Vec3 xyz;
    Mat3 R;
  };
  std::vector<Joint> joints;
  std::map<std::string, bool> is_child;
  for (const XmlNode* j : root->find_all("joint")) {
    const XmlNode* pn = j->find("parent");
    const XmlNode* cn = j->find("child");
    if (!pn || !cn) continue;
    Joint jt;
    jt.parent = pn->attr("link");
    jt.child = cn->attr("link");
    parse_origin(j, &jt.xyz, &jt.R);
    is_child[jt.child] = true;
    joints.push_back(jt);
  }

  auto links = root->find_all("link");
  std::string base;
  for (const XmlNode* l : links) {
    std::string n = l->attr("name");
    if (!is_child.count(n)) {
      base = n;
      break;
    }
  }
  if (base.empty() && !links.empty()) base = links[0]->attr("name");

  std::map<std::string, std::pair<Vec3, Mat3>> tfs;
  tfs[base] = {Vec3{}, Mat3{}};
  for (size_t pass = 0; pass <= joints.size(); ++pass) {
    for (const Joint& j : joints) {
      if (tfs.count(j.parent) && !tfs.count(j.child)) {
        auto& pt = tfs[j.parent];
        tfs[j.child] = {add(pt.first, matvec(pt.second, j.xyz)),
                        matmul(pt.second, j.R)};
      }
    }
  }

  double total_mass = 0;
  Vec3 com_acc{};
  struct Contrib {
    double m;
    Vec3 c;
    double I[9];
  };
  std::vector<Contrib> contribs;

  int link_ctr = 0;
  for (const XmlNode* link : links) {
    std::string name = link->attr("name");
    Vec3 l_xyz{};
    Mat3 l_R{};
    auto it = tfs.find(name);
    if (it != tfs.end()) {
      l_xyz = it->second.first;
      l_R = it->second.second;
    }

    const XmlNode* inertial = link->find("inertial");
    if (inertial) {
      const XmlNode* mass_n = inertial->find("mass");
      double m = mass_n ? std::atof(mass_n->attr("value", "0").c_str()) : 0.0;
      Vec3 i_xyz{};
      Mat3 i_R{};
      parse_origin(inertial, &i_xyz, &i_R);
      Vec3 com_w = add(l_xyz, matvec(l_R, i_xyz));
      Mat3 I{};
      for (double& v : I.m) v = 0;
      const XmlNode* ie = inertial->find("inertia");
      if (ie) {
        double ixx = std::atof(ie->attr("ixx", "0").c_str());
        double iyy = std::atof(ie->attr("iyy", "0").c_str());
        double izz = std::atof(ie->attr("izz", "0").c_str());
        double ixy = std::atof(ie->attr("ixy", "0").c_str());
        double ixz = std::atof(ie->attr("ixz", "0").c_str());
        double iyz = std::atof(ie->attr("iyz", "0").c_str());
        I.m[0] = ixx; I.m[1] = ixy; I.m[2] = ixz;
        I.m[3] = ixy; I.m[4] = iyy; I.m[5] = iyz;
        I.m[6] = ixz; I.m[7] = iyz; I.m[8] = izz;
      }
      Mat3 R_tot = matmul(l_R, i_R);
      Mat3 I_w = matmul(matmul(R_tot, I), transpose(R_tot));
      total_mass += m;
      com_acc = add(com_acc, scale(com_w, m));
      Contrib c;
      c.m = m;
      c.c = com_w;
      std::memcpy(c.I, I_w.m, sizeof(c.I));
      contribs.push_back(c);
    }

    // collision primitives; fall back to visual
    std::vector<const XmlNode*> geoms = link->find_all("collision");
    if (geoms.empty()) geoms = link->find_all("visual");
    int sem = per_link_semantic ? link_ctr : semantic_id;
    for (const XmlNode* g : geoms) {
      const XmlNode* geom = g->find("geometry");
      if (!geom) continue;
      Vec3 g_xyz{};
      Mat3 g_R{};
      parse_origin(g, &g_xyz, &g_R);
      Vec3 p_xyz = add(l_xyz, matvec(l_R, g_xyz));
      Mat3 p_R = matmul(l_R, g_R);
      const XmlNode* box = geom->find("box");
      const XmlNode* cyl = geom->find("cylinder");
      const XmlNode* sph = geom->find("sphere");
      const XmlNode* mesh = geom->find("mesh");
      int kind = -1;
      float size3[3] = {0, 0, 0};
      if (box) {
        auto s = parse_floats(box->attr("size", "0 0 0"));
        kind = 0;
        for (int k = 0; k < 3 && k < (int)s.size(); ++k) size3[k] = (float)s[k];
      } else if (cyl) {
        kind = 1;
        size3[0] = (float)std::atof(cyl->attr("radius", "0").c_str());
        size3[1] = (float)std::atof(cyl->attr("length", "0").c_str());
      } else if (sph) {
        kind = 2;
        size3[0] = (float)std::atof(sph->attr("radius", "0").c_str());
      } else if (mesh) {
        auto s = parse_floats(mesh->attr("scale", "1 1 1"));
        kind = 0;
        for (int k = 0; k < 3; ++k)
          size3[k] = 0.1f * (float)(k < (int)s.size() ? s[k] : 1.0);
      }
      if (kind < 0) continue;
      out.kind.push_back(kind);
      out.size.insert(out.size.end(), size3, size3 + 3);
      out.pos.push_back((float)p_xyz.x);
      out.pos.push_back((float)p_xyz.y);
      out.pos.push_back((float)p_xyz.z);
      for (int k = 0; k < 9; ++k) out.rot.push_back((float)p_R.m[k]);
      out.semantic.push_back(sem);
    }
    ++link_ctr;
  }

  out.mass = total_mass;
  out.com = total_mass > 0 ? scale(com_acc, 1.0 / total_mass) : Vec3{};
  // parallel-axis aggregation about the COM
  for (const Contrib& c : contribs) {
    Vec3 d = add(c.c, scale(out.com, -1.0));
    double dd = d.x * d.x + d.y * d.y + d.z * d.z;
    double dv[3] = {d.x, d.y, d.z};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        out.inertia[i * 3 + j] +=
            c.I[i * 3 + j] + c.m * ((i == j ? dd : 0.0) - dv[i] * dv[j]);
  }
  // bounding sphere
  for (size_t p = 0; p < out.kind.size(); ++p) {
    float mx = 0;
    for (int k = 0; k < 3; ++k)
      mx = std::max(mx, std::fabs(out.size[p * 3 + k]));
    double dx = out.pos[p * 3 + 0] - out.com.x;
    double dy = out.pos[p * 3 + 1] - out.com.y;
    double dz = out.pos[p * 3 + 2] - out.com.z;
    double ext = 0.5 * mx + std::sqrt(dx * dx + dy * dy + dz * dz);
    out.bound_radius = std::max(out.bound_radius, ext);
  }
  out.ok = true;
  return out;
}

CompiledModel compile_urdf_file(const char* path, int semantic_id,
                                bool per_link_semantic) {
  std::ifstream f(path);
  if (!f) {
    CompiledModel out;
    out.error = "cannot open file";
    return out;
  }
  std::stringstream ss;
  ss << f.rdbuf();
  return compile_urdf_text(ss.str(), semantic_id, per_link_semantic);
}

int write_out(const CompiledModel& m, int max_prims, int* n_prims, int* kind,
              float* size, float* pos, float* rot, int* semantic, float* mass,
              float* com, float* inertia, float* bound_radius) {
  if (!m.ok) return -1;
  int n = (int)m.kind.size();
  if (n > max_prims) return -2;
  *n_prims = n;
  std::memcpy(kind, m.kind.data(), n * sizeof(int));
  std::memcpy(size, m.size.data(), n * 3 * sizeof(float));
  std::memcpy(pos, m.pos.data(), n * 3 * sizeof(float));
  std::memcpy(rot, m.rot.data(), n * 9 * sizeof(float));
  std::memcpy(semantic, m.semantic.data(), n * sizeof(int));
  *mass = (float)m.mass;
  com[0] = (float)m.com.x;
  com[1] = (float)m.com.y;
  com[2] = (float)m.com.z;
  for (int k = 0; k < 9; ++k) inertia[k] = (float)m.inertia[k];
  *bound_radius = (float)m.bound_radius;
  return 0;
}

}  // namespace

extern "C" {

// Compile one URDF file. Returns 0 on success, -1 parse error, -2 overflow.
int agtpu_compile_urdf(const char* path, int semantic_id,
                       int per_link_semantic, int max_prims, int* n_prims,
                       int* kind, float* size, float* pos, float* rot,
                       int* semantic, float* mass, float* com, float* inertia,
                       float* bound_radius) {
  CompiledModel m = compile_urdf_file(path, semantic_id,
                                      per_link_semantic != 0);
  return write_out(m, max_prims, n_prims, kind, size, pos, rot, semantic,
                   mass, com, inertia, bound_radius);
}

// Compile URDF XML passed as a string (the procedural-asset path: generated
// robots/obstacles never touch disk). Same contract as agtpu_compile_urdf.
int agtpu_compile_urdf_string(const char* text, int semantic_id,
                              int per_link_semantic, int max_prims,
                              int* n_prims, int* kind, float* size,
                              float* pos, float* rot, int* semantic,
                              float* mass, float* com, float* inertia,
                              float* bound_radius) {
  CompiledModel m = compile_urdf_text(std::string(text), semantic_id,
                                      per_link_semantic != 0);
  return write_out(m, max_prims, n_prims, kind, size, pos, rot, semantic,
                   mass, com, inertia, bound_radius);
}

// Compile a NUL-separated list of n files in parallel. Outputs are
// per-file slabs of stride max_prims. Returns number of failures.
int agtpu_compile_urdf_batch(const char* paths, int n, int semantic_id,
                             int per_link_semantic, int max_prims,
                             int* n_prims, int* kind, float* size, float* pos,
                             float* rot, int* semantic, float* mass,
                             float* com, float* inertia, float* bound_radius,
                             int num_threads) {
  std::vector<const char*> files;
  const char* p = paths;
  for (int i = 0; i < n; ++i) {
    files.push_back(p);
    p += std::strlen(p) + 1;
  }
  std::vector<int> fails(files.size(), 0);

  auto work = [&](size_t start, size_t step) {
    for (size_t i = start; i < files.size(); i += step) {
      CompiledModel m =
          compile_urdf_file(files[i], semantic_id, per_link_semantic != 0);
      int rc = write_out(m, max_prims, n_prims + i, kind + i * max_prims,
                         size + i * max_prims * 3, pos + i * max_prims * 3,
                         rot + i * max_prims * 9, semantic + i * max_prims,
                         mass + i, com + i * 3, inertia + i * 9,
                         bound_radius + i);
      fails[i] = (rc != 0);
    }
  };

  int T = num_threads > 0 ? num_threads
                          : (int)std::thread::hardware_concurrency();
  if (T < 1) T = 1;
  if ((size_t)T > files.size()) T = (int)files.size();
  std::vector<std::thread> threads;
  for (int t = 1; t < T; ++t) threads.emplace_back(work, (size_t)t, (size_t)T);
  if (T >= 1) work(0, (size_t)T);
  for (auto& th : threads) th.join();

  int total_fail = 0;
  for (int f : fails) total_fail += f;
  return total_fail;
}

const char* agtpu_version() { return "aerial_gym_simulator_tpu_torch scene_compiler 1.0"; }

}  // extern "C"
