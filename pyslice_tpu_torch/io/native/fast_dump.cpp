// Fast LAMMPS text-dump parser — the native data-loading path.
//
// A copy of pyslice_tpu/io/native/fast_dump.cpp. The ingest layer's hot
// loop is plain text parsing (the original PySlice offloads it to OVITO's
// native parser). This library parses the common
// dump layout in a single streaming pass with hand-rolled number scanning —
// roughly an order of magnitude faster than the pure-Python fallback in
// ../lammps.py, which remains the general-case parser (triclinic boxes,
// scaled/unwrapped coordinate variants, arbitrary column orders).
//
// Supported here (the fast path): "ITEM: ATOMS id type x y z [vx vy vz]
// [ix iy iz]" with an orthogonal "BOX BOUNDS". Anything else returns a
// nonzero code and the caller falls back to Python.
//
// C ABI (consumed via ctypes from ../native_loader.py):
//   dump_scan(path, &n_frames, &n_atoms, &flags) -> 0 on success
//   dump_read(path, positions, velocities, types, box, n_frames, n_atoms)
//     -> 0 on success; arrays are caller-allocated (NumPy) buffers.

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <cmath>
#include <string>
#include <vector>

namespace {

struct Reader {
    FILE* f = nullptr;
    std::vector<char> buf;
    explicit Reader(const char* path) : buf(1 << 20) {
        f = std::fopen(path, "rb");
        if (f) std::setvbuf(f, nullptr, _IOFBF, 1 << 20);
    }
    ~Reader() { if (f) std::fclose(f); }
    bool line(std::string& out) {
        if (!f) return false;
        out.clear();
        char tmp[1 << 16];
        if (!std::fgets(tmp, sizeof tmp, f)) return false;
        out.assign(tmp);
        while (!out.empty() && (out.back() == '\n' || out.back() == '\r'))
            out.pop_back();
        return true;
    }
};

inline const char* skip_ws(const char* p) {
    while (*p == ' ' || *p == '\t') ++p;
    return p;
}

// Parse whitespace-separated doubles from a line; returns count parsed.
inline int parse_doubles(const char* p, double* out, int max_n) {
    int n = 0;
    while (n < max_n) {
        p = skip_ws(p);
        if (*p == '\0') break;
        char* end = nullptr;
        double v = std::strtod(p, &end);
        if (end == p) break;
        out[n++] = v;
        p = end;
    }
    return n;
}

constexpr int FLAG_VELOCITIES = 1;
constexpr int FLAG_IMAGES = 2;

struct Layout {
    int ncols = 0;
    int id = -1, type = -1, x = -1, vx = -1, ix = -1;
    bool ok = false;
};

Layout parse_header(const std::string& line) {
    Layout lay;
    // line = "ITEM: ATOMS id type x y z ..."
    std::vector<std::string> cols;
    const char* p = line.c_str() + strlen("ITEM: ATOMS");
    while (*p) {
        p = skip_ws(p);
        const char* s = p;
        while (*p && *p != ' ' && *p != '\t') ++p;
        if (p > s) cols.emplace_back(s, p - s);
    }
    lay.ncols = (int)cols.size();
    for (int i = 0; i < lay.ncols; ++i) {
        const std::string& c = cols[i];
        if (c == "id") lay.id = i;
        else if (c == "type") lay.type = i;
        else if (c == "x") lay.x = i;
        else if (c == "vx") lay.vx = i;
        else if (c == "ix") lay.ix = i;
    }
    // Require contiguous x y z (and vx vy vz / ix iy iz when present).
    auto has3 = [&](int base, const char* a, const char* b) {
        return base >= 0 && base + 2 < lay.ncols &&
               cols[base + 1] == a && cols[base + 2] == b;
    };
    lay.ok = lay.id >= 0 && lay.type >= 0 && has3(lay.x, "y", "z") &&
             (lay.vx < 0 || has3(lay.vx, "vy", "vz")) &&
             (lay.ix < 0 || has3(lay.ix, "iy", "iz"));
    return lay;
}

}  // namespace

extern "C" {

// Scan pass: frame/atom counts + capability flags. Returns 0 on success,
// >0 when the file needs the general (Python) parser, <0 on I/O error.
int dump_scan(const char* path, int64_t* n_frames, int64_t* n_atoms,
              int32_t* flags) {
    Reader r(path);
    if (!r.f) return -1;
    std::string line;
    int64_t frames = 0, atoms = -1;
    int32_t fl = 0;
    while (r.line(line)) {
        if (line.rfind("ITEM: TIMESTEP", 0) != 0) continue;
        if (!r.line(line)) return -2;                 // timestep value
        if (!r.line(line) ||
            line.rfind("ITEM: NUMBER OF ATOMS", 0) != 0) return 1;
        if (!r.line(line)) return -2;
        int64_t na = std::strtoll(line.c_str(), nullptr, 10);
        if (atoms < 0) atoms = na;
        else if (na != atoms) return 2;               // varying atom count
        if (!r.line(line) || line.rfind("ITEM: BOX BOUNDS", 0) != 0) return 1;
        if (line.find("xy") != std::string::npos) return 3;   // triclinic
        for (int i = 0; i < 3; ++i)
            if (!r.line(line)) return -2;
        if (!r.line(line) || line.rfind("ITEM: ATOMS", 0) != 0) return 1;
        Layout lay = parse_header(line);
        if (!lay.ok) return 4;                        // unsupported columns
        if (lay.vx >= 0) fl |= FLAG_VELOCITIES;
        if (lay.ix >= 0) fl |= FLAG_IMAGES;
        for (int64_t i = 0; i < atoms; ++i)
            if (!r.line(line)) return -2;
        ++frames;
    }
    if (frames == 0 || atoms <= 0) return 5;
    *n_frames = frames;
    *n_atoms = atoms;
    *flags = fl;
    return 0;
}

// Fill pass. positions/velocities: (n_frames, n_atoms, 3) float64,
// types: (n_atoms,) int32, box: 9 float64 (3x3, cell vectors as columns),
// images (may be null when flags lacked FLAG_IMAGES): (n_frames, n_atoms, 3)
// float64. Atoms are sorted by id (1-based contiguous ids assumed; falls
// back to error 6 otherwise). Box origin is subtracted from positions.
int dump_read(const char* path, double* positions, double* velocities,
              int32_t* types, double* box, double* images,
              int64_t n_frames, int64_t n_atoms) {
    Reader r(path);
    if (!r.f) return -1;
    std::string line;
    int64_t frame = -1;
    double xlo = 0, ylo = 0, zlo = 0;
    while (r.line(line)) {
        if (line.rfind("ITEM: TIMESTEP", 0) != 0) continue;
        ++frame;
        if (frame >= n_frames) return 7;
        r.line(line);                                  // timestep value
        r.line(line);                                  // NUMBER OF ATOMS
        r.line(line);                                  // count
        r.line(line);                                  // BOX BOUNDS
        double b[2];
        r.line(line); parse_doubles(line.c_str(), b, 2);
        xlo = b[0]; double lx = b[1] - b[0];
        r.line(line); parse_doubles(line.c_str(), b, 2);
        ylo = b[0]; double ly = b[1] - b[0];
        r.line(line); parse_doubles(line.c_str(), b, 2);
        zlo = b[0]; double lz = b[1] - b[0];
        if (frame == 0) {
            std::memset(box, 0, 9 * sizeof(double));
            box[0] = lx; box[4] = ly; box[8] = lz;
        }
        r.line(line);                                  // ITEM: ATOMS header
        Layout lay = parse_header(line);
        if (!lay.ok) return 4;
        double row[64];
        double* pf = positions + frame * n_atoms * 3;
        double* vf = velocities + frame * n_atoms * 3;
        double* imf = images ? images + frame * n_atoms * 3 : nullptr;
        for (int64_t i = 0; i < n_atoms; ++i) {
            if (!r.line(line)) return -2;
            int n = parse_doubles(line.c_str(), row,
                                  lay.ncols > 64 ? 64 : lay.ncols);
            if (n < lay.ncols) return -3;
            int64_t id = (int64_t)row[lay.id] - 1;
            if (id < 0 || id >= n_atoms) return 6;
            if (frame == 0) types[id] = (int32_t)row[lay.type];
            double* p = pf + id * 3;
            p[0] = row[lay.x] - xlo;
            p[1] = row[lay.x + 1] - ylo;
            p[2] = row[lay.x + 2] - zlo;
            double* v = vf + id * 3;
            if (lay.vx >= 0) {
                v[0] = row[lay.vx]; v[1] = row[lay.vx + 1];
                v[2] = row[lay.vx + 2];
            } else {
                v[0] = v[1] = v[2] = 0.0;
            }
            if (imf) {
                double* im = imf + id * 3;
                if (lay.ix >= 0) {
                    im[0] = row[lay.ix]; im[1] = row[lay.ix + 1];
                    im[2] = row[lay.ix + 2];
                } else {
                    im[0] = im[1] = im[2] = 0.0;
                }
            }
        }
    }
    return (frame + 1 == n_frames) ? 0 : 8;
}

}  // extern "C"

// --- incremental (streaming) API ---------------------------------------------
//
// One frame at a time for io/stream.py's TrajectoryStream: the whole-file
// entry points above materialize (n_frames, n_atoms, 3) arrays, which is
// exactly what streaming ingest exists to avoid. The caller gates with
// dump_scan (one fast pass) so every frame is known to be the supported
// layout before iteration starts; mid-file surprises still return errors.
//
//   dump_open(path) -> handle (null on I/O error)
//   dump_next_header(h, &n_atoms, &flags, box9) -> 0 ok, 1 clean EOF,
//       >1 unsupported layout, <0 I/O error. Leaves the reader positioned
//       at the frame's first atom row.
//   dump_next_body(h, pos, vel, types, images_or_null) -> 0 ok, <0 error.
//       Buffers are (n_atoms, 3) float64 / (n_atoms,) int32, id-sorted,
//       origin-subtracted — the same conventions as dump_read.
//   dump_close(h)

namespace {

struct StreamHandle {
    Reader r;
    Layout lay;
    double xlo = 0, ylo = 0, zlo = 0;
    int64_t n_atoms = 0;
    bool header_ready = false;
    explicit StreamHandle(const char* path) : r(path) {}
};

}  // namespace

extern "C" {

void* dump_open(const char* path) {
    auto* h = new StreamHandle(path);
    if (!h->r.f) {
        delete h;
        return nullptr;
    }
    return h;
}

void dump_close(void* vh) {
    delete static_cast<StreamHandle*>(vh);
}

int dump_next_header(void* vh, int64_t* n_atoms, int32_t* flags,
                     double* box9) {
    auto* h = static_cast<StreamHandle*>(vh);
    if (!h || !h->r.f) return -1;
    std::string line;
    while (h->r.line(line)) {
        if (line.rfind("ITEM: TIMESTEP", 0) != 0) continue;
        if (!h->r.line(line)) return -2;               // timestep value
        if (!h->r.line(line) ||
            line.rfind("ITEM: NUMBER OF ATOMS", 0) != 0) return 2;
        if (!h->r.line(line)) return -2;
        h->n_atoms = std::strtoll(line.c_str(), nullptr, 10);
        if (h->n_atoms <= 0) return 2;
        if (!h->r.line(line) ||
            line.rfind("ITEM: BOX BOUNDS", 0) != 0) return 2;
        if (line.find("xy") != std::string::npos) return 3;  // triclinic
        double b[2], len[3], lo[3];
        for (int i = 0; i < 3; ++i) {
            if (!h->r.line(line)) return -2;
            if (parse_doubles(line.c_str(), b, 2) < 2) return -3;
            lo[i] = b[0];
            len[i] = b[1] - b[0];
        }
        h->xlo = lo[0]; h->ylo = lo[1]; h->zlo = lo[2];
        if (!h->r.line(line) || line.rfind("ITEM: ATOMS", 0) != 0) return 2;
        h->lay = parse_header(line);
        if (!h->lay.ok) return 4;
        std::memset(box9, 0, 9 * sizeof(double));
        box9[0] = len[0]; box9[4] = len[1]; box9[8] = len[2];
        *n_atoms = h->n_atoms;
        int32_t fl = 0;
        if (h->lay.vx >= 0) fl |= FLAG_VELOCITIES;
        if (h->lay.ix >= 0) fl |= FLAG_IMAGES;
        *flags = fl;
        h->header_ready = true;
        return 0;
    }
    return 1;                                           // clean EOF
}

int dump_next_body(void* vh, double* positions, double* velocities,
                   int32_t* types, double* images) {
    auto* h = static_cast<StreamHandle*>(vh);
    if (!h || !h->r.f || !h->header_ready) return -1;
    h->header_ready = false;
    std::string line;
    double row[64];
    const Layout& lay = h->lay;
    for (int64_t i = 0; i < h->n_atoms; ++i) {
        if (!h->r.line(line)) return -2;
        int n = parse_doubles(line.c_str(), row,
                              lay.ncols > 64 ? 64 : lay.ncols);
        if (n < lay.ncols) return -3;
        int64_t id = (int64_t)row[lay.id] - 1;
        if (id < 0 || id >= h->n_atoms) return -6;
        types[id] = (int32_t)row[lay.type];
        double* p = positions + id * 3;
        p[0] = row[lay.x] - h->xlo;
        p[1] = row[lay.x + 1] - h->ylo;
        p[2] = row[lay.x + 2] - h->zlo;
        double* v = velocities + id * 3;
        if (lay.vx >= 0) {
            v[0] = row[lay.vx]; v[1] = row[lay.vx + 1];
            v[2] = row[lay.vx + 2];
        } else {
            v[0] = v[1] = v[2] = 0.0;
        }
        if (images) {
            double* im = images + id * 3;
            if (lay.ix >= 0) {
                im[0] = row[lay.ix]; im[1] = row[lay.ix + 1];
                im[2] = row[lay.ix + 2];
            } else {
                im[0] = im[1] = im[2] = 0.0;
            }
        }
    }
    return 0;
}

}  // extern "C"
