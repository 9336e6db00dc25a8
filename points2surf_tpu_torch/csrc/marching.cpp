// Native marching-tetrahedra isosurface extraction.
//
// C++ twin of points2surf_tpu_torch/ops/marching_cubes.py (same Kuhn 6-tet
// cube decomposition and case table, so outputs are interchangeable), built
// for throughput on large volumes: single pass over cubes, open-addressing
// hash map for edge-vertex dedup, OpenMP-parallel over z-slabs. Each z-slab
// fills its own buffer and the buffers are merged in slab order, so vertices
// and faces come out in the single-thread order, bit for bit, whatever the
// number of threads and however the slabs were scheduled.
//
// C ABI (ctypes):
//   mt_extract(vol, rx, ry, rz, level, n_threads, &verts, &faces, &nv, &nf)
//     -> 0/err; n_threads <= 0 takes the OpenMP default
//   mt_free(ptr)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// cube corner offsets (x, y, z), matching the python _CORNERS
const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};
// Kuhn decomposition around diagonal c0-c6 (python _TETS)
const int TETS[6][4] = {
    {0, 1, 2, 6}, {0, 2, 3, 6}, {0, 3, 7, 6},
    {0, 7, 4, 6}, {0, 4, 5, 6}, {0, 5, 1, 6},
};

// case table: bitmask of "corner > level" -> up to 2 triangles of edges
// (inside_corner, outside_corner); -1 terminated (python _CASES)
struct Case {
    int8_t n_tris;
    int8_t edges[2][3][2];
};
Case CASES[16];

struct CaseInit {
    CaseInit() {
        std::memset(CASES, 0, sizeof(CASES));
        auto set_tri = [&](int mask, int tri, int a0, int b0, int a1, int b1,
                           int a2, int b2) {
            int8_t(*e)[2] = CASES[mask].edges[tri];
            e[0][0] = static_cast<int8_t>(a0);
            e[0][1] = static_cast<int8_t>(b0);
            e[1][0] = static_cast<int8_t>(a1);
            e[1][1] = static_cast<int8_t>(b1);
            e[2][0] = static_cast<int8_t>(a2);
            e[2][1] = static_cast<int8_t>(b2);
        };
        auto set1 = [&](int mask, int a0, int b0, int a1, int b1, int a2,
                        int b2) {
            CASES[mask].n_tris = 1;
            set_tri(mask, 0, a0, b0, a1, b1, a2, b2);
        };
        auto set2 = [&](int mask, int a0, int b0, int a1, int b1, int a2,
                        int b2, int c0, int d0, int c1, int d1, int c2,
                        int d2) {
            CASES[mask].n_tris = 2;
            set_tri(mask, 0, a0, b0, a1, b1, a2, b2);
            set_tri(mask, 1, c0, d0, c1, d1, c2, d2);
        };
        // Windings are coherently oriented BY CONSTRUCTION (inside ->
        // outside, derived in the canonical positive-parity tet — see
        // python _orient_case_table); all six Kuhn tets have positive
        // parity, so the surface comes out globally consistent and no
        // per-face gradient orientation is needed (gradients mis-orient
        // faces on thin features and broke watertightness there).
        set1(0b0001, 0, 1, 0, 2, 0, 3);
        set1(0b0010, 1, 0, 1, 3, 1, 2);
        set1(0b0100, 2, 0, 2, 1, 2, 3);
        set1(0b1000, 3, 0, 3, 2, 3, 1);
        set2(0b0011, 0, 2, 0, 3, 1, 3, 0, 2, 1, 3, 1, 2);
        set2(0b0101, 0, 1, 2, 3, 0, 3, 0, 1, 2, 1, 2, 3);
        set2(0b1001, 0, 1, 0, 2, 3, 2, 0, 1, 3, 2, 3, 1);
        set2(0b0110, 1, 0, 1, 3, 2, 3, 1, 0, 2, 3, 2, 0);
        set2(0b1010, 1, 0, 3, 2, 1, 2, 1, 0, 3, 0, 3, 2);
        set2(0b1100, 2, 0, 2, 1, 3, 1, 2, 0, 3, 1, 3, 0);
        set1(0b1110, 1, 0, 3, 0, 2, 0);
        set1(0b1101, 0, 1, 2, 1, 3, 1);
        set1(0b1011, 0, 2, 3, 2, 1, 2);
        set1(0b0111, 0, 3, 1, 3, 2, 3);
    }
} case_init;

struct SlabOut {
    std::vector<int64_t> tri_edges;  // per triangle: 3 edge keys (lo<<32|hi)
};

inline uint64_t edge_key(int64_t a, int64_t b) {
    if (a > b) {
        int64_t t = a;
        a = b;
        b = t;
    }
    return (static_cast<uint64_t>(a) << 32) | static_cast<uint64_t>(b);
}

// simple open-addressing hash map uint64 -> int32
struct EdgeMap {
    std::vector<uint64_t> keys;
    std::vector<int32_t> vals;
    uint64_t mask;
    explicit EdgeMap(size_t expected) {
        size_t cap = 16;
        while (cap < expected * 2) cap <<= 1;
        keys.assign(cap, UINT64_MAX);
        vals.assign(cap, -1);
        mask = cap - 1;
    }
    int32_t get_or_insert(uint64_t k, int32_t next_id, bool* inserted) {
        uint64_t h = k * 0x9E3779B97F4A7C15ull;
        size_t i = h & mask;
        for (;;) {
            if (keys[i] == k) {
                *inserted = false;
                return vals[i];
            }
            if (keys[i] == UINT64_MAX) {
                keys[i] = k;
                vals[i] = next_id;
                *inserted = true;
                return next_id;
            }
            i = (i + 1) & mask;
        }
    }
};

}  // namespace

extern "C" {

int mt_extract(const float* vol, int rx, int ry, int rz, float level,
               int n_threads, float** out_verts, int64_t** out_faces,
               int64_t* n_verts, int64_t* n_faces) {
    const int64_t syx = static_cast<int64_t>(ry) * rz;
    auto gid = [&](int x, int y, int z) -> int64_t {
        return static_cast<int64_t>(x) * syx + static_cast<int64_t>(y) * rz +
               z;
    };

#ifdef _OPENMP
    if (n_threads <= 0) n_threads = omp_get_max_threads();
#endif
    std::vector<SlabOut> slabs(rz > 1 ? rz - 1 : 0);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4) num_threads(n_threads)
#endif
    for (int z = 0; z < rz - 1; z++) {
        SlabOut& to = slabs[z];
        for (int x = 0; x < rx - 1; x++) {
            for (int y = 0; y < ry - 1; y++) {
                float v8[8];
                int64_t g8[8];
                int in_count = 0;
                for (int c = 0; c < 8; c++) {
                    int cx = x + CORNERS[c][0];
                    int cy = y + CORNERS[c][1];
                    int cz = z + CORNERS[c][2];
                    int64_t g = gid(cx, cy, cz);
                    v8[c] = vol[g];
                    g8[c] = g;
                    if (v8[c] > level) in_count++;
                }
                if (in_count == 0 || in_count == 8) continue;
                for (int t = 0; t < 6; t++) {
                    int mask = 0;
                    for (int c = 0; c < 4; c++)
                        if (v8[TETS[t][c]] > level) mask |= 1 << c;
                    const Case& cs = CASES[mask];
                    for (int tri = 0; tri < cs.n_tris; tri++) {
                        for (int e = 0; e < 3; e++) {
                            int ia = TETS[t][cs.edges[tri][e][0]];
                            int ib = TETS[t][cs.edges[tri][e][1]];
                            to.tri_edges.push_back(
                                static_cast<int64_t>(edge_key(g8[ia], g8[ib])));
                        }
                    }
                }
            }
        }
    }

    // merge in slab order: dedup edge vertices, build faces
    size_t total_tris = 0;
    for (auto& to : slabs) total_tris += to.tri_edges.size() / 3;
    if (total_tris == 0) {
        *out_verts = nullptr;
        *out_faces = nullptr;
        *n_verts = 0;
        *n_faces = 0;
        return 0;
    }

    EdgeMap emap(total_tris * 2);
    std::vector<uint64_t> uniq_edges;
    uniq_edges.reserve(total_tris * 3 / 2);
    std::vector<int64_t> faces;
    faces.reserve(total_tris * 3);

    for (auto& to : slabs) {
        for (size_t i = 0; i < to.tri_edges.size(); i++) {
            uint64_t k = static_cast<uint64_t>(to.tri_edges[i]);
            bool inserted;
            int32_t id = emap.get_or_insert(
                k, static_cast<int32_t>(uniq_edges.size()), &inserted);
            if (inserted) uniq_edges.push_back(k);
            faces.push_back(id);
        }
    }

    // interpolate vertex positions
    int64_t nv = static_cast<int64_t>(uniq_edges.size());
    float* verts = static_cast<float*>(std::malloc(nv * 3 * sizeof(float)));
    if (!verts) return 1;
#ifdef _OPENMP
#pragma omp parallel for num_threads(n_threads)
#endif
    for (int64_t i = 0; i < nv; i++) {
        uint64_t k = uniq_edges[i];
        int64_t a = static_cast<int64_t>(k >> 32);
        int64_t b = static_cast<int64_t>(k & 0xFFFFFFFFull);
        float fa = vol[a];
        float fb = vol[b];
        float t = (level - fa) / (fb - fa);
        float ax = static_cast<float>(a / syx);
        float ay = static_cast<float>((a / rz) % ry);
        float az = static_cast<float>(a % rz);
        float bx = static_cast<float>(b / syx);
        float by = static_cast<float>((b / rz) % ry);
        float bz = static_cast<float>(b % rz);
        verts[i * 3 + 0] = ax + t * (bx - ax);
        verts[i * 3 + 1] = ay + t * (by - ay);
        verts[i * 3 + 2] = az + t * (bz - az);
    }

    int64_t nf = static_cast<int64_t>(faces.size() / 3);
    int64_t* f_out =
        static_cast<int64_t*>(std::malloc(faces.size() * sizeof(int64_t)));
    if (!f_out) {
        std::free(verts);
        return 1;
    }
    std::memcpy(f_out, faces.data(), faces.size() * sizeof(int64_t));

    // faces come out coherently oriented from the parity-consistent case
    // table (normals toward the negative/outside side) — no per-face
    // gradient orientation pass

    *out_verts = verts;
    *out_faces = f_out;
    *n_verts = nv;
    *n_faces = nf;
    return 0;
}

void mt_free(void* p) { std::free(p); }

}  // extern "C"
