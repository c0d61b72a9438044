// heatflow_tpu_torch native mesh/assembly kernels (host C++).
//
// Host-side C++ counterpart of the reference stack's native meshing and
// element-assembly layers (gmsh C++ and DOLFINx/FFCx generated C kernels,
// ref mesh_and_materials/mesh.py:81-149 driving gmsh, space_and_forms.py
// driving FFCx). The device path stays PyTorch/CUDA; this library speeds up
// the one-time host-side setup: graded axis generation, cell tagging, and
// exact closed-form P1 stencil assembly for large meshes.
//
// Exposed via a C ABI for ctypes (heatflow_tpu_torch/native); built with
// g++ at first use by heatflow_tpu_torch/ops/_build.py:build_native.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Graded 1D axis: spans are triples (a, b, h); sizing at a point is the min
// over covering spans else default_h. Mirrors mesh/axes.py:graded_axis.
// Returns the number of coordinates written, or -1 if out_cap is too small.
// ---------------------------------------------------------------------------
long hf_graded_axis(double lo, double hi, const double* spans, long n_spans,
                    double default_h, double* out, long out_cap) {
    std::vector<double> brk;
    brk.push_back(lo);
    brk.push_back(hi);
    for (long s = 0; s < n_spans; ++s) {
        for (int e = 0; e < 2; ++e) {
            double p = spans[3 * s + e];
            if (p > lo && p < hi) brk.push_back(p);
        }
    }
    std::sort(brk.begin(), brk.end());
    double scale = std::max(std::max(std::fabs(lo), std::fabs(hi)), 1e-30);
    std::vector<double> keep;
    keep.push_back(brk[0]);
    for (size_t i = 1; i < brk.size(); ++i)
        if (brk[i] - keep.back() > 1e-12 * scale) keep.push_back(brk[i]);

    long n = 0;
    if (n >= out_cap) return -1;
    out[n++] = keep[0];
    for (size_t i = 0; i + 1 < keep.size(); ++i) {
        double a = keep[i], b = keep[i + 1];
        double mid = 0.5 * (a + b);
        double h = default_h;
        for (long s = 0; s < n_spans; ++s) {
            if (spans[3 * s] <= mid && mid <= spans[3 * s + 1])
                h = std::min(h, spans[3 * s + 2]);
        }
        long cells = (long)std::ceil((b - a) / h - 1e-9);
        if (cells < 1) cells = 1;
        for (long c = 1; c <= cells; ++c) {
            if (n >= out_cap) return -1;
            out[n++] = a + (b - a) * (double)c / (double)cells;
        }
    }
    return n;
}

// ---------------------------------------------------------------------------
// Cell tagging: first material rectangle containing the cell centroid wins
// (1-based tags; 0 = uncovered). Mirrors mesh/structured.py:_assign_cell_tags.
// ---------------------------------------------------------------------------
void hf_assign_cell_tags(const double* z, long nz, const double* r, long nr,
                         const double* rects, long n_mats, int32_t* tags) {
    for (long i = 0; i + 1 < nz; ++i) {
        double zc = 0.5 * (z[i] + z[i + 1]);
        for (long j = 0; j + 1 < nr; ++j) {
            double rc = 0.5 * (r[j] + r[j + 1]);
            int32_t tag = 0;
            for (long m = 0; m < n_mats; ++m) {
                const double* q = rects + 4 * m;
                if (zc >= q[0] && zc <= q[1] && rc >= q[2] && rc <= q[3]) {
                    tag = (int32_t)(m + 1);
                    break;
                }
            }
            tags[i * (nr - 1) + j] = tag;
        }
    }
}

// ---------------------------------------------------------------------------
// Exact P1 stencil assembly on the structured triangulated grid.
//
// Layout (all row-major double):
//   K, M:          (n_mats, 7, nz, nr)  r-weighted stiffness / mass
//   K_flat,M_flat: (n_mats, 7, nz, nr)  unweighted variants
//   G_r, G_z:      (7, nz, nr)          gradient-projection rhs operators
// Offsets order matches ops/stencil.py:OFFSETS:
//   (0,0),(1,0),(-1,0),(0,1),(0,-1),(1,1),(-1,-1)
//
// Bit for bit the numpy assembly of ops/stencil.py: each element quantity is
// the same expression as ops/p1.py's, evaluated in the same order (built
// with -ffp-contract=off, so no product is fused into an add), and every
// stencil entry receives its contributions in numpy's order: the lower
// triangles before the upper ones, within a kind vertex pair (a, b) by pair.
// ---------------------------------------------------------------------------
namespace {

static const int OFFS[7][2] = {{0, 0}, {1, 0}, {-1, 0}, {0, 1},
                               {0, -1}, {1, 1}, {-1, -1}};

inline int off_index(int di, int dj) {
    for (int k = 0; k < 7; ++k)
        if (OFFS[k][0] == di && OFFS[k][1] == dj) return k;
    return -1;
}

// vertex grid offsets within the quad: lower, upper (ops/stencil.py:_TRI_VPOS)
static const int VP[2][3][2] = {{{0, 0}, {1, 0}, {1, 1}},
                                {{0, 0}, {1, 1}, {0, 1}}};

// ops/p1.py's quantities for one triangle
struct Elem {
    double area, rbar, rsum;
    double gz[3], gr[3];   // grads[..., a, 0] (d/dz), grads[..., a, 1] (d/dr)
    double rv[3];
};

inline Elem element(const double* z, const double* r, long i, long j,
                    int t) {
    Elem e;
    double x[3], y[3];
    for (int a = 0; a < 3; ++a) {
        x[a] = z[i + VP[t][a][0]];
        y[a] = r[j + VP[t][a][1]];
        e.rv[a] = y[a];
    }
    double d1x = x[1] - x[0], d1y = y[1] - y[0];
    double d2x = x[2] - x[0], d2y = y[2] - y[0];
    double det = d1x * d2y - d1y * d2x;
    e.area = 0.5 * std::fabs(det);
    double inv = 1.0 / det;
    e.gz[0] = (y[1] - y[2]) * inv;
    e.gz[1] = (y[2] - y[0]) * inv;
    e.gz[2] = (y[0] - y[1]) * inv;
    e.gr[0] = (x[2] - x[1]) * inv;
    e.gr[1] = (x[0] - x[2]) * inv;
    e.gr[2] = (x[1] - x[0]) * inv;
    e.rsum = (y[0] + y[1]) + y[2];
    e.rbar = e.rsum / 3.0;
    return e;
}

// ∫ φa φb φc / A (ops/p1.py:_T3)
inline double t3(int a, int b, int c) {
    if (a == b && b == c) return 1.0 / 10.0;
    if (a != b && b != c && a != c) return 1.0 / 60.0;
    return 1.0 / 30.0;
}

}  // namespace

void hf_assemble_stencils(const double* z, long nz, const double* r, long nr,
                          const int32_t* tags, long n_mats, double* K,
                          double* M, double* K_flat, double* M_flat,
                          double* G_r, double* G_z) {
    const long N = nz * nr;
    const long mat_stride = 7 * N;
    std::memset(K, 0, sizeof(double) * n_mats * mat_stride);
    std::memset(M, 0, sizeof(double) * n_mats * mat_stride);
    std::memset(K_flat, 0, sizeof(double) * n_mats * mat_stride);
    std::memset(M_flat, 0, sizeof(double) * n_mats * mat_stride);
    std::memset(G_r, 0, sizeof(double) * mat_stride);
    std::memset(G_z, 0, sizeof(double) * mat_stride);

    for (int t = 0; t < 2; ++t) {
        for (int a = 0; a < 3; ++a) {
            for (int b = 0; b < 3; ++b) {
                const int k = off_index(VP[t][b][0] - VP[t][a][0],
                                        VP[t][b][1] - VP[t][a][1]);
                const double m2 = (a == b) ? 1.0 / 6.0 : 1.0 / 12.0;
                for (long i = 0; i + 1 < nz; ++i) {
                    for (long j = 0; j + 1 < nr; ++j) {
                        const Elem e = element(z, r, i, j, t);
                        const long idx = (long)k * N
                            + (i + VP[t][a][0]) * nr + (j + VP[t][a][1]);
                        // gradient-projection rhs: w_a * dφ_b/d{r,z}
                        const double wa = (e.rv[a] + e.rsum) * e.area / 12.0;
                        G_r[idx] += wa * e.gr[b];
                        G_z[idx] += wa * e.gz[b];
                        const int32_t tag = tags[i * (nr - 1) + j];
                        if (tag <= 0 || tag > n_mats) continue;
                        const long at = (long)(tag - 1) * mat_stride + idx;
                        const double gg = e.gz[a] * e.gz[b]
                            + e.gr[a] * e.gr[b];
                        K[at] += gg * (e.area * e.rbar);
                        K_flat[at] += gg * e.area;
                        const double mrw = e.rv[0] * t3(a, b, 0)
                            + e.rv[1] * t3(a, b, 1) + e.rv[2] * t3(a, b, 2);
                        M[at] += mrw * e.area;
                        M_flat[at] += m2 * e.area;
                    }
                }
            }
        }
    }
}

}  // extern "C"
