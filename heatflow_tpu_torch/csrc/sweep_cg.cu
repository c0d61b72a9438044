// Batched CG for coefficient sweeps: B independent (Nz, Nr) problems in
// float32, lane b solving sm_b * (A0 + dk_b Kv) * (sm_b * y) = b_b, with a
// per-lane tolerance stop (identity or r-line PCR preconditioner) or a fixed
// iteration count. In the Kv-free form (Kv = dks = null) every lane solves
// with A0 alone, and the lanes may share one sm plane (stride 0): the
// recording sweeps' per-step mass projection, sm_mp * Mp * (sm_mp * y) = b_b.
//
// Replaces: heatflow_tpu/ops/pallas_cg.py:_sweep_cg_tol_kernel (tolerance
// mode: identity, r-line, has_kv=False, and the adi / adaptive branches,
// whose z-line phase is ks_pcr_z below, and the merged-dot recurrence of
// each of them) and :_sweep_cg_kernel (fixed mode).
// The TPU kernels run one config per grid step, each config's whole solve
// resident in VMEM, one config after another.
//
// What bounds it on an H100: device memory. One lane's working set is ~10
// planes of Nz*Nr floats (0.97 MB each on the 243 x 1001 sweep grid), so no
// block holds a solve, and at B = 1024 one per-lane plane is 1 GB: an
// identity iteration of all lanes streams ~9 such planes (p, sm, Ap; x, r,
// p, Ap and the writes of x and r; r, p and the write of p), ~3 ms at
// 3.35 TB/s. The 14 shared planes of A0 and Kv (13.6 MB) stay in the 50 MB
// L2 across lanes; the per-lane operator A0 + dk_b Kv is combined as it is
// read and never stored.
//
// What the design does about that:
//  * one kernel per CG phase over a grid of (tiles x lanes), so all lanes
//    iterate together and the number of launches does not grow with B;
//  * the CG scalars, the count and a done flag of each lane live in device
//    memory; every block of a finished lane returns at once, and the host
//    reads one word, the number of lanes still running, every CHECK_EVERY
//    iterations. That read comes with a compaction of the running lanes
//    into a list, and the next launches cover only those lanes, so a
//    converged lane costs neither bandwidth nor empty blocks. A lane's
//    arithmetic does not depend on the list or on CHECK_EVERY;
//  * partial sums per (lane, block) in double, reduced per lane in a fixed
//    order: a run is bitwise repeatable;
//  * the r-line PCR is factored inside the apply: a block takes one grid
//    row of one lane, builds the row's couplings from A0, Kv, dk and sm,
//    and runs the PCR levels on the couplings and the right-hand side
//    together in shared memory (6 rows of Nr floats, 24 KB at Nr = 1001).
//    A stored per-lane factor stack would be 21 planes a lane (21 GB at
//    B = 1024) and 21 more planes of traffic an iteration;
//  * the ADI form (z = R r + Z r - r) adds ks_pcr_z, which factors the
//    z-lines the same way. Its floor is reading r and the R r plane and
//    writing z: 3 planes a lane-iteration (2.9 MB at the sweep shape),
//    plus the sm plane and the two z-coupling planes of A0 and Kv from L2.
//    A z-line is a grid column, strided by Nr, so a block takes a tile of
//    up to 32 adjacent columns of one lane: a warp reads 32 neighbours of
//    one row (128 B), and the tile's six work arrays (d, l, u, double
//    buffered) sit in shared memory (6 x Nz x 32 floats, 187 KB at
//    Nz = 243). The adaptive form runs it for the lanes whose flag is set
//    (a (B,) int32 array on the device); the other lanes' blocks return
//    at once, and their z is the r-line solve R r.
//  * <r, z> partials: the r-line phase writes one a grid row, the z phase
//    one a column tile; the scalar phase reads n_rz = max(Nz, tiles) of
//    them in every ADI or adaptive lane, each phase writing zeros over the
//    slots it does not own, so a lane's sum is the same whichever form ran
//    (adding 0.0 changes no sum) and does not depend on its neighbours.
//  * the merged-dot (Chronopoulos-Gear) recurrence keeps q = A p and
//    w = A u per lane (two more planes a lane), takes gamma = <r, u>,
//    delta = <w, u> and <r, r> in the pass that forms w (ks_merged_w), and
//    forms beta and the coupled alpha in one scalar kernel: 4 launches an
//    identity iteration against 5. The done flags, the compaction and the
//    adaptive flags work as in the standard form; gamma does not come from
//    the preconditioner phases' partials, so an adaptive lane's sums are
//    those of the static lane of its form.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                   // threads of every block
constexpr int kPerThread = 4;                   // elements a thread, elementwise
constexpr int kTile = kThreads * kPerThread;    // elements a block, elementwise
constexpr int kCompactThreads = 1024;
constexpr int kMaxSmem = 232448;                // a block's shared memory, H100

// Per-lane solve state (mirrored by heatflow_tpu_torch/ops/cuda_sweep.py:
// k is int32 word 10 and done int32 word 11 of each 48-byte record).
struct LaneState {
  double rz, rr, stop2, alpha, beta;
  int k, done;
};

// Launch-count slots; the Kv-free forms of init and stencil_dot count apart.
enum Phase {
  kPhInit = 0, kPhStencilDot, kPhUpdate, kPhPcrR, kPhFinalize, kPhPUpdate,
  kPhCompact, kPhFinish, kPhInitNoKv, kPhStencilDotNoKv, kPhPcrZ,
  kPhMergedW, kPhMergedWNoKv, kPhFinalizeMerged, kPhPqUpdate,
  kNumPhases
};

enum FinalizeMode { kFinInit = 0, kFinAlpha = 1, kFinBeta = 2 };

// Partial-sum planes: 4 x B x nparts doubles.
enum Part { kPartPap = 0, kPartRr = 1, kPartRz = 2, kPartBb = 3 };

// Sum of v over the block; the result is valid in every thread.
__device__ double block_sum(double v) {
  __shared__ double warp_part[32];
  __shared__ double total;
  const int tid = threadIdx.x;
  __syncthreads();  // previous use of warp_part / total is finished
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) warp_part[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < (blockDim.x + 31) / 32; ++w) s += warp_part[w];
    total = s;
  }
  __syncthreads();
  return total;
}

// Coefficient c of the lane's operator: A0 + dk Kv, or A0 alone when the
// operator has no varying term (HAS_KV = false: the recording sweeps' mass
// projection, whose Kv operand is absent).
template <bool HAS_KV>
__device__ __forceinline__ float coef(const float* __restrict__ A0,
                                      const float* __restrict__ Kv, float dk,
                                      size_t c) {
  if constexpr (HAS_KV) return A0[c] + dk * Kv[c];
  return A0[c];
}

// ((A0 + dk Kv) (sm . v))[i, j] for the 7-point (or 9-point) stencil,
// neighbours outside the grid read as 0, in the offset order of
// heatflow_tpu_torch/ops/stencil.py (OFFSETS, then OFFSETS9's two). sm and v
// point at the lane's plane.
template <bool HAS_KV>
__device__ __forceinline__ float stencil_at(const float* __restrict__ A0,
                                            const float* __restrict__ Kv,
                                            int npts, float dk,
                                            const float* __restrict__ sm,
                                            const float* __restrict__ v,
                                            int i, int j, int nz, int nr) {
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)i * nr + j;
  float out = coef<HAS_KV>(A0, Kv, dk, idx) * (sm[idx] * v[idx]);
  const int di[8] = {1, -1, 0, 0, 1, -1, 1, -1};
  const int dj[8] = {0, 0, 1, -1, 1, -1, -1, 1};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= npts - 1) break;
    const int ii = i + di[k], jj = j + dj[k];
    if (ii >= 0 && ii < nz && jj >= 0 && jj < nr) {
      const size_t q = (size_t)ii * nr + jj;
      const size_t c = (size_t)(k + 1) * n + idx;
      out += coef<HAS_KV>(A0, Kv, dk, c) * (sm[q] * v[q]);
    }
  }
  return out;
}

// Columns of a ks_pcr_z tile: the widest power of two up to 32 whose six
// work arrays of nz floats fit in a block's shared memory (0: none fits).
int pcr_z_width(int nz) {
  for (int tw = 32; tw >= 1; tw >>= 1)
    if (6 * (size_t)nz * tw * sizeof(float) <= (size_t)kMaxSmem) return tw;
  return 0;
}

int z_tiles_of(int nz, int nr) {
  const int tw = pcr_z_width(nz);
  return tw ? (nr + tw - 1) / tw : 0;
}

// <r, z> partials a lane's scalar phase reads: one a grid row (r-line),
// max(rows, column tiles) in the ADI and adaptive forms, 0 when z is r.
int n_rz_of(int nz, int nr, int rline, int adi) {
  if (!rline) return 0;
  const int zt = z_tiles_of(nz, nr);
  return adi && zt > nz ? zt : nz;
}

struct Sweep {
  const float *A0, *Kv, *dks, *sm, *b, *x0, *rtol;   // Kv, dks: null if Kv-free
  float *x, *r, *z, *p, *Ap;
  double* parts;
  LaneState* st;
  int* lanes;   // lanes[y] is the lane that grid row y works on
  int npts, nz, nr, B, maxiter, wrt_r0, rline, fixed, nparts;
  size_t sm_stride;   // elements between two lanes' sm planes: n, or 0 (shared)
  long long* counts;
  cudaStream_t stream;
  const int* flags;   // adaptive: per-lane ADI flags (B int32), else null
  int adi;            // 0: no z phase; 1: every lane; 2: the flagged lanes
  int merged;         // the merged-dot recurrence
  float *q, *w;       // its A p and A u planes (B, Nz, Nr), else null

  size_t n() const { return (size_t)nz * nr; }
  int tiles() const { return (int)((n() + kTile - 1) / kTile); }
  double* part(int which) const {
    return parts + (size_t)which * B * nparts;
  }
  int n_rz() const { return n_rz_of(nz, nr, rline, adi); }
};

__device__ __forceinline__ size_t elem(int m) {
  return (size_t)blockIdx.x * kTile + (size_t)m * kThreads + threadIdx.x;
}

// x = x0, r = b - sm A_b (sm x0); partials of <r, r> and <b, b>. The lane's
// sm plane starts sm_stride elements after the previous lane's.
template <bool HAS_KV>
__global__ void ks_init(const float* __restrict__ A0,
                        const float* __restrict__ Kv, int npts,
                        const float* __restrict__ dks,
                        const float* __restrict__ sm, size_t sm_stride,
                        const float* __restrict__ b,
                        const float* __restrict__ x0, float* __restrict__ x,
                        float* __restrict__ r, double* part_rr,
                        double* part_bb, const int* __restrict__ lanes,
                        int nz, int nr, int nparts) {
  const int lane = lanes[blockIdx.y];
  const size_t n = (size_t)nz * nr;
  const size_t off = (size_t)lane * n;
  const float* sml = sm + (size_t)lane * sm_stride;
  const float dk = HAS_KV ? dks[lane] : 0.0f;
  double rr = 0.0, bb = 0.0;
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) {
      const int i = (int)(idx / nr), j = (int)(idx % nr);
      const float bv = b[off + idx];
      const float rv = bv - sml[idx] * stencil_at<HAS_KV>(A0, Kv, npts, dk,
                                                          sml, x0 + off, i, j,
                                                          nz, nr);
      x[off + idx] = x0[off + idx];
      r[off + idx] = rv;
      rr += (double)(rv * rv);
      bb += (double)(bv * bv);
    }
  }
  rr = block_sum(rr);
  bb = block_sum(bb);
  if (threadIdx.x == 0) {
    part_rr[(size_t)lane * nparts + blockIdx.x] = rr;
    part_bb[(size_t)lane * nparts + blockIdx.x] = bb;
  }
}

// Ap = sm A_b (sm p); partials of <p, Ap>.
template <bool HAS_KV>
__global__ void ks_stencil_dot(const float* __restrict__ A0,
                               const float* __restrict__ Kv, int npts,
                               const float* __restrict__ dks,
                               const float* __restrict__ sm, size_t sm_stride,
                               const float* __restrict__ p,
                               float* __restrict__ Ap, double* part,
                               const LaneState* st,
                               const int* __restrict__ lanes, int nz, int nr,
                               int nparts) {
  const int lane = lanes[blockIdx.y];
  if (st != nullptr && st[lane].done) return;
  const size_t n = (size_t)nz * nr;
  const size_t off = (size_t)lane * n;
  const float* sml = sm + (size_t)lane * sm_stride;
  const float dk = HAS_KV ? dks[lane] : 0.0f;
  double acc = 0.0;
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) {
      const int i = (int)(idx / nr), j = (int)(idx % nr);
      const float v = sml[idx] * stencil_at<HAS_KV>(A0, Kv, npts, dk, sml,
                                                    p + off, i, j, nz, nr);
      Ap[off + idx] = v;
      acc += (double)(p[off + idx] * v);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) part[(size_t)lane * nparts + blockIdx.x] = acc;
}

// x += alpha p, r -= alpha Ap; partials of <r, r>.
__global__ void ks_update(float* __restrict__ x, float* __restrict__ r,
                          const float* __restrict__ p,
                          const float* __restrict__ Ap, double* part_rr,
                          const LaneState* st, const int* __restrict__ lanes,
                          size_t n, int nparts) {
  const int lane = lanes[blockIdx.y];
  if (st[lane].done) return;
  const float alpha = (float)st[lane].alpha;
  const size_t off = (size_t)lane * n;
  double acc = 0.0;
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) {
      x[off + idx] = x[off + idx] + alpha * p[off + idx];
      const float rv = r[off + idx] - alpha * Ap[off + idx];
      r[off + idx] = rv;
      acc += (double)(rv * rv);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) part_rr[(size_t)lane * nparts + blockIdx.x] = acc;
}

// r-line PCR apply with the factorization done on the fly; one block per
// (grid row, lane). The row's couplings of the scaled operator,
//   u[j] = sm[j] (A0 + dk Kv)[3][j] sm[j+1],  l[j] = sm[j] (A0 + dk Kv)[4][j] sm[j-1]
// (zero past the row's ends), and the right-hand side d = r go to shared
// memory; level k (stride s = 2^k) of parallel cyclic reduction is
//   a = 1 - l[j] u[j-s] - u[j] l[j+s]
//   d'[j] = (d[j] - l[j] d[j-s] - u[j] d[j+s]) / a
//   l'[j] = -l[j] l[j-s] / a,   u'[j] = -u[j] u[j+s] / a,
// double buffered, until the stride covers the row; then
// z = d * free with free = (sm != 0), and the row's partial of <r, z>.
__global__ void ks_pcr_r(const float* __restrict__ A0,
                         const float* __restrict__ Kv,
                         const float* __restrict__ dks,
                         const float* __restrict__ sm, size_t sm_stride,
                         const float* __restrict__ r, float* __restrict__ z,
                         double* part_rz, int n_rz, const LaneState* st,
                         const int* __restrict__ lanes, int nz, int nr,
                         int nparts) {
  const int lane = lanes[blockIdx.y];
  if (st != nullptr && st[lane].done) return;
  extern __shared__ float rows[];
  float* d0 = rows;
  float* d1 = rows + nr;
  float* l0 = rows + 2 * nr;
  float* l1 = rows + 3 * nr;
  float* u0 = rows + 4 * nr;
  float* u1 = rows + 5 * nr;
  const size_t n = (size_t)nz * nr;
  const size_t row = (size_t)blockIdx.x * nr;
  const size_t off = (size_t)lane * n + row;
  const float dk = Kv != nullptr ? dks[lane] : 0.0f;
  const float* smr = sm + (size_t)lane * sm_stride + row;
  for (int j = threadIdx.x; j < nr; j += blockDim.x) {
    const float sj = smr[j];
    const float c_up = Kv != nullptr
                           ? A0[3 * n + row + j] + dk * Kv[3 * n + row + j]
                           : A0[3 * n + row + j];
    const float c_lo = Kv != nullptr
                           ? A0[4 * n + row + j] + dk * Kv[4 * n + row + j]
                           : A0[4 * n + row + j];
    u0[j] = j + 1 < nr ? sj * c_up * smr[j + 1] : 0.0f;
    l0[j] = j >= 1 ? sj * c_lo * smr[j - 1] : 0.0f;
    d0[j] = r[off + j];
  }
  __syncthreads();
  for (int s = 1; s < nr; s <<= 1) {
    for (int j = threadIdx.x; j < nr; j += blockDim.x) {
      const bool lo_in = j - s >= 0, up_in = j + s < nr;
      const float lj = l0[j], uj = u0[j];
      const float u_m = lo_in ? u0[j - s] : 0.0f;
      const float l_p = up_in ? l0[j + s] : 0.0f;
      const float d_m = lo_in ? d0[j - s] : 0.0f;
      const float d_p = up_in ? d0[j + s] : 0.0f;
      const float inv_a = 1.0f / (1.0f - lj * u_m - uj * l_p);
      d1[j] = (d0[j] - lj * d_m - uj * d_p) * inv_a;
      l1[j] = -lj * (lo_in ? l0[j - s] : 0.0f) * inv_a;
      u1[j] = -uj * (up_in ? u0[j + s] : 0.0f) * inv_a;
    }
    __syncthreads();
    float* t;
    t = d0; d0 = d1; d1 = t;
    t = l0; l0 = l1; l1 = t;
    t = u0; u0 = u1; u1 = t;
  }
  double acc = 0.0;
  for (int j = threadIdx.x; j < nr; j += blockDim.x) {
    const float fm = smr[j] != 0.0f ? 1.0f : 0.0f;
    const float zv = d0[j] * fm;
    z[off + j] = zv;
    acc += (double)(r[off + j] * zv);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    double* part = part_rz + (size_t)lane * nparts;
    part[blockIdx.x] = acc;
    for (int q = gridDim.x + blockIdx.x; q < n_rz; q += gridDim.x)
      part[q] = 0.0;
  }
}

// z-line PCR of the ADI form, z = R r + Z r - r, with the factorization
// done on the fly; one block per (tile of tw adjacent columns, lane). On
// entry z holds R r (ks_pcr_r). A thread takes column tx = threadIdx.x % tw
// of the tile and the rows ty, ty + blockDim.x / tw, ...; the column's
// couplings of the scaled operator,
//   u[i] = sm[i] (A0 + dk Kv)[1][i] sm[i+1],  l[i] = sm[i] (A0 + dk Kv)[2][i] sm[i-1]
// (zero past the column's ends; slots 1/2 are offsets (+1, 0) / (-1, 0)),
// and d = r go to shared memory, element (i, tx) at i * tw + tx, and the
// PCR levels run along i as in ks_pcr_r; then z = (R r + d - r) * free and
// the tile's partial of <r, z>. With flags (the adaptive form) a lane whose
// flag is 0 returns at once: its z stays R r.
__global__ void ks_pcr_z(const float* __restrict__ A0,
                         const float* __restrict__ Kv,
                         const float* __restrict__ dks,
                         const float* __restrict__ sm, size_t sm_stride,
                         const float* __restrict__ r, float* __restrict__ z,
                         double* part_rz, int n_rz, const LaneState* st,
                         const int* __restrict__ flags,
                         const int* __restrict__ lanes, int nz, int nr,
                         int nparts, int tw) {
  const int lane = lanes[blockIdx.y];
  if (st != nullptr && st[lane].done) return;
  if (flags != nullptr && flags[lane] == 0) return;
  extern __shared__ float cols[];
  const size_t m = (size_t)nz * tw;
  float* d0 = cols;
  float* d1 = cols + m;
  float* l0 = cols + 2 * m;
  float* l1 = cols + 3 * m;
  float* u0 = cols + 4 * m;
  float* u1 = cols + 5 * m;
  const size_t n = (size_t)nz * nr;
  const size_t off = (size_t)lane * n;
  const float dk = Kv != nullptr ? dks[lane] : 0.0f;
  const float* sml = sm + (size_t)lane * sm_stride;
  const int tx = threadIdx.x % tw, ty = threadIdx.x / tw;
  const int step = blockDim.x / tw;
  const int j = blockIdx.x * tw + tx;
  const bool col = j < nr;
  for (int i = ty; i < nz; i += step) {
    const int q = i * tw + tx;
    if (col) {
      const size_t idx = (size_t)i * nr + j;
      const float si = sml[idx];
      const float c_up = Kv != nullptr ? A0[n + idx] + dk * Kv[n + idx]
                                       : A0[n + idx];
      const float c_lo = Kv != nullptr
                             ? A0[2 * n + idx] + dk * Kv[2 * n + idx]
                             : A0[2 * n + idx];
      u0[q] = i + 1 < nz ? si * c_up * sml[idx + nr] : 0.0f;
      l0[q] = i >= 1 ? si * c_lo * sml[idx - nr] : 0.0f;
      d0[q] = r[off + idx];
    } else {
      u0[q] = 0.0f;
      l0[q] = 0.0f;
      d0[q] = 0.0f;
    }
  }
  __syncthreads();
  for (int s = 1; s < nz; s <<= 1) {
    const int ds = s * tw;
    for (int i = ty; i < nz; i += step) {
      const int q = i * tw + tx;
      const bool lo_in = i - s >= 0, up_in = i + s < nz;
      const float lj = l0[q], uj = u0[q];
      const float u_m = lo_in ? u0[q - ds] : 0.0f;
      const float l_p = up_in ? l0[q + ds] : 0.0f;
      const float d_m = lo_in ? d0[q - ds] : 0.0f;
      const float d_p = up_in ? d0[q + ds] : 0.0f;
      const float inv_a = 1.0f / (1.0f - lj * u_m - uj * l_p);
      d1[q] = (d0[q] - lj * d_m - uj * d_p) * inv_a;
      l1[q] = -lj * (lo_in ? l0[q - ds] : 0.0f) * inv_a;
      u1[q] = -uj * (up_in ? u0[q + ds] : 0.0f) * inv_a;
    }
    __syncthreads();
    float* t;
    t = d0; d0 = d1; d1 = t;
    t = l0; l0 = l1; l1 = t;
    t = u0; u0 = u1; u1 = t;
  }
  double acc = 0.0;
  if (col) {
    for (int i = ty; i < nz; i += step) {
      const size_t idx = (size_t)i * nr + j;
      const float fm = sml[idx] != 0.0f ? 1.0f : 0.0f;
      const float rv = r[off + idx];
      const float zv = (z[off + idx] + d0[i * tw + tx] - rv) * fm;
      z[off + idx] = zv;
      acc += (double)(rv * zv);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) {
    double* part = part_rz + (size_t)lane * nparts;
    part[blockIdx.x] = acc;
    for (int q = gridDim.x + blockIdx.x; q < n_rz; q += gridDim.x)
      part[q] = 0.0;
  }
}

// Reduce n partials in a fixed order (deterministic); valid in all threads.
__device__ double reduce_parts(const double* part, int n) {
  double s = 0.0;
  for (int t = threadIdx.x; t < n; t += blockDim.x) s += part[t];
  return block_sum(s);
}

// The CG scalars of one lane a block. Guards and stop rule of the TPU
// kernel: pAp == 0 -> 1, rz == 0 -> 1; rr is <r, r> when preconditioned and
// rz otherwise; the tolerance mode runs while k < maxiter && rr > stop2 (a
// NaN rr stops the lane), the fixed mode while k < maxiter. n_rz == 0 means
// z is r (identity form), so <r, z> = <r, r>.
__global__ void ks_finalize(LaneState* st, const double* parts, int B,
                            int nparts, int n_elem, int n_rz, int mode,
                            const float* __restrict__ rtol, int maxiter,
                            int wrt_r0, int fixed,
                            const int* __restrict__ lanes) {
  const int lane = lanes[blockIdx.x];
  LaneState* s = st + lane;
  if (mode != kFinInit && s->done) return;
  const size_t plane = (size_t)B * nparts;
  const double* base = parts + (size_t)lane * nparts;
  if (mode == kFinAlpha) {
    const double pap = reduce_parts(base + kPartPap * plane, n_elem);
    if (threadIdx.x == 0) s->alpha = s->rz / (pap != 0.0 ? pap : 1.0);
    return;
  }
  const double rr = reduce_parts(base + kPartRr * plane, n_elem);
  const double rz = n_rz > 0 ? reduce_parts(base + kPartRz * plane, n_rz)
                             : rr;
  if (mode == kFinInit) {
    const double bb = reduce_parts(base + kPartBb * plane, n_elem);
    if (threadIdx.x == 0) {
      const double rt = fixed ? 0.0 : (double)rtol[lane];
      s->rz = rz;
      s->rr = n_rz > 0 ? rr : rz;
      s->stop2 = rt * rt * (wrt_r0 ? s->rr : bb);
      s->alpha = 0.0;
      s->beta = 0.0;
      s->k = 0;
      s->done = fixed ? !(0 < maxiter) : !(0 < maxiter && s->rr > s->stop2);
    }
    return;
  }
  if (threadIdx.x == 0) {
    s->beta = rz / (s->rz != 0.0 ? s->rz : 1.0);
    s->rz = rz;
    s->rr = n_rz > 0 ? rr : rz;
    s->k += 1;
    s->done = fixed ? !(s->k < maxiter)
                    : !(s->k < maxiter && s->rr > s->stop2);
  }
}

// p = z + beta p (p = z on the first call).
__global__ void ks_p_update(float* __restrict__ p, const float* __restrict__ z,
                            const LaneState* st,
                            const int* __restrict__ lanes, int first,
                            size_t n) {
  const int lane = lanes[blockIdx.y];
  if (st[lane].done && !first) return;
  const float beta = (float)st[lane].beta;
  const size_t off = (size_t)lane * n;
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) {
      p[off + idx] = first ? z[off + idx] : z[off + idx] + beta * p[off + idx];
    }
  }
}

// Merged-dot pass: w = sm A_b (sm u) with the partials of delta = <w, u>
// (the pAp plane), <r, r> and gamma = <r, u> (the rz plane).
template <bool HAS_KV>
__global__ void ks_merged_w(const float* __restrict__ A0,
                            const float* __restrict__ Kv, int npts,
                            const float* __restrict__ dks,
                            const float* __restrict__ sm, size_t sm_stride,
                            const float* __restrict__ u,
                            const float* __restrict__ r,
                            float* __restrict__ w, double* part_delta,
                            double* part_rr, double* part_gamma,
                            const LaneState* st,
                            const int* __restrict__ lanes, int nz, int nr,
                            int nparts) {
  const int lane = lanes[blockIdx.y];
  if (st != nullptr && st[lane].done) return;
  const size_t n = (size_t)nz * nr;
  const size_t off = (size_t)lane * n;
  const float* sml = sm + (size_t)lane * sm_stride;
  const float dk = HAS_KV ? dks[lane] : 0.0f;
  double dl = 0.0, rr = 0.0, ga = 0.0;
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) {
      const int i = (int)(idx / nr), j = (int)(idx % nr);
      const float wv = sml[idx] * stencil_at<HAS_KV>(A0, Kv, npts, dk, sml,
                                                     u + off, i, j, nz, nr);
      const float uv = u[off + idx], rv = r[off + idx];
      w[off + idx] = wv;
      dl += (double)(wv * uv);
      rr += (double)(rv * rv);
      ga += (double)(rv * uv);
    }
  }
  dl = block_sum(dl);
  rr = block_sum(rr);
  ga = block_sum(ga);
  if (threadIdx.x == 0) {
    const size_t slot = (size_t)lane * nparts + blockIdx.x;
    part_delta[slot] = dl;
    part_rr[slot] = rr;
    part_gamma[slot] = ga;
  }
}

// The merged recurrence's scalars of one lane a block: gamma = <r, u> (kept
// in rz), delta = <w, u>, rr = <r, r> when preconditioned and gamma
// otherwise. First call: alpha = gamma / delta, the stop target and the
// first stop test on <r0, r0>; later: beta = gamma' / gamma,
// alpha' = gamma' / (delta - beta gamma' / alpha), each divisor 0 -> 1.
__global__ void ks_finalize_merged(LaneState* st, const double* parts, int B,
                                   int nparts, int n_elem, int preconditioned,
                                   int first, const float* __restrict__ rtol,
                                   int maxiter, int wrt_r0,
                                   const int* __restrict__ lanes) {
  const int lane = lanes[blockIdx.x];
  LaneState* s = st + lane;
  if (!first && s->done) return;
  const size_t plane = (size_t)B * nparts;
  const double* base = parts + (size_t)lane * nparts;
  const double delta = reduce_parts(base + kPartPap * plane, n_elem);
  const double rr = reduce_parts(base + kPartRr * plane, n_elem);
  const double gamma = reduce_parts(base + kPartRz * plane, n_elem);
  if (first) {
    const double bb = reduce_parts(base + kPartBb * plane, n_elem);
    if (threadIdx.x == 0) {
      const double rt = (double)rtol[lane];
      s->rz = gamma;
      s->rr = rr;
      s->stop2 = rt * rt * (wrt_r0 ? rr : bb);
      s->alpha = gamma / (delta != 0.0 ? delta : 1.0);
      s->beta = 0.0;
      s->k = 0;
      s->done = !(0 < maxiter && s->rr > s->stop2);
    }
    return;
  }
  if (threadIdx.x == 0) {
    const double beta = gamma / (s->rz != 0.0 ? s->rz : 1.0);
    const double denom =
        delta - beta * gamma / (s->alpha != 0.0 ? s->alpha : 1.0);
    s->alpha = gamma / (denom != 0.0 ? denom : 1.0);
    s->beta = beta;
    s->rz = gamma;
    s->rr = preconditioned ? rr : gamma;
    s->k += 1;
    s->done = !(s->k < maxiter && s->rr > s->stop2);
  }
}

// p = u + beta p, q = w + beta q (p = u, q = w on the first call).
__global__ void ks_pq_update(float* __restrict__ p, float* __restrict__ q,
                             const float* __restrict__ u,
                             const float* __restrict__ w, const LaneState* st,
                             const int* __restrict__ lanes, int first,
                             size_t n) {
  const int lane = lanes[blockIdx.y];
  if (st[lane].done && !first) return;
  const float beta = (float)st[lane].beta;
  const size_t off = (size_t)lane * n;
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) {
      p[off + idx] = first ? u[off + idx] : u[off + idx] + beta * p[off + idx];
      q[off + idx] = first ? w[off + idx] : w[off + idx] + beta * q[off + idx];
    }
  }
}

// The running lanes, in lane order, into lanes[0 .. count); one block.
__global__ void ks_compact(const LaneState* st, int B, int* lanes,
                           int* count) {
  __shared__ int warp_total[kCompactThreads / 32];
  __shared__ int base;
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int start = 0; start < B; start += blockDim.x) {
    const int lane = start + threadIdx.x;
    const bool run = lane < B && !st[lane].done;
    const unsigned ballot = __ballot_sync(0xffffffffu, run);
    if (l == 0) warp_total[w] = __popc(ballot);
    __syncthreads();
    int at = base + __popc(ballot & ((1u << l) - 1u));
    for (int q = 0; q < w; ++q) at += warp_total[q];
    if (run) lanes[at] = lane;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int q = 0; q < (int)(blockDim.x >> 5); ++q) base += warp_total[q];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = base;
}

// iters[lane] = k; in tolerance mode x = NaN over a lane whose residual is
// not finite. Grid (tiles, B), every lane.
__global__ void ks_finish(float* __restrict__ x, int* iters,
                          const LaneState* st, int poison, size_t n) {
  const int lane = blockIdx.y;
  if (blockIdx.x == 0 && threadIdx.x == 0) iters[lane] = st[lane].k;
  if (!poison || isfinite(st[lane].rr)) return;
  const size_t off = (size_t)lane * n;
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) x[off + idx] = nanf("");
  }
}

size_t pcr_smem(int nr) { return 6 * (size_t)nr * sizeof(float); }

int tiles_of(int nz, int nr) {
  return (int)(((size_t)nz * nr + kTile - 1) / kTile);
}

// One launcher per phase kernel, shared by the solves and by the
// single-phase entry points; each counts its launch. Kv == nullptr selects
// the Kv-free form of the kernels that read the operator.
cudaError_t launch_init(const float* A0, const float* Kv, int npts,
                        const float* dks, const float* sm, size_t sm_stride,
                        const float* b, const float* x0, float* x, float* r,
                        double* part_rr, double* part_bb, const int* lanes,
                        int n_lanes, int nz, int nr, int nparts,
                        long long* counts, cudaStream_t stream) {
  const dim3 grid(tiles_of(nz, nr), n_lanes);
  if (Kv != nullptr) {
    ks_init<true><<<grid, kThreads, 0, stream>>>(
        A0, Kv, npts, dks, sm, sm_stride, b, x0, x, r, part_rr, part_bb,
        lanes, nz, nr, nparts);
    counts[kPhInit] += 1;
  } else {
    ks_init<false><<<grid, kThreads, 0, stream>>>(
        A0, Kv, npts, dks, sm, sm_stride, b, x0, x, r, part_rr, part_bb,
        lanes, nz, nr, nparts);
    counts[kPhInitNoKv] += 1;
  }
  return cudaGetLastError();
}

cudaError_t launch_stencil_dot(const float* A0, const float* Kv, int npts,
                               const float* dks, const float* sm,
                               size_t sm_stride, const float* p, float* Ap,
                               double* part, const LaneState* st,
                               const int* lanes, int n_lanes, int nz, int nr,
                               int nparts, long long* counts,
                               cudaStream_t stream) {
  const dim3 grid(tiles_of(nz, nr), n_lanes);
  if (Kv != nullptr) {
    ks_stencil_dot<true><<<grid, kThreads, 0, stream>>>(
        A0, Kv, npts, dks, sm, sm_stride, p, Ap, part, st, lanes, nz, nr,
        nparts);
    counts[kPhStencilDot] += 1;
  } else {
    ks_stencil_dot<false><<<grid, kThreads, 0, stream>>>(
        A0, Kv, npts, dks, sm, sm_stride, p, Ap, part, st, lanes, nz, nr,
        nparts);
    counts[kPhStencilDotNoKv] += 1;
  }
  return cudaGetLastError();
}

cudaError_t launch_update(float* x, float* r, const float* p, const float* Ap,
                          double* part_rr, const LaneState* st,
                          const int* lanes, int n_lanes, int nz, int nr,
                          int nparts, long long* counts, cudaStream_t stream) {
  ks_update<<<dim3(tiles_of(nz, nr), n_lanes), kThreads, 0, stream>>>(
      x, r, p, Ap, part_rr, st, lanes, (size_t)nz * nr, nparts);
  counts[kPhUpdate] += 1;
  return cudaGetLastError();
}

cudaError_t launch_pcr_r(const float* A0, const float* Kv, const float* dks,
                         const float* sm, size_t sm_stride, const float* r,
                         float* z, double* part_rz, int n_rz,
                         const LaneState* st, const int* lanes, int n_lanes,
                         int nz, int nr, int nparts, long long* counts,
                         cudaStream_t stream) {
  const size_t smem = pcr_smem(nr);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)ks_pcr_r, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ks_pcr_r<<<dim3(nz, n_lanes), kThreads, smem, stream>>>(
      A0, Kv, dks, sm, sm_stride, r, z, part_rz, n_rz, st, lanes, nz, nr,
      nparts);
  counts[kPhPcrR] += 1;
  return cudaGetLastError();
}

cudaError_t launch_pcr_z(const float* A0, const float* Kv, const float* dks,
                         const float* sm, size_t sm_stride, const float* r,
                         float* z, double* part_rz, int n_rz,
                         const LaneState* st, const int* flags,
                         const int* lanes, int n_lanes, int nz, int nr,
                         int nparts, long long* counts, cudaStream_t stream) {
  const int tw = pcr_z_width(nz);
  if (tw == 0) return cudaErrorInvalidValue;
  const size_t smem = 6 * (size_t)nz * tw * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)ks_pcr_z, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  ks_pcr_z<<<dim3((nr + tw - 1) / tw, n_lanes), kThreads, smem, stream>>>(
      A0, Kv, dks, sm, sm_stride, r, z, part_rz, n_rz, st, flags, lanes, nz,
      nr, nparts, tw);
  counts[kPhPcrZ] += 1;
  return cudaGetLastError();
}

cudaError_t launch_finalize(LaneState* st, const double* parts, int B,
                            int nparts, int n_elem, int n_rz, int mode,
                            const float* rtol, int maxiter, int wrt_r0,
                            int fixed, const int* lanes, int n_lanes,
                            long long* counts, cudaStream_t stream) {
  ks_finalize<<<n_lanes, kThreads, 0, stream>>>(
      st, parts, B, nparts, n_elem, n_rz, mode, rtol, maxiter, wrt_r0, fixed,
      lanes);
  counts[kPhFinalize] += 1;
  return cudaGetLastError();
}

cudaError_t launch_p_update(float* p, const float* z, const LaneState* st,
                            const int* lanes, int first, int n_lanes, int nz,
                            int nr, long long* counts, cudaStream_t stream) {
  ks_p_update<<<dim3(tiles_of(nz, nr), n_lanes), kThreads, 0, stream>>>(
      p, z, st, lanes, first, (size_t)nz * nr);
  counts[kPhPUpdate] += 1;
  return cudaGetLastError();
}

cudaError_t launch_merged_w(const float* A0, const float* Kv, int npts,
                            const float* dks, const float* sm,
                            size_t sm_stride, const float* u, const float* r,
                            float* w, double* part_delta, double* part_rr,
                            double* part_gamma, const LaneState* st,
                            const int* lanes, int n_lanes, int nz, int nr,
                            int nparts, long long* counts,
                            cudaStream_t stream) {
  const dim3 grid(tiles_of(nz, nr), n_lanes);
  if (Kv != nullptr) {
    ks_merged_w<true><<<grid, kThreads, 0, stream>>>(
        A0, Kv, npts, dks, sm, sm_stride, u, r, w, part_delta, part_rr,
        part_gamma, st, lanes, nz, nr, nparts);
    counts[kPhMergedW] += 1;
  } else {
    ks_merged_w<false><<<grid, kThreads, 0, stream>>>(
        A0, Kv, npts, dks, sm, sm_stride, u, r, w, part_delta, part_rr,
        part_gamma, st, lanes, nz, nr, nparts);
    counts[kPhMergedWNoKv] += 1;
  }
  return cudaGetLastError();
}

cudaError_t launch_finalize_merged(LaneState* st, const double* parts, int B,
                                   int nparts, int n_elem, int preconditioned,
                                   int first, const float* rtol, int maxiter,
                                   int wrt_r0, const int* lanes, int n_lanes,
                                   long long* counts, cudaStream_t stream) {
  ks_finalize_merged<<<n_lanes, kThreads, 0, stream>>>(
      st, parts, B, nparts, n_elem, preconditioned, first, rtol, maxiter,
      wrt_r0, lanes);
  counts[kPhFinalizeMerged] += 1;
  return cudaGetLastError();
}

cudaError_t launch_pq_update(float* p, float* q, const float* u,
                             const float* w, const LaneState* st,
                             const int* lanes, int first, int n_lanes, int nz,
                             int nr, long long* counts, cudaStream_t stream) {
  ks_pq_update<<<dim3(tiles_of(nz, nr), n_lanes), kThreads, 0, stream>>>(
      p, q, u, w, st, lanes, first, (size_t)nz * nr);
  counts[kPhPqUpdate] += 1;
  return cudaGetLastError();
}

// z = M^-1 r with the <r, z> partials: the r-line solve, then in the ADI
// and adaptive forms the z-line phase (every lane, or the flagged ones);
// identity: z is r.
cudaError_t precondition(const Sweep& s, int n_lanes) {
  if (!s.rline) return cudaSuccess;
  cudaError_t e = launch_pcr_r(s.A0, s.Kv, s.dks, s.sm, s.sm_stride, s.r,
                               s.z, s.part(kPartRz), s.n_rz(), s.st, s.lanes,
                               n_lanes, s.nz, s.nr, s.nparts, s.counts,
                               s.stream);
  if (e != cudaSuccess || !s.adi) return e;
  return launch_pcr_z(s.A0, s.Kv, s.dks, s.sm, s.sm_stride, s.r, s.z,
                      s.part(kPartRz), s.n_rz(), s.st,
                      s.adi == 2 ? s.flags : nullptr, s.lanes, n_lanes, s.nz,
                      s.nr, s.nparts, s.counts, s.stream);
}

cudaError_t finalize(const Sweep& s, int mode, int n_lanes) {
  return launch_finalize(s.st, s.parts, s.B, s.nparts, s.tiles(), s.n_rz(),
                         mode, s.rtol, s.maxiter, s.wrt_r0, s.fixed, s.lanes,
                         n_lanes, s.counts, s.stream);
}

// The merged-dot tail of a step: w = A u with gamma, delta and <r, r>, the
// scalars, then p and q.
cudaError_t merged_tail(const Sweep& s, int first, int n_lanes) {
  cudaError_t e;
  if ((e = launch_merged_w(s.A0, s.Kv, s.npts, s.dks, s.sm, s.sm_stride, s.z,
                           s.r, s.w, s.part(kPartPap), s.part(kPartRr),
                           s.part(kPartRz), s.st, s.lanes, n_lanes, s.nz,
                           s.nr, s.nparts, s.counts, s.stream))
      != cudaSuccess)
    return e;
  if ((e = launch_finalize_merged(s.st, s.parts, s.B, s.nparts, s.tiles(),
                                  s.rline, first, s.rtol, s.maxiter, s.wrt_r0,
                                  s.lanes, n_lanes, s.counts, s.stream))
      != cudaSuccess)
    return e;
  return launch_pq_update(s.p, s.q, s.z, s.w, s.st, s.lanes, first, n_lanes,
                          s.nz, s.nr, s.counts, s.stream);
}

cudaError_t start(const Sweep& s) {
  cudaError_t e = cudaMemsetAsync(s.st, 0, (size_t)s.B * sizeof(LaneState),
                                  s.stream);
  if (e != cudaSuccess) return e;
  if ((e = launch_init(s.A0, s.Kv, s.npts, s.dks, s.sm, s.sm_stride, s.b,
                       s.x0, s.x, s.r, s.part(kPartRr), s.part(kPartBb),
                       s.lanes, s.B, s.nz, s.nr, s.nparts, s.counts,
                       s.stream)) != cudaSuccess)
    return e;
  if ((e = precondition(s, s.B)) != cudaSuccess) return e;
  if (s.merged) return merged_tail(s, 1, s.B);
  if ((e = finalize(s, kFinInit, s.B)) != cudaSuccess) return e;
  return launch_p_update(s.p, s.z, s.st, s.lanes, 1, s.B, s.nz, s.nr,
                         s.counts, s.stream);
}

cudaError_t iterate(const Sweep& s, int n_lanes) {
  cudaError_t e;
  if (s.merged) {
    // x += alpha p, r -= alpha q; u = M^-1 r; then the merged tail
    if ((e = launch_update(s.x, s.r, s.p, s.q, s.part(kPartRr), s.st, s.lanes,
                           n_lanes, s.nz, s.nr, s.nparts, s.counts, s.stream))
        != cudaSuccess)
      return e;
    if ((e = precondition(s, n_lanes)) != cudaSuccess) return e;
    return merged_tail(s, 0, n_lanes);
  }
  if ((e = launch_stencil_dot(s.A0, s.Kv, s.npts, s.dks, s.sm, s.sm_stride,
                              s.p, s.Ap, s.part(kPartPap), s.st, s.lanes,
                              n_lanes, s.nz, s.nr, s.nparts, s.counts,
                              s.stream))
      != cudaSuccess)
    return e;
  if ((e = finalize(s, kFinAlpha, n_lanes)) != cudaSuccess) return e;
  if ((e = launch_update(s.x, s.r, s.p, s.Ap, s.part(kPartRr), s.st, s.lanes,
                         n_lanes, s.nz, s.nr, s.nparts, s.counts, s.stream))
      != cudaSuccess)
    return e;
  if ((e = precondition(s, n_lanes)) != cudaSuccess) return e;
  if ((e = finalize(s, kFinBeta, n_lanes)) != cudaSuccess) return e;
  return launch_p_update(s.p, s.z, s.st, s.lanes, 0, n_lanes, s.nz, s.nr,
                         s.counts, s.stream);
}

}  // namespace

// ---------------------------------------------------------------------
// C interface (bound with ctypes by heatflow_tpu_torch/ops/cuda_sweep.py).
// Every entry returns a cudaError_t code, 0 on success. Pointers are
// device pointers; `stream` is the caller's cudaStream_t. Every per-lane
// array is (B, Nz, Nr), contiguous; `lanes` holds B int32.
// ---------------------------------------------------------------------

#define HF_SWEEP_ARGS                                                        \
  const float *A0, const float *Kv, int npts, const float *dks,              \
      const float *sm, int sm_lane, const float *b, const float *x0,        \
      const float *rtol, float *x, float *r, float *z, float *p, float *Ap,  \
      double *parts,                                                         \
      int nparts, void *state, int *lanes, int B, int nz, int nr,            \
      int maxiter, int wrt_r0, int rline, int fixed, int adi,                \
      const int *flags, long long *counts, void *stream, int merged,         \
      float *q, float *w

#define HF_SWEEP_INIT                                                        \
  Sweep s{A0, Kv, dks, sm, b, x0, rtol, x, r, z, p, Ap, parts,               \
          (LaneState *)state, lanes, npts, nz, nr, B, maxiter, wrt_r0,       \
          rline, fixed, nparts, sm_lane ? (size_t)nz * nr : 0, counts,       \
          (cudaStream_t)stream, flags, adi, merged, q, w}

extern "C" {

// Partial sums a lane needs per kind: one per elementwise block, one per
// grid row (r-line PCR), one per column tile (z-line PCR).
int hf_sweep_tiles(int nz, int nr) { return tiles_of(nz, nr); }

int hf_sweep_z_tiles(int nz, int nr) { return z_tiles_of(nz, nr); }

int hf_sweep_nparts(int nz, int nr) {
  int n = hf_sweep_tiles(nz, nr);
  if (nz > n) n = nz;
  const int zt = z_tiles_of(nz, nr);
  return zt > n ? zt : n;
}

// <r, z> partials the scalar phase reads in a solve (see n_rz_of).
int hf_sweep_n_rz(int nz, int nr, int rline, int adi) {
  return n_rz_of(nz, nr, rline, adi);
}

int hf_sweep_state_bytes() { return (int)sizeof(LaneState); }

int hf_sweep_num_phases() { return kNumPhases; }

// Every lane: x = x0, initial residual, preconditioned residual, scalars,
// p = z. `lanes` must hold 0 .. B-1.
int hf_sweep_start(HF_SWEEP_ARGS) {
  HF_SWEEP_INIT;
  return (int)start(s);
}

// Enqueue n_iter CG iterations over the first n_lanes entries of `lanes`;
// each phase is a no-op for a lane once its done flag is set.
int hf_sweep_iterate(HF_SWEEP_ARGS, int n_iter, int n_lanes) {
  HF_SWEEP_INIT;
  for (int it = 0; it < n_iter; ++it) {
    cudaError_t e = iterate(s, n_lanes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// lanes[0 .. *count) = the lanes whose done flag is clear, in order.
int hf_sweep_compact(void *state, int B, int *lanes, int *count,
                     long long *counts, void *stream) {
  ks_compact<<<1, kCompactThreads, 0, (cudaStream_t)stream>>>(
      (const LaneState *)state, B, lanes, count);
  counts[kPhCompact] += 1;
  return (int)cudaGetLastError();
}

int hf_sweep_finish(float *x, int *iters, void *state, int B, int nz, int nr,
                    int poison, long long *counts, void *stream) {
  ks_finish<<<dim3(hf_sweep_tiles(nz, nr), B), kThreads, 0,
              (cudaStream_t)stream>>>(x, iters, (const LaneState *)state,
                                      poison, (size_t)nz * nr);
  counts[kPhFinish] += 1;
  return (int)cudaGetLastError();
}

// Single phases over the first n_lanes entries of `lanes`, for checking
// each kernel against its plain version. sm_lane = 1: sm holds one plane a
// lane; 0: one plane shared by every lane. Kv = dks = null: the Kv-free
// form. `state` holds B LaneState records
// (the scalars a phase reads: alpha for update, beta for p_update, and the
// solve state for finalize); stencil_dot and pcr_r read none (every lane
// runs). `part` is one partial-sum plane of B x nparts doubles, `parts`
// four (pAp, rr, rz, bb).
int hf_sweep_init(const float *A0, const float *Kv, int npts,
                  const float *dks, const float *sm, int sm_lane,
                  const float *b, const float *x0, float *x, float *r,
                  double *part_rr, double *part_bb, const int *lanes,
                  int n_lanes, int nz, int nr, int nparts, long long *counts,
                  void *stream) {
  return (int)launch_init(A0, Kv, npts, dks, sm,
                          sm_lane ? (size_t)nz * nr : 0, b, x0, x, r,
                          part_rr, part_bb, lanes, n_lanes, nz, nr, nparts,
                          counts, (cudaStream_t)stream);
}

int hf_sweep_stencil_dot(const float *A0, const float *Kv, int npts,
                         const float *dks, const float *sm, int sm_lane,
                         const float *p, float *Ap, double *part,
                         const int *lanes, int n_lanes, int nz, int nr,
                         int nparts, long long *counts, void *stream) {
  return (int)launch_stencil_dot(A0, Kv, npts, dks, sm,
                                 sm_lane ? (size_t)nz * nr : 0, p, Ap, part,
                                 nullptr, lanes, n_lanes, nz, nr, nparts,
                                 counts, (cudaStream_t)stream);
}

int hf_sweep_update(float *x, float *r, const float *p, const float *Ap,
                    double *part, const void *state, const int *lanes,
                    int n_lanes, int nz, int nr, int nparts,
                    long long *counts, void *stream) {
  return (int)launch_update(x, r, p, Ap, part, (const LaneState *)state,
                            lanes, n_lanes, nz, nr, nparts, counts,
                            (cudaStream_t)stream);
}

int hf_sweep_pcr_r(const float *A0, const float *Kv, const float *dks,
                   const float *sm, int sm_lane, const float *r, float *z,
                   double *part, const int *lanes, int n_lanes, int nz,
                   int nr, int nparts, long long *counts, void *stream) {
  return (int)launch_pcr_r(A0, Kv, dks, sm, sm_lane ? (size_t)nz * nr : 0, r,
                           z, part, nz, nullptr, lanes, n_lanes, nz, nr,
                           nparts, counts, (cudaStream_t)stream);
}

// The z-line phase alone: z holds R r on entry and z = R r + Z r - r on
// exit; one <r, z> partial a column tile (hf_sweep_z_tiles of them).
int hf_sweep_pcr_z(const float *A0, const float *Kv, const float *dks,
                   const float *sm, int sm_lane, const float *r, float *z,
                   double *part, const int *lanes, int n_lanes, int nz,
                   int nr, int nparts, long long *counts, void *stream) {
  return (int)launch_pcr_z(A0, Kv, dks, sm, sm_lane ? (size_t)nz * nr : 0, r,
                           z, part, z_tiles_of(nz, nr), nullptr, nullptr,
                           lanes, n_lanes, nz, nr, nparts, counts,
                           (cudaStream_t)stream);
}

// mode 0: the first step's scalars; 1: alpha; 2: beta and the stop test.
// n_elem partials of pAp, rr and bb a lane, n_rz of rz (0: z is r).
int hf_sweep_finalize(void *state, const double *parts, int B, int nparts,
                      int n_elem, int n_rz, int mode, const float *rtol,
                      int maxiter, int wrt_r0, int fixed, const int *lanes,
                      int n_lanes, long long *counts, void *stream) {
  return (int)launch_finalize((LaneState *)state, parts, B, nparts, n_elem,
                              n_rz, mode, rtol, maxiter, wrt_r0, fixed, lanes,
                              n_lanes, counts, (cudaStream_t)stream);
}

int hf_sweep_p_update(float *p, const float *z, const void *state,
                      const int *lanes, int first, int n_lanes, int nz,
                      int nr, long long *counts, void *stream) {
  return (int)launch_p_update(p, z, (const LaneState *)state, lanes, first,
                              n_lanes, nz, nr, counts, (cudaStream_t)stream);
}

// The merged-dot pass alone: w = sm A_b (sm u); `parts` is three planes of
// B x nparts doubles (delta, <r, r>, gamma).
int hf_sweep_merged_w(const float *A0, const float *Kv, int npts,
                      const float *dks, const float *sm, int sm_lane,
                      const float *u, const float *r, float *w, double *parts,
                      const int *lanes, int n_lanes, int B, int nz, int nr,
                      int nparts, long long *counts, void *stream) {
  const size_t plane = (size_t)B * nparts;
  return (int)launch_merged_w(A0, Kv, npts, dks, sm,
                              sm_lane ? (size_t)nz * nr : 0, u, r, w, parts,
                              parts + plane, parts + 2 * plane, nullptr,
                              lanes, n_lanes, nz, nr, nparts, counts,
                              (cudaStream_t)stream);
}

// The merged recurrence's scalar phase alone; `parts` four planes (delta,
// rr, gamma, bb), n_elem partials of each a lane.
int hf_sweep_finalize_merged(void *state, const double *parts, int B,
                             int nparts, int n_elem, int preconditioned,
                             int first, const float *rtol, int maxiter,
                             int wrt_r0, const int *lanes, int n_lanes,
                             long long *counts, void *stream) {
  return (int)launch_finalize_merged((LaneState *)state, parts, B, nparts,
                                     n_elem, preconditioned, first, rtol,
                                     maxiter, wrt_r0, lanes, n_lanes, counts,
                                     (cudaStream_t)stream);
}

// p = u + beta p, q = w + beta q in place, beta from each lane's state.
int hf_sweep_pq_update(float *p, float *q, const float *u, const float *w,
                       const void *state, const int *lanes, int n_lanes,
                       int nz, int nr, long long *counts, void *stream) {
  return (int)launch_pq_update(p, q, u, w, (const LaneState *)state, lanes, 0,
                               n_lanes, nz, nr, counts, (cudaStream_t)stream);
}

}  // extern "C"
