// Tolerance-stopped preconditioned CG on the on-the-fly scaled stencil
// operator sm * A * (sm * y), for one (Nz, Nr) problem in float32.
//
// Replaces: heatflow_tpu/ops/pallas_cg.py:_cg_tol_kernel (the Pallas TPU
// kernel that keeps the whole solve resident in VMEM), in its identity,
// r-line PCR, split-additive ADI (r-line + z-line PCR), Chebyshev-polynomial
// and z-semicoarsened two-level multigrid (mgz) forms, with the standard
// recurrence or the Chronopoulos-Gear merged-dot recurrence.
//
// What bounds it on an H100: memory latency and launches, not arithmetic.
// At the flagship shape (251 x 1107 = 277,857 nodes, one f32 plane is
// 1.11 MB) one r-line iteration moves about 45 planes (~50 MB): the 7
// stencil planes, ~15 vector planes (p, Ap, x, r, z, sm and their re-reads)
// and the 23-plane folded r-line PCR stack, ~15 us at the HBM roofline.
// The ADI form adds the 17-plane z-line stack. The working set (~40 MB
// r-line, ~59 MB ADI) is about the size of the 50 MB L2, and no block can
// hold it: shared memory is 227 KB a block. Each iteration costs 5-7
// kernel launches. Measured on an H100 80GB HBM3 at 700 W: an r-line
// iteration takes ~59 us of kernel time, 28 us of it in k_pcr_r, whose
// 11 levels each wait on two dependent global-row loads.
//
// What the design does about that: one kernel per CG phase, each a single
// coalesced pass over its planes, so the traffic is the planes' size and
// nothing more; the PCR levels of a whole line run in shared memory (one
// r-line of 1107 values, or a tile of 16 z-lines of 251 values, double
// buffered), so a PCR apply reads each factor plane once and never writes
// an intermediate level to device memory. The CG scalars and the stop flag
// stay in device memory: every phase kernel returns at once when the flag
// is set, so the host launches blocks of iterations and reads the flag
// only between blocks — no host round trip per iteration. Partial sums are
// reduced in a fixed order in double, so a solve is deterministic.
// Fusing phases, a CUDA graph or a persistent kernel are the next steps.
//
// The further forms reuse those phases. Chebyshev: each polynomial step is
// one pass (k_cheb_step) that reads z's neighbours from one plane and writes
// the new z into a second one, so no block reads a value another block is
// rewriting; the step coefficients come from the device scalar lmax inside
// the kernel, so no solve waits on a host read. mgz: one V(1,1) cycle is 7
// launches (9 with two coarse sweeps): the damped r-line solve (k_pcr_row,
// the row kernel with a scale, an optional plane to add to and an optional
// restriction fused into its load), the fine residual (k_residual), the
// restriction and coarse line solve in one pass, the embedded 9-point coarse
// residual (k_coarse_res) between coarse sweeps, the prolongation
// (k_prolong), the second residual and the post-smooth with the <r, z>
// partials. Merged-dot: the vectors q = A p and w = A u are kept, gamma,
// delta and <r, r> are taken in the one pass that forms w (k_merged_w), one
// scalar kernel forms beta and the coupled alpha (k_finalize_merged), and
// one pass updates p and q (k_pq_update): 4 launches an identity iteration
// against 5, at one more plane of traffic.
//
// Also replaces heatflow_tpu/ops/pallas_mg.py:_mgcg_kernel (the whole
// multigrid-preconditioned solve in one TPU kernel) and
// heatflow_tpu/ops/pallas_cg.py:_cg_kernel (the fixed-count unpreconditioned
// CG on a baked operator). The first is one more preconditioner of the same
// solve loop: a V-cycle over baked level operators (7 planes on the finest
// level, 9 on the Galerkin coarse ones), each level smoothed by a Chebyshev
// polynomial in D^-1 C whose coefficients the host computes once, with
// bilinear factor-2 transfers on the odd-padded grids of the TPU scheme. The
// TPU kernel moves data between levels with reshapes and transposes because
// its compiler has no gathers; here a restriction is one thread per coarse
// point that gathers its nine fine residuals in a fixed order (no atomics,
// so a cycle is repeatable bitwise) and a prolongation one thread per fine
// point. A smoothing step reads its iterate's neighbours from one plane and
// writes the next iterate into another, like k_cheb_step. One cycle of four
// levels with 2 + 2 smoothing steps and 10 on the last level is 31 launches;
// the coarse levels (18 k and 4.7 k points on the flagship) are bound by
// launch latency, not traffic: one kernel for the lower levels is the next
// step. The second is the standard loop with the stop test switched off
// (`fixed`), sm = 1 and no preconditioner: no host read during the solve.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // elementwise and finalize blocks
constexpr int kTileCols = 16;   // z-line PCR: columns per block
constexpr int kTileRows = 16;   // z-line PCR: thread rows per block

// Solve state kept in device memory (mirrored by the Python wrapper:
// k is int32 word 10 and done is int32 word 11 of the 64-byte buffer).
struct CGState {
  double rz, rr, stop2, alpha, beta;
  int k, done;
};

enum Phase {
  kPhInit = 0, kPhStencilDot, kPhUpdate, kPhPcrR, kPhPcrZ, kPhFinalize,
  kPhPUpdate, kPhFinish, kPhChebInit, kPhChebStep, kPhMergedW,
  kPhFinalizeMerged, kPhPqUpdate, kPhResidual, kPhPcrRow, kPhCoarseRes,
  kPhProlong, kPhMgCheb, kPhMgResidual, kPhMgRestrict, kPhMgProlong,
  kNumPhases
};

enum FinalizeMode { kFinInit = 0, kFinAlpha = 1, kFinBeta = 2 };

// Sum of v over the block; the result is valid in every thread.
__device__ double block_sum(double v) {
  __shared__ double warp_part[32];
  __shared__ double total;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  __syncthreads();  // previous use of warp_part / total is finished
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((tid & 31) == 0) warp_part[tid >> 5] = v;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < (nthreads + 31) / 32; ++w) s += warp_part[w];
    total = s;
  }
  __syncthreads();
  return total;
}

// (A (sm . v))[i, j] for the 7-point (or 9-point) stencil, neighbours
// outside the grid read as 0. The accumulation order follows the offsets
// of heatflow_tpu_torch/ops/stencil.py: OFFSETS, then OFFSETS9's two.
__device__ __forceinline__ float stencil_at(const float* __restrict__ A,
                                            int npts,
                                            const float* __restrict__ sm,
                                            const float* __restrict__ v,
                                            int i, int j, int nz, int nr) {
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)i * nr + j;
  float out = A[idx] * (sm[idx] * v[idx]);
  const int di[8] = {1, -1, 0, 0, 1, -1, 1, -1};
  const int dj[8] = {0, 0, 1, -1, 1, -1, -1, 1};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= npts - 1) break;
    const int ii = i + di[k], jj = j + dj[k];
    if (ii >= 0 && ii < nz && jj >= 0 && jj < nr) {
      const size_t q = (size_t)ii * nr + jj;
      out += A[(size_t)(k + 1) * n + idx] * (sm[q] * v[q]);
    }
  }
  return out;
}

// (C v)[i, j] for a baked 7-point (or 9-point) level operator of the
// multigrid cycle: no scaling, the same accumulation order.
__device__ __forceinline__ float level_stencil_at(const float* __restrict__ C,
                                                  int npts,
                                                  const float* __restrict__ v,
                                                  int i, int j, int nz,
                                                  int nr) {
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)i * nr + j;
  float out = C[idx] * v[idx];
  const int di[8] = {1, -1, 0, 0, 1, -1, 1, -1};
  const int dj[8] = {0, 0, 1, -1, 1, -1, -1, 1};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= npts - 1) break;
    const int ii = i + di[k], jj = j + dj[k];
    if (ii >= 0 && ii < nz && jj >= 0 && jj < nr)
      out += C[(size_t)(k + 1) * n + idx] * v[(size_t)ii * nr + jj];
  }
  return out;
}

// x = x0, r = b - sm A (sm x0); partials of <r, r> and <b, b>.
__global__ void k_init(const float* __restrict__ A, int npts,
                       const float* __restrict__ sm,
                       const float* __restrict__ b,
                       const float* __restrict__ x0, float* __restrict__ x,
                       float* __restrict__ r, double* part_rr,
                       double* part_bb, int nz, int nr) {
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  double rr = 0.0, bb = 0.0;
  if (idx < n) {
    const int i = (int)(idx / nr), j = (int)(idx % nr);
    const float bv = b[idx];
    const float rv = bv - sm[idx] * stencil_at(A, npts, sm, x0, i, j, nz, nr);
    x[idx] = x0[idx];
    r[idx] = rv;
    rr = (double)(rv * rv);
    bb = (double)(bv * bv);
  }
  rr = block_sum(rr);
  bb = block_sum(bb);
  if (threadIdx.x == 0) {
    part_rr[blockIdx.x] = rr;
    part_bb[blockIdx.x] = bb;
  }
}

// Ap = sm A (sm p); partials of <p, Ap>.
__global__ void k_stencil_dot(const float* __restrict__ A, int npts,
                              const float* __restrict__ sm,
                              const float* __restrict__ p,
                              float* __restrict__ Ap, double* part,
                              const CGState* st, int nz, int nr) {
  if (st != nullptr && st->done) return;
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  double acc = 0.0;
  if (idx < n) {
    const int i = (int)(idx / nr), j = (int)(idx % nr);
    const float v = sm[idx] * stencil_at(A, npts, sm, p, i, j, nz, nr);
    Ap[idx] = v;
    acc = (double)(p[idx] * v);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

// x += alpha p, r -= alpha Ap; partials of <r, r>.
__global__ void k_update(float* __restrict__ x, float* __restrict__ r,
                         const float* __restrict__ p,
                         const float* __restrict__ Ap, double* part_rr,
                         const CGState* st, int n) {
  if (st->done) return;
  const float alpha = (float)st->alpha;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  double acc = 0.0;
  if (idx < n) {
    x[idx] = x[idx] + alpha * p[idx];
    const float rv = r[idx] - alpha * Ap[idx];
    r[idx] = rv;
    acc = (double)(rv * rv);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) part_rr[blockIdx.x] = acc;
}

// r-line PCR apply, one block per z-row. The row sits in shared memory,
// double buffered; level k (stride s = 2^k) is
//   d[j] <- d[j] - F[2k][j] d[j-s] - F[2k+1][j] d[j+s]   (zeros outside),
// then z = F[2L] d * free with free = (sm != 0). Optionally writes the
// row's partial of <r, z>.
__global__ void k_pcr_r(const float* __restrict__ r,
                        const float* __restrict__ sm,
                        const float* __restrict__ F, int levels,
                        float* __restrict__ z, double* part_rz,
                        int write_partial, const CGState* st, int nz,
                        int nr) {
  if (st != nullptr && st->done) return;
  extern __shared__ float line[];
  float* d0 = line;
  float* d1 = line + nr;
  const size_t n = (size_t)nz * nr;
  const size_t row = (size_t)blockIdx.x * nr;
  for (int j = threadIdx.x; j < nr; j += blockDim.x) d0[j] = r[row + j];
  __syncthreads();
  int s = 1;
  for (int k = 0; k < levels; ++k) {
    const float* lo = F + (size_t)(2 * k) * n + row;
    const float* up = F + (size_t)(2 * k + 1) * n + row;
    for (int j = threadIdx.x; j < nr; j += blockDim.x) {
      float v = d0[j];
      if (j - s >= 0) v = v - lo[j] * d0[j - s];
      if (j + s < nr) v = v - up[j] * d0[j + s];
      d1[j] = v;
    }
    __syncthreads();
    float* t = d0; d0 = d1; d1 = t;
    s <<= 1;
  }
  const float* g = F + (size_t)(2 * levels) * n + row;
  double acc = 0.0;
  for (int j = threadIdx.x; j < nr; j += blockDim.x) {
    const float fm = sm[row + j] != 0.0f ? 1.0f : 0.0f;
    const float zv = g[j] * d0[j] * fm;
    z[row + j] = zv;
    acc += (double)(r[row + j] * zv);
  }
  if (write_partial) {
    acc = block_sum(acc);
    if (threadIdx.x == 0) part_rz[blockIdx.x] = acc;
  }
}

// z-line PCR apply and the ADI combine, one block per tile of kTileCols
// adjacent columns x all Nz rows (rows loaded coalesced along r). On entry
// z holds the r-line result R r * free; on exit
//   z = (R r + Z r - r) * free
// and the tile's partial of <r, z> is written.
__global__ void k_pcr_z(const float* __restrict__ r,
                        const float* __restrict__ sm,
                        const float* __restrict__ F, int levels,
                        float* __restrict__ z, double* part_rz,
                        const CGState* st, int nz, int nr) {
  if (st != nullptr && st->done) return;
  extern __shared__ float tile[];
  float* d0 = tile;
  float* d1 = tile + (size_t)nz * kTileCols;
  const size_t n = (size_t)nz * nr;
  const int tx = threadIdx.x;
  const int c = blockIdx.x * kTileCols + tx;
  const bool valid = c < nr;
  for (int i = threadIdx.y; i < nz; i += blockDim.y)
    d0[i * kTileCols + tx] = valid ? r[(size_t)i * nr + c] : 0.0f;
  __syncthreads();
  int s = 1;
  for (int k = 0; k < levels; ++k) {
    const float* lo = F + (size_t)(2 * k) * n;
    const float* up = F + (size_t)(2 * k + 1) * n;
    for (int i = threadIdx.y; i < nz; i += blockDim.y) {
      if (valid) {
        const size_t q = (size_t)i * nr + c;
        float v = d0[i * kTileCols + tx];
        if (i - s >= 0) v = v - lo[q] * d0[(i - s) * kTileCols + tx];
        if (i + s < nz) v = v - up[q] * d0[(i + s) * kTileCols + tx];
        d1[i * kTileCols + tx] = v;
      }
    }
    __syncthreads();
    float* t = d0; d0 = d1; d1 = t;
    s <<= 1;
  }
  const float* g = F + (size_t)(2 * levels) * n;
  double acc = 0.0;
  for (int i = threadIdx.y; i < nz; i += blockDim.y) {
    if (valid) {
      const size_t q = (size_t)i * nr + c;
      const float fm = sm[q] != 0.0f ? 1.0f : 0.0f;
      const float rv = r[q];
      const float zv = (z[q] + g[q] * d0[i * kTileCols + tx] - rv) * fm;
      z[q] = zv;
      acc += (double)(rv * zv);
    }
  }
  acc = block_sum(acc);
  if (tx == 0 && threadIdx.y == 0) part_rz[blockIdx.x] = acc;
}

// out = r - sm A (sm v): the fine residual of the mgz cycle.
__global__ void k_residual(const float* __restrict__ A, int npts,
                           const float* __restrict__ sm,
                           const float* __restrict__ r,
                           const float* __restrict__ v,
                           float* __restrict__ out, const CGState* st, int nz,
                           int nr) {
  if (st != nullptr && st->done) return;
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int i = (int)(idx / nr), j = (int)(idx % nr);
  out[idx] = r[idx] - sm[idx] * stencil_at(A, npts, sm, v, i, j, nz, nr);
}

// The Chebyshev polynomial's target interval [0.08, 1.05] lmax in the TPU
// kernel's float32 arithmetic: theta, delta, and the coefficients of step
// `step` (0-based) of d = c1 d + c2 res.
struct ChebCoef { float theta, c1, c2; };

__device__ __forceinline__ ChebCoef cheb_coef(float lmax, int step) {
  const float lo = 0.08f * lmax, hi = 1.05f * lmax;
  const float theta = 0.5f * (hi + lo), delta = 0.5f * (hi - lo);
  const float sigma = theta / delta;
  float rho = 1.0f / sigma, c1 = 0.0f, c2 = 0.0f;
  for (int t = 0; t <= step; ++t) {
    const float rho_new = 1.0f / (2.0f * sigma - rho);
    c1 = rho_new * rho;
    c2 = 2.0f * rho_new / delta;
    rho = rho_new;
  }
  return {theta, c1, c2};
}

// d = r / theta, z = d; optionally the partials of <r, z>.
__global__ void k_cheb_init(const float* __restrict__ r,
                            const float* __restrict__ lmax,
                            float* __restrict__ d, float* __restrict__ z,
                            double* part_rz, int write_partial,
                            const CGState* st, int n) {
  if (st != nullptr && st->done) return;
  const float theta = cheb_coef(lmax[0], -1).theta;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  double acc = 0.0;
  if (idx < n) {
    const float rv = r[idx];
    const float dv = rv / theta;
    d[idx] = dv;
    z[idx] = dv;
    acc = (double)(rv * dv);
  }
  if (write_partial) {
    acc = block_sum(acc);
    if (threadIdx.x == 0) part_rz[blockIdx.x] = acc;
  }
}

// One polynomial step: res = r - sm A (sm z_in), d = c1 d + c2 res,
// z_out = z_in + d. z_out is another plane than z_in: the stencil reads
// z_in's neighbours while other blocks write z_out.
__global__ void k_cheb_step(const float* __restrict__ A, int npts,
                            const float* __restrict__ sm,
                            const float* __restrict__ r,
                            const float* __restrict__ z_in,
                            float* __restrict__ d, float* __restrict__ z_out,
                            const float* __restrict__ lmax, int step,
                            double* part_rz, int write_partial,
                            const CGState* st, int nz, int nr) {
  if (st != nullptr && st->done) return;
  const ChebCoef c = cheb_coef(lmax[0], step);
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  double acc = 0.0;
  if (idx < n) {
    const int i = (int)(idx / nr), j = (int)(idx % nr);
    const float rv = r[idx];
    const float res = rv - sm[idx] * stencil_at(A, npts, sm, z_in, i, j, nz,
                                                nr);
    const float dv = c.c1 * d[idx] + c.c2 * res;
    const float zv = z_in[idx] + dv;
    d[idx] = dv;
    z_out[idx] = zv;
    acc = (double)(rv * zv);
  }
  if (write_partial) {
    acc = block_sum(acc);
    if (threadIdx.x == 0) part_rz[blockIdx.x] = acc;
  }
}

// Merged-dot pass: w = sm A (sm u) with the partials of delta = <w, u>,
// <r, r> and gamma = <r, u>, all on freshly produced data.
__global__ void k_merged_w(const float* __restrict__ A, int npts,
                           const float* __restrict__ sm,
                           const float* __restrict__ u,
                           const float* __restrict__ r, float* __restrict__ w,
                           double* part_delta, double* part_rr,
                           double* part_gamma, const CGState* st, int nz,
                           int nr) {
  if (st != nullptr && st->done) return;
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  double dl = 0.0, rr = 0.0, ga = 0.0;
  if (idx < n) {
    const int i = (int)(idx / nr), j = (int)(idx % nr);
    const float wv = sm[idx] * stencil_at(A, npts, sm, u, i, j, nz, nr);
    const float uv = u[idx], rv = r[idx];
    w[idx] = wv;
    dl = (double)(wv * uv);
    rr = (double)(rv * rv);
    ga = (double)(rv * uv);
  }
  dl = block_sum(dl);
  rr = block_sum(rr);
  ga = block_sum(ga);
  if (threadIdx.x == 0) {
    part_delta[blockIdx.x] = dl;
    part_rr[blockIdx.x] = rr;
    part_gamma[blockIdx.x] = ga;
  }
}

// p = u + beta p, q = w + beta q (p = u, q = w on the first call).
__global__ void k_pq_update(float* __restrict__ p, float* __restrict__ q,
                            const float* __restrict__ u,
                            const float* __restrict__ w, const CGState* st,
                            int first, int n) {
  if (st->done && !first) return;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  if (first) {
    p[idx] = u[idx];
    q[idx] = w[idx];
  } else {
    const float beta = (float)st->beta;
    p[idx] = u[idx] + beta * p[idx];
    q[idx] = w[idx] + beta * q[idx];
  }
}

// The row kernel of the mgz cycle, one block per z-row: the folded r-line
// PCR levels of stack F on the row d, then
//   out = (acc + scale * F[2L] d) * mask
// with acc and mask optional (mask = (sm != 0)), and optionally the row's
// partial of <dot, out>. The row d is src's row, or, with aux (the planes
// sc, pm, pp, e_free), the scaled restriction of src onto the embedded
// coarse rows,
//   d = sc (e_free src[i] + (pp src)[i-1] + (pm src)[i+1])   (0 past the ends),
// which is also written to store when that is given.
__global__ void k_pcr_row(const float* __restrict__ src,
                          const float* __restrict__ aux, float* store,
                          const float* __restrict__ F, int levels, float scale,
                          const float* acc_in, const float* __restrict__ sm,
                          float* out, const float* __restrict__ dot,
                          double* part, const CGState* st, int nz, int nr) {
  if (st != nullptr && st->done) return;
  extern __shared__ float line[];
  float* d0 = line;
  float* d1 = line + nr;
  const size_t n = (size_t)nz * nr;
  const int i = blockIdx.x;
  const size_t row = (size_t)i * nr;
  for (int j = threadIdx.x; j < nr; j += blockDim.x) {
    float v;
    if (aux != nullptr) {
      const float* sc = aux;
      const float* pm = aux + n;
      const float* pp = aux + 2 * n;
      const float* ef = aux + 3 * n;
      float rc = ef[row + j] * src[row + j];
      rc += i >= 1 ? pp[row - nr + j] * src[row - nr + j] : 0.0f;
      rc += i + 1 < nz ? pm[row + nr + j] * src[row + nr + j] : 0.0f;
      v = sc[row + j] * rc;
      if (store != nullptr) store[row + j] = v;
    } else {
      v = src[row + j];
    }
    d0[j] = v;
  }
  __syncthreads();
  int s = 1;
  for (int k = 0; k < levels; ++k) {
    const float* lo = F + (size_t)(2 * k) * n + row;
    const float* up = F + (size_t)(2 * k + 1) * n + row;
    for (int j = threadIdx.x; j < nr; j += blockDim.x) {
      float v = d0[j];
      if (j - s >= 0) v = v - lo[j] * d0[j - s];
      if (j + s < nr) v = v - up[j] * d0[j + s];
      d1[j] = v;
    }
    __syncthreads();
    float* t = d0; d0 = d1; d1 = t;
    s <<= 1;
  }
  const float* g = F + (size_t)(2 * levels) * n + row;
  double a = 0.0;
  for (int j = threadIdx.x; j < nr; j += blockDim.x) {
    float v = scale * (g[j] * d0[j]);
    if (acc_in != nullptr) v = acc_in[row + j] + v;
    if (sm != nullptr) v = v * (sm[row + j] != 0.0f ? 1.0f : 0.0f);
    out[row + j] = v;
    if (dot != nullptr) a += (double)(dot[row + j] * v);
  }
  if (dot != nullptr) {
    a = block_sum(a);
    if (threadIdx.x == 0) part[blockIdx.x] = a;
  }
}

// out = rcs - Ac9 y: the residual of the scaled embedded coarse operator,
// a 9-point stencil whose z-offsets are +-2 fine rows (the plane order of
// heatflow_tpu_torch/ops/mgz.py: MGZ_OFFSETS), zeros outside the grid.
__global__ void k_coarse_res(const float* __restrict__ Ac9,
                             const float* __restrict__ rcs,
                             const float* __restrict__ y,
                             float* __restrict__ out, const CGState* st,
                             int nz, int nr) {
  if (st != nullptr && st->done) return;
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int i = (int)(idx / nr), j = (int)(idx % nr);
  const int di[8] = {2, -2, 0, 0, 2, -2, 2, -2};
  const int dj[8] = {0, 0, 1, -1, 1, -1, -1, 1};
  float acc = Ac9[idx] * y[idx];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ii = i + di[k], jj = j + dj[k];
    if (ii >= 0 && ii < nz && jj >= 0 && jj < nr)
      acc += Ac9[(size_t)(k + 1) * n + idx] * y[(size_t)ii * nr + jj];
  }
  out[idx] = rcs[idx] - acc;
}

// Prolongation of the coarse correction xc = sc y into x, in place:
//   x += e_free xc[i] + pm xc[i-1] + pp xc[i+1]   (0 past the ends).
__global__ void k_prolong(float* __restrict__ x, const float* __restrict__ y,
                          const float* __restrict__ aux, const CGState* st,
                          int nz, int nr) {
  if (st != nullptr && st->done) return;
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int i = (int)(idx / nr);
  const float* sc = aux;
  const float* pm = aux + n;
  const float* pp = aux + 2 * n;
  const float* ef = aux + 3 * n;
  float v = x[idx] + ef[idx] * (sc[idx] * y[idx]);
  v += pm[idx] * (i >= 1 ? sc[idx - nr] * y[idx - nr] : 0.0f);
  v += pp[idx] * (i + 1 < nz ? sc[idx + nr] * y[idx + nr] : 0.0f);
  x[idx] = v;
}

// One Chebyshev smoothing step on D^-1 C of a multigrid level, for the
// right-hand side b: res = b - C x_in (b itself when x_in is null: the
// iterate starts at zero), dinv = 1 / diag(C) (1 where the diagonal is 0),
//   first step:  d = dinv res / theta
//   later steps: d = c1 d + c2 (dinv res)
// x_out = x_in + d, another plane than x_in (the stencil reads x_in's
// neighbours while other blocks write x_out). With `mask` (the CG scaling
// plane sm) the result is multiplied by (sm > 0); with `dot` the block's
// partial of <dot, x_out> is written.
__global__ void k_mg_cheb(const float* __restrict__ C, int npts,
                          const float* __restrict__ b, const float* x_in,
                          float* __restrict__ d, float* x_out, int first,
                          float theta, float c1, float c2,
                          const float* __restrict__ mask,
                          const float* __restrict__ dot, double* part,
                          const CGState* st, int nz, int nr) {
  if (st != nullptr && st->done) return;
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  double acc = 0.0;
  if (idx < n) {
    const int i = (int)(idx / nr), j = (int)(idx % nr);
    const float diag = C[idx];
    const float dinv = diag != 0.0f ? 1.0f / diag : 1.0f;
    float xv = 0.0f, res = b[idx];
    if (x_in != nullptr) {
      xv = x_in[idx];
      res = res - level_stencil_at(C, npts, x_in, i, j, nz, nr);
    }
    const float dv = first ? dinv * res / theta
                           : c1 * d[idx] + c2 * (dinv * res);
    float xo = xv + dv;
    if (mask != nullptr) xo = xo * (mask[idx] > 0.0f ? 1.0f : 0.0f);
    d[idx] = dv;
    x_out[idx] = xo;
    if (dot != nullptr) acc = (double)(dot[idx] * xo);
  }
  if (dot != nullptr) {
    acc = block_sum(acc);
    if (threadIdx.x == 0) part[blockIdx.x] = acc;
  }
}

// out = b - C x on a multigrid level.
__global__ void k_mg_residual(const float* __restrict__ C, int npts,
                              const float* __restrict__ b,
                              const float* __restrict__ x,
                              float* __restrict__ out, const CGState* st,
                              int nz, int nr) {
  if (st != nullptr && st->done) return;
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int i = (int)(idx / nr), j = (int)(idx % nr);
  out[idx] = b[idx] - level_stencil_at(C, npts, x, i, j, nz, nr);
}

// Restriction (the transpose of the bilinear prolongation) of a fine field
// (nz, nr), both odd, onto the (cz, cr) plane of the next level, one thread
// a coarse point: along z then along r, coarse i takes fine 2i, w[i] of
// fine 2i+1 and (1 - w[i-1]) of fine 2i-1, summed in that order. Points
// past the coarse grid ((nz+1)/2, (nr+1)/2), the next level's odd padding,
// get 0.
__global__ void k_mg_restrict(const float* __restrict__ v,
                              const float* __restrict__ wz,
                              const float* __restrict__ wr,
                              float* __restrict__ out, const CGState* st,
                              int nz, int nr, int cz, int cr) {
  if (st != nullptr && st->done) return;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= cz * cr) return;
  const int I = idx / cr, J = idx % cr;
  const int mz = (nz + 1) / 2, mr = (nr + 1) / 2;
  if (I >= mz || J >= mr) {
    out[idx] = 0.0f;
    return;
  }
  const float wz_lo = I < mz - 1 ? wz[I] : 0.0f;
  const float wz_hi = I >= 1 ? 1.0f - wz[I - 1] : 0.0f;
  float cols[3] = {0.0f, 0.0f, 0.0f};   // z-restricted columns 2J-1, 2J, 2J+1
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int jf = 2 * J - 1 + c;
    if (jf < 0 || jf >= nr) continue;
    float s = v[(size_t)(2 * I) * nr + jf];
    if (I < mz - 1) s += wz_lo * v[(size_t)(2 * I + 1) * nr + jf];
    if (I >= 1) s += wz_hi * v[(size_t)(2 * I - 1) * nr + jf];
    cols[c] = s;
  }
  float s = cols[1];
  if (J < mr - 1) s += wr[J] * cols[2];
  if (J >= 1) s += (1.0f - wr[J - 1]) * cols[0];
  out[idx] = s;
}

// x += P xc in place: the bilinear prolongation of the coarse correction
// (its leading ((nz+1)/2, (nr+1)/2) part; rows are `cstride` apart), one
// thread a fine point: along r then along z, fine 2i+1 takes w[i] of
// coarse i and (1 - w[i]) of coarse i+1.
__global__ void k_mg_prolong(float* __restrict__ x,
                             const float* __restrict__ xc,
                             const float* __restrict__ wz,
                             const float* __restrict__ wr, const CGState* st,
                             int nz, int nr, int cstride) {
  if (st != nullptr && st->done) return;
  const size_t n = (size_t)nz * nr;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int i = (int)(idx / nr), j = (int)(idx % nr);
  const int I = i >> 1, J = j >> 1;
  float rows[2] = {0.0f, 0.0f};   // r-prolonged coarse rows I and I+1
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    if (c == 1 && !(i & 1)) break;
    const float* row = xc + (size_t)(I + c) * cstride;
    rows[c] = (j & 1) ? wr[J] * row[J] + (1.0f - wr[J]) * row[J + 1]
                      : row[J];
  }
  const float add = (i & 1) ? wz[I] * rows[0] + (1.0f - wz[I]) * rows[1]
                            : rows[0];
  x[idx] = x[idx] + add;
}

// Reduce n partials in a fixed order (deterministic); valid in all threads.
__device__ double reduce_parts(const double* part, int n) {
  double s = 0.0;
  for (int t = threadIdx.x; t < n; t += blockDim.x) s += part[t];
  return block_sum(s);
}

// The CG scalars, in one block. Guards and stop rule of the TPU kernel:
// pAp == 0 -> 1, rz == 0 -> 1; rr is <r, r> when preconditioned and rz
// otherwise; the loop runs while k < maxiter && rr > stop2 (a NaN rr stops
// it). n_rz == 0 means z is r (identity form), so <r, z> = <r, r>. With
// `fixed` the stop test is off and the loop runs maxiter iterations.
__global__ void k_finalize(CGState* st, const double* part_pap,
                           const double* part_rr, const double* part_rz,
                           const double* part_bb, int n_elem, int n_rz,
                           int mode, const float* rtol, int maxiter,
                           int wrt_r0, int fixed) {
  if (mode != kFinInit && st->done) return;
  if (mode == kFinAlpha) {
    const double pap = reduce_parts(part_pap, n_elem);
    if (threadIdx.x == 0) st->alpha = st->rz / (pap != 0.0 ? pap : 1.0);
    return;
  }
  const double rr = reduce_parts(part_rr, n_elem);
  const double rz = n_rz > 0 ? reduce_parts(part_rz, n_rz) : rr;
  if (mode == kFinInit) {
    const double bb = reduce_parts(part_bb, n_elem);
    if (threadIdx.x == 0) {
      const double rt = (double)rtol[0];
      st->rz = rz;
      st->rr = rr;
      st->stop2 = rt * rt * (wrt_r0 ? rr : bb);
      st->alpha = 0.0;
      st->beta = 0.0;
      st->k = 0;
      st->done = !(0 < maxiter && (fixed || st->rr > st->stop2));
    }
    return;
  }
  if (threadIdx.x == 0) {
    st->beta = rz / (st->rz != 0.0 ? st->rz : 1.0);
    st->rz = rz;
    st->rr = n_rz > 0 ? rr : rz;
    st->k += 1;
    st->done = !(st->k < maxiter && (fixed || st->rr > st->stop2));
  }
}

// The scalars of the merged-dot recurrence, in one block: gamma = <r, u>
// (kept in st->rz), delta = <w, u>, rr = <r, r> when preconditioned and
// gamma otherwise; first call: alpha = gamma / delta, the stop target and
// the first stop test on <r0, r0>; later calls: beta = gamma' / gamma,
// alpha' = gamma' / (delta - beta gamma' / alpha), each divisor 0 -> 1.
__global__ void k_finalize_merged(CGState* st, const double* part_delta,
                                  const double* part_rr,
                                  const double* part_gamma,
                                  const double* part_bb, int n_elem,
                                  int preconditioned, int first,
                                  const float* rtol, int maxiter,
                                  int wrt_r0) {
  if (!first && st->done) return;
  const double delta = reduce_parts(part_delta, n_elem);
  const double rr = reduce_parts(part_rr, n_elem);
  const double gamma = reduce_parts(part_gamma, n_elem);
  if (first) {
    const double bb = reduce_parts(part_bb, n_elem);
    if (threadIdx.x == 0) {
      const double rt = (double)rtol[0];
      st->rz = gamma;
      st->rr = rr;
      st->stop2 = rt * rt * (wrt_r0 ? rr : bb);
      st->alpha = gamma / (delta != 0.0 ? delta : 1.0);
      st->beta = 0.0;
      st->k = 0;
      st->done = !(0 < maxiter && st->rr > st->stop2);
    }
    return;
  }
  if (threadIdx.x == 0) {
    const double beta = gamma / (st->rz != 0.0 ? st->rz : 1.0);
    const double denom =
        delta - beta * gamma / (st->alpha != 0.0 ? st->alpha : 1.0);
    st->alpha = gamma / (denom != 0.0 ? denom : 1.0);
    st->beta = beta;
    st->rz = gamma;
    st->rr = preconditioned ? rr : gamma;
    st->k += 1;
    st->done = !(st->k < maxiter && st->rr > st->stop2);
  }
}

// p = z + beta p (p = z on the first call).
__global__ void k_p_update(float* __restrict__ p, const float* __restrict__ z,
                           const CGState* st, int first, int n) {
  if (st->done && !first) return;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  if (first) {
    p[idx] = z[idx];
  } else {
    const float beta = (float)st->beta;
    p[idx] = z[idx] + beta * p[idx];
  }
}

// x = NaN everywhere when the residual is not finite; iters = k.
__global__ void k_finish(float* __restrict__ x, int* iters,
                         const CGState* st, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx == 0) iters[0] = st->k;
  if (idx < n && !isfinite(st->rr)) x[idx] = nanf("");
}

// The multigrid V-cycle's levels, finest first, built by the Python wrapper
// (heatflow_tpu_torch/ops/cuda_mg.py mirrors both records with ctypes) in
// host memory: device pointers, shapes, and the Chebyshev coefficients the
// host computed in float32 from each level's eigenvalue bound (c1[k], c2[k]
// belong to step k + 1). wz (nz/2) and wr (nr/2) are the transfer weights
// between this level and the next; b, xa, xb, d and res are scratch planes
// of the level's shape (level 0 needs no b: its right-hand side is the CG
// residual).
constexpr int kMaxLevels = 8;
constexpr int kMaxCheb = 32;

struct MGLevel {
  const float *C, *wz, *wr;
  float *b, *xa, *xb, *d, *res;
  int npts, nz, nr;
  float theta;
  float c1[kMaxCheb], c2[kMaxCheb];
};

struct MGDesc {
  int n_levels, nu, nu_coarse, reserved;
  MGLevel lv[kMaxLevels];
};

struct Solve {
  const float *A, *sm, *b, *x0, *rtol, *pcr, *pcrz;
  float *x, *r, *z, *p, *Ap;
  double* parts;   // 4 x nparts: pAp (delta), rr, rz (gamma), bb
  CGState* st;
  int npts, lr, lz, nz, nr, maxiter, wrt_r0, nparts;
  long long* counts;
  cudaStream_t stream;
  // the further forms (see hf_cg_extra_planes for the layout of `extra`)
  const float* lmax;   // Chebyshev: device scalar, the bound on lambda_max
  int cheb, merged;    // polynomial degree (0: none); merged-dot recurrence
  const float *ac9, *pcrc, *aux;   // mgz operands (ac9 null: one sweep)
  int lc, sweeps;
  float omega, omega_c;
  float* extra;
  const MGDesc* mgd;         // the multigrid V-cycle's levels (host memory)
  int fixed;                 // run maxiter iterations, no stop test

  int n() const { return nz * nr; }
  int elem_blocks() const { return (n() + kThreads - 1) / kThreads; }
  int col_tiles() const { return (nr + kTileCols - 1) / kTileCols; }
  double* part(int which) const { return parts + (size_t)which * nparts; }
  bool rline() const { return pcr != nullptr; }
  bool adi() const { return pcrz != nullptr; }
  bool mgz() const { return pcrc != nullptr; }
  bool preconditioned() const { return rline() || cheb > 0 || mgd; }
  int n_rz() const {
    return mgd ? elem_blocks() : mgz() ? nz : adi() ? col_tiles() : rline() ? nz
           : cheb > 0 ? elem_blocks() : 0;
  }
  float* plane(int k) const { return extra + (size_t)k * n(); }
  // planes of `extra`, in order: merged (q, w), Chebyshev (d, z2), mgz
  // (r1, yc, rcs, res)
  float* q() const { return plane(0); }
  float* w() const { return plane(1); }
  float* cheb_d() const { return plane(merged ? 2 : 0); }
  float* cheb_z2() const { return plane(merged ? 3 : 1); }
  float* mg(int k) const { return plane(k); }
  // the plane that holds M^-1 r after precondition(): z, or the second
  // Chebyshev plane after an odd number of polynomial steps
  float* zout() const {
    return cheb > 0 && ((cheb - 1) & 1) ? cheb_z2() : z;
  }
};

size_t pcr_r_smem(int nr) { return 2 * (size_t)nr * sizeof(float); }
size_t pcr_z_smem(int nz) {
  return 2 * (size_t)nz * kTileCols * sizeof(float);
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t launch_pcr_r(const float* r, const float* sm, const float* F,
                         int levels, float* z, double* part_rz,
                         int write_partial, const CGState* st, int nz, int nr,
                         long long* counts, cudaStream_t stream) {
  const size_t smem = pcr_r_smem(nr);
  cudaError_t e = set_smem((const void*)k_pcr_r, smem);
  if (e != cudaSuccess) return e;
  k_pcr_r<<<nz, kThreads, smem, stream>>>(r, sm, F, levels, z, part_rz,
                                          write_partial, st, nz, nr);
  counts[kPhPcrR] += 1;
  return cudaGetLastError();
}

cudaError_t launch_pcr_z(const float* r, const float* sm, const float* F,
                         int levels, float* z, double* part_rz,
                         const CGState* st, int nz, int nr,
                         long long* counts, cudaStream_t stream) {
  const size_t smem = pcr_z_smem(nz);
  cudaError_t e = set_smem((const void*)k_pcr_z, smem);
  if (e != cudaSuccess) return e;
  const dim3 block(kTileCols, kTileRows);
  const int tiles = (nr + kTileCols - 1) / kTileCols;
  k_pcr_z<<<tiles, block, smem, stream>>>(r, sm, F, levels, z, part_rz, st,
                                          nz, nr);
  counts[kPhPcrZ] += 1;
  return cudaGetLastError();
}

cudaError_t launch_pcr_row(const float* src, const float* aux, float* store,
                           const float* F, int levels, float scale,
                           const float* acc, const float* sm, float* out,
                           const float* dot, double* part, const CGState* st,
                           int nz, int nr, long long* counts,
                           cudaStream_t stream) {
  const size_t smem = pcr_r_smem(nr);
  cudaError_t e = set_smem((const void*)k_pcr_row, smem);
  if (e != cudaSuccess) return e;
  k_pcr_row<<<nz, kThreads, smem, stream>>>(src, aux, store, F, levels, scale,
                                            acc, sm, out, dot, part, st, nz,
                                            nr);
  counts[kPhPcrRow] += 1;
  return cudaGetLastError();
}

cudaError_t launch_residual(const float* A, int npts, const float* sm,
                            const float* r, const float* v, float* out,
                            const CGState* st, int nz, int nr,
                            long long* counts, cudaStream_t stream) {
  const int blocks = (nz * nr + kThreads - 1) / kThreads;
  k_residual<<<blocks, kThreads, 0, stream>>>(A, npts, sm, r, v, out, st, nz,
                                              nr);
  counts[kPhResidual] += 1;
  return cudaGetLastError();
}

cudaError_t launch_coarse_res(const float* ac9, const float* rcs,
                              const float* y, float* out, const CGState* st,
                              int nz, int nr, long long* counts,
                              cudaStream_t stream) {
  const int blocks = (nz * nr + kThreads - 1) / kThreads;
  k_coarse_res<<<blocks, kThreads, 0, stream>>>(ac9, rcs, y, out, st, nz, nr);
  counts[kPhCoarseRes] += 1;
  return cudaGetLastError();
}

cudaError_t launch_prolong(float* x, const float* y, const float* aux,
                           const CGState* st, int nz, int nr,
                           long long* counts, cudaStream_t stream) {
  const int blocks = (nz * nr + kThreads - 1) / kThreads;
  k_prolong<<<blocks, kThreads, 0, stream>>>(x, y, aux, st, nz, nr);
  counts[kPhProlong] += 1;
  return cudaGetLastError();
}

// The mgz V(1,1) cycle: z = M^-1 r with the <r, z> partials (one a row).
cudaError_t precondition_mgz(const Solve& s, const float* r, float* z,
                             const CGState* st) {
  float *r1 = s.mg(0), *yc = s.mg(1), *rcs = s.mg(2), *res = s.mg(3);
  cudaError_t e;
#define HF_TRY(call) if ((e = (call)) != cudaSuccess) return e
  // pre-smooth from zero: one damped fine r-line solve
  HF_TRY(launch_pcr_row(r, nullptr, nullptr, s.pcr, s.lr, s.omega, nullptr,
                        nullptr, z, nullptr, nullptr, st, s.nz, s.nr,
                        s.counts, s.stream));
  HF_TRY(launch_residual(s.A, s.npts, s.sm, r, z, r1, st, s.nz, s.nr,
                         s.counts, s.stream));
  // restriction, scaling and the first coarse line solve, from zero
  HF_TRY(launch_pcr_row(r1, s.aux, s.sweeps > 1 ? rcs : nullptr, s.pcrc, s.lc,
                        s.omega_c, nullptr, nullptr, yc, nullptr, nullptr, st,
                        s.nz, s.nr, s.counts, s.stream));
  for (int k = 1; k < s.sweeps; ++k) {
    HF_TRY(launch_coarse_res(s.ac9, rcs, yc, res, st, s.nz, s.nr, s.counts,
                             s.stream));
    HF_TRY(launch_pcr_row(res, nullptr, nullptr, s.pcrc, s.lc, s.omega_c, yc,
                          nullptr, yc, nullptr, nullptr, st, s.nz, s.nr,
                          s.counts, s.stream));
  }
  HF_TRY(launch_prolong(z, yc, s.aux, st, s.nz, s.nr, s.counts, s.stream));
  HF_TRY(launch_residual(s.A, s.npts, s.sm, r, z, r1, st, s.nz, s.nr,
                         s.counts, s.stream));
  // post-smooth, the free mask and the <r, z> partials
  return launch_pcr_row(r1, nullptr, nullptr, s.pcr, s.lr, s.omega, z, s.sm,
                        z, r, s.part(2), st, s.nz, s.nr, s.counts, s.stream);
#undef HF_TRY
}

// The Chebyshev polynomial: the result lands in s.zout().
cudaError_t precondition_cheb(const Solve& s, const float* r,
                              const CGState* st) {
  float* d = s.cheb_d();
  float* zin = s.z;
  float* zalt = s.cheb_z2();
  k_cheb_init<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
      r, s.lmax, d, zin, s.part(2), s.cheb == 1, st, s.n());
  s.counts[kPhChebInit] += 1;
  cudaError_t e = cudaGetLastError();
  for (int k = 0; k < s.cheb - 1 && e == cudaSuccess; ++k) {
    k_cheb_step<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
        s.A, s.npts, s.sm, r, zin, d, zalt, s.lmax, k, s.part(2),
        k == s.cheb - 2, st, s.nz, s.nr);
    s.counts[kPhChebStep] += 1;
    e = cudaGetLastError();
    float* t = zin; zin = zalt; zalt = t;
  }
  return e;
}

cudaError_t mg_check(const MGDesc* mg) {
  if (mg->n_levels < 1 || mg->n_levels > kMaxLevels || mg->nu < 1 ||
      mg->nu > kMaxCheb || mg->nu_coarse < 1 || mg->nu_coarse > kMaxCheb)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// `degree` Chebyshev steps on level L for the right-hand side b, from x_in
// (null: from zero), alternating between the level's planes xa and xb (the
// first step from zero writes xa); the last step applies `mask` and writes
// the <dot, x> partials when given. *result is the plane of the last iterate.
cudaError_t mg_smooth(const MGLevel& L, const float* b, const float* x_in,
                      int degree, const float* mask, const float* dot,
                      double* part, const CGState* st, long long* counts,
                      cudaStream_t stream, float** result) {
  const int blocks = (L.nz * L.nr + kThreads - 1) / kThreads;
  const float* cur = x_in;
  float* nxt = x_in == L.xa ? L.xb : L.xa;
  for (int k = 0; k < degree; ++k) {
    const bool last = k == degree - 1;
    k_mg_cheb<<<blocks, kThreads, 0, stream>>>(
        L.C, L.npts, b, cur, L.d, nxt, k == 0, L.theta,
        k ? L.c1[k - 1] : 0.0f, k ? L.c2[k - 1] : 0.0f,
        last ? mask : nullptr, last ? dot : nullptr, part, st, L.nz, L.nr);
    counts[kPhMgCheb] += 1;
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    cur = nxt;
    nxt = nxt == L.xa ? L.xb : L.xa;
  }
  *result = const_cast<float*>(cur);
  return cudaSuccess;
}

cudaError_t launch_mg_residual(const float* C, int npts, const float* b,
                               const float* x, float* out, const CGState* st,
                               int nz, int nr, long long* counts,
                               cudaStream_t stream) {
  const int blocks = (nz * nr + kThreads - 1) / kThreads;
  k_mg_residual<<<blocks, kThreads, 0, stream>>>(C, npts, b, x, out, st, nz,
                                                 nr);
  counts[kPhMgResidual] += 1;
  return cudaGetLastError();
}

cudaError_t launch_mg_restrict(const float* v, const float* wz,
                               const float* wr, float* out, const CGState* st,
                               int nz, int nr, int cz, int cr,
                               long long* counts, cudaStream_t stream) {
  if (!(nz & 1) || !(nr & 1) || cz < (nz + 1) / 2 || cr < (nr + 1) / 2)
    return cudaErrorInvalidValue;
  const int blocks = (cz * cr + kThreads - 1) / kThreads;
  k_mg_restrict<<<blocks, kThreads, 0, stream>>>(v, wz, wr, out, st, nz, nr,
                                                 cz, cr);
  counts[kPhMgRestrict] += 1;
  return cudaGetLastError();
}

cudaError_t launch_mg_prolong(float* x, const float* xc, const float* wz,
                              const float* wr, const CGState* st, int nz,
                              int nr, int cstride, long long* counts,
                              cudaStream_t stream) {
  if (!(nz & 1) || !(nr & 1) || cstride < (nr + 1) / 2)
    return cudaErrorInvalidValue;
  const int blocks = (nz * nr + kThreads - 1) / kThreads;
  k_mg_prolong<<<blocks, kThreads, 0, stream>>>(x, xc, wz, wr, st, nz, nr,
                                                cstride);
  counts[kPhMgProlong] += 1;
  return cudaGetLastError();
}

// The V-cycle from level l down for the right-hand side b: smoothing from
// zero, residual, restriction into the next level's right-hand side, the
// cycle there, prolongation added in place, smoothing; `nu_coarse` steps
// from zero on the last level. `mask`, `dot` and `part` go to the last
// smoothing step of this level.
cudaError_t mg_cycle(const MGDesc* mg, int l, const float* b,
                     const float* mask, const float* dot, double* part,
                     const CGState* st, long long* counts,
                     cudaStream_t stream, float** result) {
  const MGLevel& L = mg->lv[l];
  if (l == mg->n_levels - 1)
    return mg_smooth(L, b, nullptr, mg->nu_coarse, mask, dot, part, st,
                     counts, stream, result);
  const MGLevel& N = mg->lv[l + 1];
  float *x = nullptr, *xc = nullptr;
  cudaError_t e;
#define HF_TRY(call) if ((e = (call)) != cudaSuccess) return e
  HF_TRY(mg_smooth(L, b, nullptr, mg->nu, nullptr, nullptr, nullptr, st,
                   counts, stream, &x));
  HF_TRY(launch_mg_residual(L.C, L.npts, b, x, L.res, st, L.nz, L.nr, counts,
                            stream));
  HF_TRY(launch_mg_restrict(L.res, L.wz, L.wr, N.b, st, L.nz, L.nr, N.nz,
                            N.nr, counts, stream));
  HF_TRY(mg_cycle(mg, l + 1, N.b, nullptr, nullptr, nullptr, st, counts,
                  stream, &xc));
  HF_TRY(launch_mg_prolong(x, xc, L.wz, L.wr, st, L.nz, L.nr, N.nr, counts,
                           stream));
  return mg_smooth(L, b, x, mg->nu, mask, dot, part, st, counts, stream,
                   result);
#undef HF_TRY
}

// The multigrid form: z = V-cycle(r) (sm > 0) with the <r, z> partials (one
// an elementwise block). The wrapper lays out level 0's two planes so that
// the last iterate lands in s.z.
cudaError_t precondition_mg(const Solve& s) {
  cudaError_t e = mg_check(s.mgd);
  if (e != cudaSuccess) return e;
  if (s.mgd->lv[0].nz != s.nz || s.mgd->lv[0].nr != s.nr)
    return cudaErrorInvalidValue;
  float* out = nullptr;
  e = mg_cycle(s.mgd, 0, s.r, s.sm, s.r, s.part(2), s.st, s.counts, s.stream,
               &out);
  if (e != cudaSuccess) return e;
  return out == s.z ? cudaSuccess : cudaErrorInvalidValue;
}

// M^-1 r for the solve's form, with the <r, z> partials; the result is in
// s.zout() (r itself in the identity form, where z aliases r).
cudaError_t precondition(const Solve& s) {
  if (s.mgd) return precondition_mg(s);
  if (s.mgz()) return precondition_mgz(s, s.r, s.z, s.st);
  if (s.cheb > 0) return precondition_cheb(s, s.r, s.st);
  if (!s.rline()) return cudaSuccess;   // identity: z aliases r
  cudaError_t e = launch_pcr_r(s.r, s.sm, s.pcr, s.lr, s.z, s.part(2),
                               s.adi() ? 0 : 1, s.st, s.nz, s.nr, s.counts,
                               s.stream);
  if (e != cudaSuccess || !s.adi()) return e;
  return launch_pcr_z(s.r, s.sm, s.pcrz, s.lz, s.z, s.part(2), s.st, s.nz,
                      s.nr, s.counts, s.stream);
}

cudaError_t finalize(const Solve& s, int mode) {
  k_finalize<<<1, kThreads, 0, s.stream>>>(
      s.st, s.part(0), s.part(1), s.part(2), s.part(3), s.elem_blocks(),
      s.n_rz(), mode, s.rtol, s.maxiter, s.wrt_r0, s.fixed);
  s.counts[kPhFinalize] += 1;
  return cudaGetLastError();
}

cudaError_t p_update(const Solve& s, int first) {
  k_p_update<<<s.elem_blocks(), kThreads, 0, s.stream>>>(s.p, s.zout(), s.st,
                                                         first, s.n());
  s.counts[kPhPUpdate] += 1;
  return cudaGetLastError();
}

// The merged-dot tail of a step: w = A u with gamma, delta and <r, r>, the
// scalars, then p and q.
cudaError_t merged_tail(const Solve& s, int first) {
  k_merged_w<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
      s.A, s.npts, s.sm, s.zout(), s.r, s.w(), s.part(0), s.part(1),
      s.part(2), s.st, s.nz, s.nr);
  s.counts[kPhMergedW] += 1;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  k_finalize_merged<<<1, kThreads, 0, s.stream>>>(
      s.st, s.part(0), s.part(1), s.part(2), s.part(3), s.elem_blocks(),
      s.preconditioned(), first, s.rtol, s.maxiter, s.wrt_r0);
  s.counts[kPhFinalizeMerged] += 1;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  k_pq_update<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
      s.p, s.q(), s.zout(), s.w(), s.st, first, s.n());
  s.counts[kPhPqUpdate] += 1;
  return cudaGetLastError();
}

cudaError_t start(const Solve& s) {
  cudaError_t e = cudaMemsetAsync(s.st, 0, sizeof(CGState), s.stream);
  if (e != cudaSuccess) return e;
  k_init<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
      s.A, s.npts, s.sm, s.b, s.x0, s.x, s.r, s.part(1), s.part(3), s.nz,
      s.nr);
  s.counts[kPhInit] += 1;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = precondition(s)) != cudaSuccess) return e;
  if (s.merged) return merged_tail(s, 1);
  if ((e = finalize(s, kFinInit)) != cudaSuccess) return e;
  return p_update(s, 1);
}

cudaError_t iterate(const Solve& s) {
  cudaError_t e;
  if (s.merged) {
    // x += alpha p, r -= alpha q; u = M^-1 r; then the merged tail
    k_update<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
        s.x, s.r, s.p, s.q(), s.part(1), s.st, s.n());
    s.counts[kPhUpdate] += 1;
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if ((e = precondition(s)) != cudaSuccess) return e;
    return merged_tail(s, 0);
  }
  k_stencil_dot<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
      s.A, s.npts, s.sm, s.p, s.Ap, s.part(0), s.st, s.nz, s.nr);
  s.counts[kPhStencilDot] += 1;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = finalize(s, kFinAlpha)) != cudaSuccess) return e;
  k_update<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
      s.x, s.r, s.p, s.Ap, s.part(1), s.st, s.n());
  s.counts[kPhUpdate] += 1;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = precondition(s)) != cudaSuccess) return e;
  if ((e = finalize(s, kFinBeta)) != cudaSuccess) return e;
  return p_update(s, 0);
}

}  // namespace

// ---------------------------------------------------------------------
// C interface (bound with ctypes by heatflow_tpu_torch/ops/cuda_cg.py).
// Every entry returns a cudaError_t code, 0 on success. Pointers are
// device pointers; `stream` is the caller's cudaStream_t.
// ---------------------------------------------------------------------

#define HF_SOLVE_ARGS                                                        \
  const float *A, int npts, const float *sm, const float *b,                 \
      const float *x0, const float *rtol, const float *pcr, int lr,          \
      const float *pcrz, int lz, float *x, float *r, float *z, float *p,     \
      float *Ap, double *parts, int nparts, void *state, int nz, int nr,     \
      int maxiter, int wrt_r0, long long *counts, void *stream,              \
      const float *lmax, int cheb, int merged, const float *ac9,             \
      const float *pcrc, int lc, const float *aux, int sweeps, float omega,  \
      float omega_c, float *extra, const void *mg, int fixed

#define HF_SOLVE_INIT                                                        \
  Solve s{A, sm, b, x0, rtol, pcr, pcrz, x, r, z, p, Ap, parts,              \
          (CGState *)state, npts, lr, lz, nz, nr, maxiter, wrt_r0, nparts,   \
          counts, (cudaStream_t)stream, lmax, cheb, merged, ac9, pcrc, aux,  \
          lc, sweeps, omega, omega_c, extra, (const MGDesc *)mg, fixed}

extern "C" {

// Bytes of the partial-sum and state scratch the solve needs.
int hf_cg_nparts(int nz, int nr) {
  const int elem = (nz * nr + kThreads - 1) / kThreads;
  const int tiles = (nr + kTileCols - 1) / kTileCols;
  int m = elem > nz ? elem : nz;
  return m > tiles ? m : tiles;
}

int hf_cg_state_bytes() { return (int)sizeof(CGState); }

int hf_num_phases() { return kNumPhases; }

// (Nz, Nr) planes of `extra` a form needs: q and w (merged), d and the
// second z plane (Chebyshev), r1, yc, rcs and res (mgz).
int hf_cg_extra_planes(int cheb, int merged, int mgz) {
  return (merged ? 2 : 0) + (cheb > 0 ? 2 : 0) + (mgz ? 4 : 0);
}

// x = x0, initial residual, preconditioned residual, scalars, p = z.
int hf_cg_tol_start(HF_SOLVE_ARGS) {
  HF_SOLVE_INIT;
  return (int)start(s);
}

// Enqueue n_iter CG iterations; each phase is a no-op once done is set.
int hf_cg_tol_iterate(HF_SOLVE_ARGS, int n_iter) {
  HF_SOLVE_INIT;
  for (int it = 0; it < n_iter; ++it) {
    cudaError_t e = iterate(s);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

int hf_cg_tol_finish(float *x, int *iters, void *state, int n,
                     long long *counts, void *stream) {
  k_finish<<<(n + kThreads - 1) / kThreads, kThreads, 0,
             (cudaStream_t)stream>>>(x, iters, (const CGState *)state, n);
  counts[kPhFinish] += 1;
  return (int)cudaGetLastError();
}

// Single phases, for checking each kernel against its plain version.
int hf_stencil_dot(const float *A, int npts, const float *sm, const float *p,
                   float *Ap, double *part, int nz, int nr, long long *counts,
                   void *stream) {
  const int blocks = (nz * nr + kThreads - 1) / kThreads;
  k_stencil_dot<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      A, npts, sm, p, Ap, part, nullptr, nz, nr);
  counts[kPhStencilDot] += 1;
  return (int)cudaGetLastError();
}

int hf_pcr_r(const float *r, const float *sm, const float *F, int levels,
             float *z, double *part, int nz, int nr, long long *counts,
             void *stream) {
  return (int)launch_pcr_r(r, sm, F, levels, z, part, 1, nullptr, nz, nr,
                           counts, (cudaStream_t)stream);
}

int hf_pcr_z(const float *r, const float *sm, const float *F, int levels,
             float *z, double *part, int nz, int nr, long long *counts,
             void *stream) {
  return (int)launch_pcr_z(r, sm, F, levels, z, part, nullptr, nz, nr,
                           counts, (cudaStream_t)stream);
}

// z = M^-1 r of the Chebyshev (cheb > 0) or mgz (pcrc given) form alone,
// with the <r, z> partials in parts plane 2; *which = 1 when the result is
// in the second plane of `extra` and not in z (Chebyshev, even degree).
int hf_precond_apply(const float *A, int npts, const float *sm,
                     const float *r, const float *pcr, int lr, float *z,
                     double *parts, int nparts, int nz, int nr,
                     long long *counts, void *stream, const float *lmax,
                     int cheb, const float *ac9, const float *pcrc, int lc,
                     const float *aux, int sweeps, float omega, float omega_c,
                     float *extra, int *which) {
  Solve s{A, sm, nullptr, nullptr, nullptr, pcr, nullptr, nullptr,
          const_cast<float *>(r), z, nullptr, nullptr, parts, nullptr, npts,
          lr, 0, nz, nr, 0, 0, nparts, counts, (cudaStream_t)stream, lmax,
          cheb, 0, ac9, pcrc, aux, lc, sweeps, omega, omega_c, extra,
          nullptr, 0};
  *which = s.zout() != z;
  return (int)precondition(s);
}

int hf_residual(const float *A, int npts, const float *sm, const float *r,
                const float *v, float *out, int nz, int nr,
                long long *counts, void *stream) {
  return (int)launch_residual(A, npts, sm, r, v, out, nullptr, nz, nr, counts,
                              (cudaStream_t)stream);
}

// The mgz row kernel alone (see k_pcr_row); aux, store, acc, sm and dot
// may be null.
int hf_pcr_row(const float *src, const float *aux, float *store,
               const float *F, int levels, float scale, const float *acc,
               const float *sm, float *out, const float *dot, double *part,
               int nz, int nr, long long *counts, void *stream) {
  return (int)launch_pcr_row(src, aux, store, F, levels, scale, acc, sm, out,
                             dot, part, nullptr, nz, nr, counts,
                             (cudaStream_t)stream);
}

int hf_coarse_res(const float *ac9, const float *rcs, const float *y,
                  float *out, int nz, int nr, long long *counts,
                  void *stream) {
  return (int)launch_coarse_res(ac9, rcs, y, out, nullptr, nz, nr, counts,
                                (cudaStream_t)stream);
}

int hf_prolong(float *x, const float *y, const float *aux, int nz, int nr,
               long long *counts, void *stream) {
  return (int)launch_prolong(x, y, aux, nullptr, nz, nr, counts,
                             (cudaStream_t)stream);
}

// w = sm A (sm u) with the partials of delta, <r, r> and gamma in parts
// planes 0, 1 and 2.
int hf_merged_w(const float *A, int npts, const float *sm, const float *u,
                const float *r, float *w, double *parts, int nparts, int nz,
                int nr, long long *counts, void *stream) {
  const int blocks = (nz * nr + kThreads - 1) / kThreads;
  k_merged_w<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      A, npts, sm, u, r, w, parts, parts + nparts, parts + 2 * (size_t)nparts,
      nullptr, nz, nr);
  counts[kPhMergedW] += 1;
  return (int)cudaGetLastError();
}

// The merged recurrence's scalar phase on a state record and 4 x nparts
// partial sums (delta, rr, gamma, bb), n_elem of each.
int hf_finalize_merged(void *state, const double *parts, int nparts,
                       int n_elem, int preconditioned, int first,
                       const float *rtol, int maxiter, int wrt_r0,
                       long long *counts, void *stream) {
  k_finalize_merged<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (CGState *)state, parts, parts + nparts, parts + 2 * (size_t)nparts,
      parts + 3 * (size_t)nparts, n_elem, preconditioned, first, rtol,
      maxiter, wrt_r0);
  counts[kPhFinalizeMerged] += 1;
  return (int)cudaGetLastError();
}

// p = u + beta p, q = w + beta q in place, beta from the state record.
int hf_pq_update(float *p, float *q, const float *u, const float *w,
                 const void *state, int n, long long *counts, void *stream) {
  k_pq_update<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                (cudaStream_t)stream>>>(p, q, u, w, (const CGState *)state, 0,
                                        n);
  counts[kPhPqUpdate] += 1;
  return (int)cudaGetLastError();
}

// Bytes of the multigrid descriptor, for the wrapper's layout check.
int hf_mg_desc_bytes() { return (int)sizeof(MGDesc); }

// Single phases of the multigrid cycle, for checking each kernel against
// its plain version. x_in, mask and dot may be null.
int hf_mg_cheb(const float *C, int npts, const float *b, const float *x_in,
               float *d, float *x_out, int first, float theta, float c1,
               float c2, const float *mask, const float *dot, double *part,
               int nz, int nr, long long *counts, void *stream) {
  const int blocks = (nz * nr + kThreads - 1) / kThreads;
  k_mg_cheb<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      C, npts, b, x_in, d, x_out, first, theta, c1, c2, mask, dot, part,
      nullptr, nz, nr);
  counts[kPhMgCheb] += 1;
  return (int)cudaGetLastError();
}

int hf_mg_residual(const float *C, int npts, const float *b, const float *x,
                   float *out, int nz, int nr, long long *counts,
                   void *stream) {
  return (int)launch_mg_residual(C, npts, b, x, out, nullptr, nz, nr, counts,
                                 (cudaStream_t)stream);
}

int hf_mg_restrict(const float *v, const float *wz, const float *wr,
                   float *out, int nz, int nr, int cz, int cr,
                   long long *counts, void *stream) {
  return (int)launch_mg_restrict(v, wz, wr, out, nullptr, nz, nr, cz, cr,
                                 counts, (cudaStream_t)stream);
}

int hf_mg_prolong(float *x, const float *xc, const float *wz, const float *wr,
                  int nz, int nr, int cstride, long long *counts,
                  void *stream) {
  return (int)launch_mg_prolong(x, xc, wz, wr, nullptr, nz, nr, cstride,
                                counts, (cudaStream_t)stream);
}

// The whole V-cycle alone: the cycle of `mg` on the right-hand side r, the
// result times (mask > 0) when mask is given, with the <r, z> partials (one
// an elementwise block of level 0) in part; *result is the device pointer
// of the plane that holds z (level 0's xa or xb).
int hf_mg_vcycle(const void *mg, const float *r, const float *mask,
                 double *part, long long *counts, void *stream,
                 void **result) {
  const MGDesc *desc = (const MGDesc *)mg;
  cudaError_t e = mg_check(desc);
  if (e != cudaSuccess) return (int)e;
  float *out = nullptr;
  e = mg_cycle(desc, 0, r, mask, r, part, nullptr, counts,
               (cudaStream_t)stream, &out);
  *result = out;
  return (int)e;
}

}  // extern "C"
