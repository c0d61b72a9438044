// Tolerance-stopped preconditioned CG on the on-the-fly scaled stencil
// operator sm * A * (sm * y), for one (Nz, Nr) problem in float32.
//
// Replaces: heatflow_tpu/ops/pallas_cg.py:_cg_tol_kernel (the Pallas TPU
// kernel that keeps the whole solve resident in VMEM), in its identity,
// r-line PCR and split-additive ADI (r-line + z-line PCR) forms.
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
  kPhPUpdate, kPhFinish, kNumPhases
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

// Reduce n partials in a fixed order (deterministic); valid in all threads.
__device__ double reduce_parts(const double* part, int n) {
  double s = 0.0;
  for (int t = threadIdx.x; t < n; t += blockDim.x) s += part[t];
  return block_sum(s);
}

// The CG scalars, in one block. Guards and stop rule of the TPU kernel:
// pAp == 0 -> 1, rz == 0 -> 1; rr is <r, r> when preconditioned and rz
// otherwise; the loop runs while k < maxiter && rr > stop2 (a NaN rr stops
// it). n_rz == 0 means z is r (identity form), so <r, z> = <r, r>.
__global__ void k_finalize(CGState* st, const double* part_pap,
                           const double* part_rr, const double* part_rz,
                           const double* part_bb, int n_elem, int n_rz,
                           int mode, const float* rtol, int maxiter,
                           int wrt_r0) {
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
      st->done = !(0 < maxiter && st->rr > st->stop2);
    }
    return;
  }
  if (threadIdx.x == 0) {
    st->beta = rz / (st->rz != 0.0 ? st->rz : 1.0);
    st->rz = rz;
    st->rr = n_rz > 0 ? rr : rz;
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

struct Solve {
  const float *A, *sm, *b, *x0, *rtol, *pcr, *pcrz;
  float *x, *r, *z, *p, *Ap;
  double* parts;   // 4 x nparts: pAp, rr, rz, bb
  CGState* st;
  int npts, lr, lz, nz, nr, maxiter, wrt_r0, nparts;
  long long* counts;
  cudaStream_t stream;

  int n() const { return nz * nr; }
  int elem_blocks() const { return (n() + kThreads - 1) / kThreads; }
  int col_tiles() const { return (nr + kTileCols - 1) / kTileCols; }
  double* part(int which) const { return parts + (size_t)which * nparts; }
  bool rline() const { return pcr != nullptr; }
  bool adi() const { return pcrz != nullptr; }
  int n_rz() const { return adi() ? col_tiles() : rline() ? nz : 0; }
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

// z = M^-1 r for the solve's form, with the <r, z> partials.
cudaError_t precondition(const Solve& s) {
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
      s.n_rz(), mode, s.rtol, s.maxiter, s.wrt_r0);
  s.counts[kPhFinalize] += 1;
  return cudaGetLastError();
}

cudaError_t p_update(const Solve& s, int first) {
  k_p_update<<<s.elem_blocks(), kThreads, 0, s.stream>>>(s.p, s.z, s.st,
                                                         first, s.n());
  s.counts[kPhPUpdate] += 1;
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
  if ((e = finalize(s, kFinInit)) != cudaSuccess) return e;
  return p_update(s, 1);
}

cudaError_t iterate(const Solve& s) {
  cudaError_t e;
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
      int maxiter, int wrt_r0, long long *counts, void *stream

#define HF_SOLVE_INIT                                                        \
  Solve s{A, sm, b, x0, rtol, pcr, pcrz, x, r, z, p, Ap, parts,              \
          (CGState *)state, npts, lr, lz, nz, nr, maxiter, wrt_r0, nparts,   \
          counts, (cudaStream_t)stream}

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

}  // extern "C"
