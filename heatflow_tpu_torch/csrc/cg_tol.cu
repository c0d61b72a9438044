// Tolerance-stopped preconditioned CG on the on-the-fly scaled stencil
// operator sm * A * (sm * y), for one (Nz, Nr) problem in float32.
//
// Replaces: heatflow_tpu/ops/pallas_cg.py:_cg_tol_kernel (the Pallas TPU
// kernel that keeps the whole solve resident in VMEM), in its identity,
// r-line PCR, split-additive ADI (r-line + z-line PCR), Chebyshev-polynomial
// and z-semicoarsened two-level multigrid (mgz) forms, with the standard
// recurrence or the Chronopoulos-Gear merged-dot recurrence.
//
// What bounds it on an H100: memory traffic, the latency of dependent
// loads, and the gaps between launches; not arithmetic. At the flagship
// shape (251 x 1107 = 277,857 nodes, one f32 plane is 1.11 MB) an r-line
// iteration must move ~34 planes (~38 MB, ~11 us at 3.35 TB/s): the 7
// stencil planes, the vectors (p, Ap, x, r, z, sm) and the 23-plane folded
// r-line PCR stack; the ADI form adds the 17-plane z-line stack. Shared
// memory is 227 KB a block: a row's stack (~102 KB) fits one block, a
// z-line tile's does not, and the working set (~40 MB r-line, ~59 MB ADI)
// fits no block. The first design, one kernel per CG phase: 6 launches and
// ~60 us an r-line iteration (28 us in a PCR kernel whose 11 levels each
// waited on dependent global loads), 7 and ~149 us an ADI one, and a host
// read of the stop flag every 8 iterations.
//
// What this design does about that. Times: NVIDIA H100 80GB HBM3, 700 W,
// in-solve by torch.profiler (chip_smoke.py phase 3), solves by CUDA events
// (chip_smoke.py, tools/k1_ab.py against the one-kernel-a-phase design in
// the same run):
// - PCR factors in flight. The r-line row kernel (one block a grid row)
//   requests its row of r and Ap, then its row's whole factor stack, into
//   shared memory with 4-byte cp.async copies, one commit group a level;
//   the update starts on the vectors and level k waits for its own group
//   only while the later levels keep arriving. 110.7 KB a block on the
//   flagship: two blocks an SM, the 251 rows one wave on 132 SMs. In a
//   solve: 24.4 us for the update and the PCR together (27.8 + 3.7
//   before), against a 10.3 us traffic bound; 16-byte copies through L2
//   made no difference. The z-line kernel holds a tile's factors in
//   registers instead, each thread requesting the next level's before it
//   computes this one: 21.5 us (bound 14.3), against 35 us for tiles
//   narrowed to fit shared memory and 76 us before.
// - Fewer launches. The scalars ride in the tails of the kernels: each
//   block writes its partial, fences and takes a ticket; the last block
//   reduces the partials in a fixed order (no atomics on the sums, so a
//   solve is bitwise repeatable) and sets alpha (after the stencil) or
//   beta, the count and the stop flag (after the kernel that writes the
//   last partials). An r-line iteration is 3 launches (k_stencil_dot,
//   k_pcr_r<true>, k_p_update), an ADI one 4 (+ k_pcr_z), an identity one
//   3 (k_update takes beta). The alpha tail costs the stencil ~4 us (12.6
//   us against 8.8).
// - No host in the loop. A solve is one CUDA graph: the start, a
//   conditional WHILE node whose body is CHECK_EVERY iterations, and the
//   finish. The last kernel of the start and of each body sets the loop
//   condition from the done flag, so the device runs blocks until the
//   solve stops and the host reads nothing before the end; every phase
//   kernel still returns at once when the flag is set, so an iterate does
//   not depend on CHECK_EVERY. The wrapper captures a graph once per
//   operand set (capture and instantiation 0.6-1.2 ms) on buffers it keeps
//   per shape, form and device. The flagship's first-step solves: r-line
//   544 iterations, 40.7 us an iteration, 22.1 ms (32.4-32.8 before); ADI
//   229, 63.9 us, 14.4-14.6 ms (34.2 before).
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
// (k_update, k_merged_w, k_finalize_merged, k_pq_update), at one more plane
// of traffic than the standard recurrence; these forms keep k_update and a
// k_finalize of their own and share the graph loop.
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

constexpr int kThreads = 256;     // elementwise and finalize blocks
constexpr int kTileCols = 16;     // k_pcr_z_tall: columns a block at most
constexpr int kRowThreads = 512;  // r-line row kernel: threads a block
constexpr int kZCols = 8;         // z-line kernel: columns a block,
constexpr int kZRows = 32;        // thread rows a block,
constexpr int kZPer = 8;          // rows a thread (Nz <= kZRows * kZPer)
constexpr int kZTallThreads = 512;  // z-line kernel for taller columns
// The most dynamic shared memory a block may ask for (227 KB opt-in, less
// the static shared memory of block_sum and last_block).
constexpr size_t kMaxDynSmem = 232448 - 1024;

// Solve state kept in device memory (mirrored by the Python wrapper:
// k is int32 word 10 and done is int32 word 11 of the 64-byte buffer).
// ticket[0] / ticket[1] count the blocks of a launch that carries the
// alpha / beta tail; its last block resets them to 0.
struct CGState {
  double rz, rr, stop2, alpha, beta;
  int k, done;
  unsigned ticket[2];
};

enum Phase {
  kPhInit = 0, kPhStencilDot, kPhUpdate, kPhPcrR, kPhPcrZ, kPhFinalize,
  kPhPUpdate, kPhFinish, kPhChebInit, kPhChebStep, kPhMergedW,
  kPhFinalizeMerged, kPhPqUpdate, kPhResidual, kPhPcrRow, kPhCoarseRes,
  kPhProlong, kPhMgCheb, kPhMgResidual, kPhMgRestrict, kPhMgProlong,
  kPhUpdatePcrR, kNumPhases
};

enum FinalizeMode { kFinInit = 0, kFinBeta = 1 };

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

// Reduce n partials in a fixed order (deterministic); valid in all threads.
// The partials bypass L1: the last block of a launch reads what the other
// blocks wrote.
__device__ double reduce_parts(const double* part, int n) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  double s = 0.0;
  for (int t = tid; t < n; t += nthreads) s += __ldcg(part + t);
  return block_sum(s);
}

// The last-block pattern: thread 0 of every block has written the block's
// partials; each block takes a ticket after a fence, and the block that
// draws the last one (true in all its threads) sees every partial. No
// atomics touch the sums, so they keep a fixed order.
__device__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  return last;
}

// The CG scalars: the guards and stop rule of the TPU kernel. pAp == 0 ->
// 1, rz == 0 -> 1; rr is <r, r> when preconditioned and rz otherwise; the
// loop runs while k < maxiter && rr > stop2 (a NaN rr stops it). With
// `fixed` the stop test is off and the loop runs maxiter iterations.
__device__ void alpha_rule(CGState* st, double pap) {
  st->alpha = st->rz / (pap != 0.0 ? pap : 1.0);
}

__device__ void beta_rule(CGState* st, double rr, double rz,
                          bool preconditioned, int maxiter, int fixed) {
  st->beta = rz / (st->rz != 0.0 ? st->rz : 1.0);
  st->rz = rz;
  st->rr = preconditioned ? rr : rz;
  st->k += 1;
  st->done = !(st->k < maxiter && (fixed || st->rr > st->stop2));
}

// The beta step a kernel's last block takes after the kernel's partials
// are written: <r, r> from part_rr (n_rr of them), <r, z> from part_rz
// (n_rz; none: z is r, the identity form). Off when st is null.
struct BetaTail {
  CGState* st;
  const double* part_rr;
  const double* part_rz;
  int n_rr, n_rz, maxiter, fixed;
};

__device__ void beta_tail(const BetaTail& t) {
  if (t.st == nullptr || !last_block(&t.st->ticket[1])) return;
  const double rr = reduce_parts(t.part_rr, t.n_rr);
  const double rz = t.n_rz > 0 ? reduce_parts(t.part_rz, t.n_rz) : rr;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    beta_rule(t.st, rr, rz, t.n_rz > 0, t.maxiter, t.fixed);
    t.st->ticket[1] = 0;
  }
}

// The loop condition of the solve's graph, set by the kernel that ends the
// start or a block of iterations: 1 while the solve runs. `runs` counts the
// block's launches (null at the start).
__device__ void set_loop(const CGState* st, int set_cond,
                         cudaGraphConditionalHandle cond,
                         unsigned long long* runs) {
  if (!set_cond || blockIdx.x != 0 || threadIdx.x != 0) return;
  if (runs != nullptr) *runs += 1;
  cudaGraphSetConditional(cond, st->done ? 0u : 1u);
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

// Ap = sm A (sm p); partials of <p, Ap>. With `tail` the last block
// reduces them and sets alpha = rz / pAp.
__global__ void k_stencil_dot(const float* __restrict__ A, int npts,
                              const float* __restrict__ sm,
                              const float* __restrict__ p,
                              float* __restrict__ Ap, double* part,
                              CGState* st, int tail, int nz, int nr) {
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
  if (!tail || st == nullptr || !last_block(&st->ticket[0])) return;
  const double pap = reduce_parts(part, gridDim.x);
  if (threadIdx.x == 0) {
    alpha_rule(st, pap);
    st->ticket[0] = 0;
  }
}

// x += alpha p, r -= alpha Ap; partials of <r, r>, and the beta tail when
// one is given (the identity form, where z is r).
__global__ void k_update(float* __restrict__ x, float* __restrict__ r,
                         const float* __restrict__ p,
                         const float* __restrict__ Ap, double* part_rr,
                         const CGState* st, BetaTail tail, int n) {
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
  beta_tail(tail);
}

// ---- line PCR with the factor stack in flight ----------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's copy groups are in flight
// (waiting for fewer than asked is also correct: at most 15 are left).
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    case 7: cp_async_wait<7>(); break;
    case 8: cp_async_wait<8>(); break;
    case 9: cp_async_wait<9>(); break;
    case 10: cp_async_wait<10>(); break;
    case 11: cp_async_wait<11>(); break;
    case 12: cp_async_wait<12>(); break;
    case 13: cp_async_wait<13>(); break;
    case 14: cp_async_wait<14>(); break;
    default: cp_async_wait<15>(); break;
  }
}

// The lines a block solves: `len` positions of `w` adjacent lines, of which
// the first `valid` exist; position i of line c lies at base + i * stride
// + c in a plane. In shared memory they are position-major: e = i * w + c.
// Thread (x, y) takes line x and positions y, y + blockDim.y, ...
struct Lines {
  size_t base, stride;
  int len, w, valid;
};

// Request the block's share of the folded factor stack F (2L+1 planes of n
// values) into fs with 4-byte asynchronous copies, in level order, one
// commit group per level (planes 2k and 2k+1) and one for the diagonal,
// after the group of the block's vectors.
__device__ void stage_stack(float* fs, const float* __restrict__ F, size_t n,
                            int levels, const Lines& ln) {
  const int c = threadIdx.x;
  const size_t plane = (size_t)ln.len * ln.w;
  for (int q = 0; q <= 2 * levels; ++q) {
    if (c < ln.valid)
      for (int i = threadIdx.y; i < ln.len; i += blockDim.y)
        cp_async4(fs + q * plane + (size_t)i * ln.w + c,
                  F + q * n + ln.base + (size_t)i * ln.stride + c);
    if (q % 2 == 1 || q == 2 * levels) cp_async_commit();
  }
}

// The folded PCR levels of stack F on the block's lines, d0 holding them on
// entry; returns the buffer that holds the result. Level k (s = 2^k):
//   d[i] <- d[i] - F[2k][i] d[i-s] - F[2k+1][i] d[i+s]   (zeros outside).
// Staged (kStaged), the block's vectors are copy group 0 and level k's
// factors group k + 1: level k waits for its own group only and the later
// levels' factors keep arriving; else the factors are read from device
// memory.
template <bool kStaged>
__device__ float* pcr_levels(float* d0, float* d1, const float* fs,
                             const float* __restrict__ F, size_t n,
                             int levels, const Lines& ln) {
  const int c = threadIdx.x;
  const size_t plane = (size_t)ln.len * ln.w;
  int s = 1;
  for (int k = 0; k < levels; ++k) {
    if (kStaged) cp_async_wait_pending(levels - k);
    __syncthreads();  // level k's factors and the previous level's d landed
    const float* lo = kStaged ? fs + (2 * k) * plane : F + (2 * k) * n;
    const float* up = kStaged ? fs + (2 * k + 1) * plane : F + (2 * k + 1) * n;
    if (c < ln.valid) {
      for (int i = threadIdx.y; i < ln.len; i += blockDim.y) {
        const int e = i * ln.w + c;
        const size_t q = kStaged ? e : ln.base + (size_t)i * ln.stride + c;
        float v = d0[e];
        if (i - s >= 0) v = v - lo[q] * d0[e - s * ln.w];
        if (i + s < ln.len) v = v - up[q] * d0[e + s * ln.w];
        d1[e] = v;
      }
    }
    float* t = d0; d0 = d1; d1 = t;
    s <<= 1;
  }
  if (kStaged) cp_async_wait<0>();
  __syncthreads();
  return d0;
}

// The r-line row kernel, one block per z-row. Its shared memory is the row
// double buffered and, when staged, the row's whole factor stack (2L+1 rows
// of nr values, ~102 KB on the flagship). At its start the block requests
// its row of r (and Ap) into the two row buffers, then the stack level by
// level, all with asynchronous copies, so the update starts on the vectors
// while the factors stream in. With kUpdate it takes the CG update of its
// row,
//   r -= alpha Ap, x += alpha p    (and the row's partial of <r, r>),
// then z = F[2L] d * free with free = (sm != 0), and optionally the row's
// partial of <r, z> and the beta tail: the whole iteration after A p, local
// to one grid row.
template <bool kUpdate>
__global__ void __launch_bounds__(kRowThreads, 2)
    k_pcr_r(float* r, float* x, const float* __restrict__ p,
            const float* __restrict__ Ap, const float* __restrict__ sm,
            const float* __restrict__ F, int levels, int staged,
            float* __restrict__ z, double* part_rr, double* part_rz,
            const CGState* st, BetaTail tail, int nz, int nr) {
  if (st != nullptr && st->done) return;
  extern __shared__ float smem[];
  float* d0 = smem;
  float* d1 = smem + nr;
  float* fs = smem + 2 * nr;
  const size_t n = (size_t)nz * nr;
  const size_t row = (size_t)blockIdx.x * nr;
  const Lines ln{row, 1, nr, 1, 1};
  for (int j = threadIdx.y; j < nr; j += blockDim.y) {
    cp_async4(d0 + j, r + row + j);
    if (kUpdate) cp_async4(d1 + j, Ap + row + j);
  }
  cp_async_commit();
  if (staged) stage_stack(fs, F, n, levels, ln);
  // this thread's own row copies (group 0) landed; it reads only those
  cp_async_wait_pending(staged ? levels + 1 : 0);
  const float alpha = kUpdate ? (float)st->alpha : 0.0f;
  double rr = 0.0;
  if (kUpdate) {
    for (int j = threadIdx.y; j < nr; j += blockDim.y) {
      const float rv = d0[j] - alpha * d1[j];
      d0[j] = rv;
      r[row + j] = rv;
      rr += (double)(rv * rv);
    }
  }
  d0 = staged ? pcr_levels<true>(d0, d1, fs, F, n, levels, ln)
              : pcr_levels<false>(d0, d1, fs, F, n, levels, ln);
  const size_t gq = (size_t)(2 * levels);
  const float* g = staged ? fs + gq * nr : F + gq * n + row;
  double rz = 0.0;
  for (int j = threadIdx.y; j < nr; j += blockDim.y) {
    if (kUpdate) x[row + j] = x[row + j] + alpha * p[row + j];
    const float fm = sm[row + j] != 0.0f ? 1.0f : 0.0f;
    const float zv = g[j] * d0[j] * fm;
    z[row + j] = zv;
    rz += (double)(r[row + j] * zv);
  }
  const bool tid0 = threadIdx.x == 0 && threadIdx.y == 0;
  if (part_rr != nullptr) {
    rr = block_sum(rr);
    if (tid0) part_rr[blockIdx.x] = rr;
  }
  if (part_rz != nullptr) {
    rz = block_sum(rz);
    if (tid0) part_rz[blockIdx.x] = rz;
  }
  beta_tail(tail);
}

// z-line PCR apply and the ADI combine for columns of at most kZRows x
// kZPer values, one block per tile of kZCols adjacent columns. A z-line's
// 17-plane stack (for 251 rows) does not fit a tile's shared memory, so the
// factors go to registers: each thread holds its kZPer rows' factors of a
// level and requests the next level's before it computes this one, so a
// level's loads are in flight while the level before it runs. On entry z
// holds the r-line result R r * free; on exit
//   z = (R r + Z r - r) * free
// and the tile's partial of <r, z> is written; then the beta tail.
__global__ void __launch_bounds__(kZCols * kZRows)
    k_pcr_z(const float* __restrict__ r, const float* __restrict__ sm,
            const float* __restrict__ F, int levels,
            float* __restrict__ z, double* part_rz, const CGState* st,
            BetaTail tail, int nz, int nr) {
  if (st != nullptr && st->done) return;
  extern __shared__ float smem[];
  const int w = kZCols;
  float* d0 = smem;
  float* d1 = smem + nz * w;
  const size_t n = (size_t)nz * nr;
  const int c = threadIdx.x;
  const size_t col = (size_t)blockIdx.x * w + c;
  const bool valid = col < (size_t)nr;
  float lo[kZPer], up[kZPer];
#pragma unroll
  for (int m = 0; m < kZPer; ++m) {
    const int i = threadIdx.y + m * kZRows;
    const bool ok = valid && i < nz;
    if (i < nz) d0[i * w + c] = ok ? r[(size_t)i * nr + col] : 0.0f;
    lo[m] = ok ? F[(size_t)i * nr + col] : 0.0f;
    up[m] = ok && levels > 0 ? F[n + (size_t)i * nr + col] : 0.0f;
  }
  int s = 1;
  for (int k = 0; k < levels; ++k) {
    // the next level's factors (after the last level: the diagonal)
    float nlo[kZPer], nup[kZPer];
#pragma unroll
    for (int m = 0; m < kZPer; ++m) {
      const int i = threadIdx.y + m * kZRows;
      const bool ok = valid && i < nz;
      const size_t q = (size_t)i * nr + col;
      nlo[m] = ok ? F[(size_t)(2 * k + 2) * n + q] : 0.0f;
      nup[m] = ok && k + 1 < levels ? F[(size_t)(2 * k + 3) * n + q] : 0.0f;
    }
    __syncthreads();  // the previous level's d landed
#pragma unroll
    for (int m = 0; m < kZPer; ++m) {
      const int i = threadIdx.y + m * kZRows;
      if (valid && i < nz) {
        const int e = i * w + c;
        float v = d0[e];
        if (i - s >= 0) v = v - lo[m] * d0[e - s * w];
        if (i + s < nz) v = v - up[m] * d0[e + s * w];
        d1[e] = v;
      }
    }
    float* t = d0; d0 = d1; d1 = t;
    s <<= 1;
#pragma unroll
    for (int m = 0; m < kZPer; ++m) {
      lo[m] = nlo[m];
      up[m] = nup[m];
    }
  }
  __syncthreads();
  double acc = 0.0;
#pragma unroll
  for (int m = 0; m < kZPer; ++m) {
    const int i = threadIdx.y + m * kZRows;
    if (valid && i < nz) {
      const size_t q = (size_t)i * nr + col;
      const float fm = sm[q] != 0.0f ? 1.0f : 0.0f;
      const float rv = r[q];
      const float zv = (z[q] + lo[m] * d0[i * w + c] - rv) * fm;
      z[q] = zv;
      acc += (double)(rv * zv);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) part_rz[blockIdx.x] = acc;
  beta_tail(tail);
}

// The same for taller columns: a tile of w columns x all Nz rows, the
// levels' factors read from device memory (pcr_levels).
__global__ void k_pcr_z_tall(const float* __restrict__ r,
                             const float* __restrict__ sm,
                             const float* __restrict__ F, int levels, int w,
                             float* __restrict__ z, double* part_rz,
                             const CGState* st, BetaTail tail, int nz,
                             int nr) {
  if (st != nullptr && st->done) return;
  extern __shared__ float smem[];
  float* d0 = smem;
  float* d1 = smem + (size_t)nz * w;
  const size_t n = (size_t)nz * nr;
  const int c0 = blockIdx.x * w;
  const Lines ln{(size_t)c0, (size_t)nr, nz, w, min(w, nr - c0)};
  const int c = threadIdx.x;
  const bool valid = c < ln.valid;
  for (int i = threadIdx.y; i < nz; i += blockDim.y)
    d0[i * w + c] = valid ? r[(size_t)i * nr + c0 + c] : 0.0f;
  d0 = pcr_levels<false>(d0, d1, nullptr, F, n, levels, ln);
  const size_t gq = (size_t)(2 * levels);
  double acc = 0.0;
  if (valid) {
    for (int i = threadIdx.y; i < nz; i += blockDim.y) {
      const size_t q = (size_t)i * nr + c0 + c;
      const float fm = sm[q] != 0.0f ? 1.0f : 0.0f;
      const float rv = r[q];
      const float zv = (z[q] + F[gq * n + q] * d0[i * w + c] - rv) * fm;
      z[q] = zv;
      acc += (double)(rv * zv);
    }
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0 && threadIdx.y == 0) part_rz[blockIdx.x] = acc;
  beta_tail(tail);
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
                            int first, int n, int set_cond,
                            cudaGraphConditionalHandle cond,
                            unsigned long long* runs) {
  set_loop(st, set_cond, cond, runs);
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

// The start's scalars and stop target (kFinInit), or beta by beta_rule
// (kFinBeta), in one block. n_rz == 0 means z is r (identity form), so
// <r, z> = <r, r>. The standard loop takes alpha and beta in the tails of
// k_stencil_dot and of the kernel that writes the last partials; this
// kernel serves the start and the preconditioners whose last kernel has no
// tail (Chebyshev, mgz, multigrid).
__global__ void k_finalize(CGState* st, const double* part_rr,
                           const double* part_rz,
                           const double* part_bb, int n_elem, int n_rz,
                           int mode, const float* rtol, int maxiter,
                           int wrt_r0, int fixed) {
  if (mode != kFinInit && st->done) return;
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
  if (threadIdx.x == 0) beta_rule(st, rr, rz, n_rz > 0, maxiter, fixed);
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
                           const CGState* st, int first, int n, int set_cond,
                           cudaGraphConditionalHandle cond,
                           unsigned long long* runs) {
  set_loop(st, set_cond, cond, runs);
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

// iters = k; with `poison`, x = NaN everywhere when the residual is not
// finite.
__global__ void k_finish(float* __restrict__ x, int* iters,
                         const CGState* st, int poison, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx == 0) iters[0] = st->k;
  if (poison && idx < n && !isfinite(st->rr)) x[idx] = nanf("");
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
  int col_tiles() const;
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

// Shared memory of the r-line row kernel: the row double buffered, then
// the staged stack (110.7 KB on the flagship: two blocks an SM, so its 251
// rows are one wave on 132 SMs).
size_t pcr_r_smem(int nr, int levels, bool staged) {
  return (size_t)(staged ? 2 * levels + 3 : 2) * nr * sizeof(float);
}

// The row kernel stages its row's factor stack when it fits a block's
// shared memory; else it reads the factors from device memory.
bool r_staged(int nr, int levels) {
  return pcr_r_smem(nr, levels, true) <= kMaxDynSmem;
}

// Columns of a block of the z-line kernel: kZCols (k_pcr_z), or for
// columns taller than kZRows x kZPer as many as let k_pcr_z_tall's double
// buffer fit, at most kTileCols.
bool z_short(int nz) { return nz <= kZRows * kZPer; }

int z_cols(int nz) {
  if (z_short(nz)) return kZCols;
  const int w = (int)(kMaxDynSmem / (2 * (size_t)nz * sizeof(float)));
  return w < 1 ? 1 : (w < kTileCols ? w : kTileCols);
}

int Solve::col_tiles() const { return (nr + z_cols(nz) - 1) / z_cols(nz); }

// Once a process and device: the line kernels may take up to kMaxDynSmem
// of dynamic shared memory, the staged ones with the SM's carveout at its
// largest shared share (the attributes are not set again in the launch
// path).
cudaError_t configure() {
  static unsigned done = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 32 && (done >> dev) & 1u) return cudaSuccess;
  const void* fns[] = {(const void*)k_pcr_r<true>,
                       (const void*)k_pcr_r<false>,
                       (const void*)k_pcr_z_tall, (const void*)k_pcr_row};
  for (const void* fn : fns) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxDynSmem);
    if (e != cudaSuccess) return e;
    if (fn == (const void*)k_pcr_row) continue;
    e = cudaFuncSetAttribute(fn,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  if (dev < 32) done |= 1u << dev;
  return cudaSuccess;
}

const BetaTail kNoTail{nullptr, nullptr, nullptr, 0, 0, 0, 0};

// The r-line row kernel: with `update` (x and r updated by alpha from st,
// p and Ap given) the fused iteration phase, else PCR of r alone.
cudaError_t launch_pcr_r(bool update, float* r, float* x, const float* p,
                         const float* Ap, const float* sm, const float* F,
                         int levels, float* z, double* part_rr,
                         double* part_rz, const CGState* st,
                         const BetaTail& tail, int nz, int nr,
                         long long* counts, cudaStream_t stream) {
  cudaError_t e = configure();
  if (e != cudaSuccess) return e;
  const bool staged = r_staged(nr, levels);
  const size_t smem = pcr_r_smem(nr, levels, staged);
  const dim3 block(1, kRowThreads);
  if (update) {
    k_pcr_r<true><<<nz, block, smem, stream>>>(r, x, p, Ap, sm, F, levels,
                                               staged, z, part_rr, part_rz,
                                               st, tail, nz, nr);
    counts[kPhUpdatePcrR] += 1;
  } else {
    k_pcr_r<false><<<nz, block, smem, stream>>>(r, x, p, Ap, sm, F, levels,
                                                staged, z, part_rr, part_rz,
                                                st, tail, nz, nr);
    counts[kPhPcrR] += 1;
  }
  return cudaGetLastError();
}

cudaError_t launch_pcr_z(const float* r, const float* sm, const float* F,
                         int levels, float* z, double* part_rz,
                         const CGState* st, const BetaTail& tail, int nz,
                         int nr, long long* counts, cudaStream_t stream) {
  cudaError_t e = configure();
  if (e != cudaSuccess) return e;
  const int w = z_cols(nz);
  const size_t smem = 2 * (size_t)nz * w * sizeof(float);
  if (z_short(nz)) {
    k_pcr_z<<<(nr + w - 1) / w, dim3(kZCols, kZRows), smem, stream>>>(
        r, sm, F, levels, z, part_rz, st, tail, nz, nr);
  } else {
    // thread rows: as many as kZTallThreads allows in whole warps (w * rows
    // a multiple of 32: rows a multiple of 32 / gcd(w, 32))
    const int low = w & -w;
    const int step = 32 / (low < 32 ? low : 32);
    const dim3 block(w, (kZTallThreads / w) / step * step);
    k_pcr_z_tall<<<(nr + w - 1) / w, block, smem, stream>>>(
        r, sm, F, levels, w, z, part_rz, st, tail, nz, nr);
  }
  counts[kPhPcrZ] += 1;
  return cudaGetLastError();
}

cudaError_t launch_pcr_row(const float* src, const float* aux, float* store,
                           const float* F, int levels, float scale,
                           const float* acc, const float* sm, float* out,
                           const float* dot, double* part, const CGState* st,
                           int nz, int nr, long long* counts,
                           cudaStream_t stream) {
  cudaError_t e = configure();
  if (e != cudaSuccess) return e;
  const size_t smem = 2 * (size_t)nr * sizeof(float);
  if (smem > kMaxDynSmem) return cudaErrorInvalidValue;
  k_pcr_row<<<nz, kThreads, smem, stream>>>(
      src, aux, store, F, levels, scale, acc, sm, out, dot, part, st, nz, nr);
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
  cudaError_t e = launch_pcr_r(false, s.r, nullptr, nullptr, nullptr, s.sm,
                               s.pcr, s.lr, s.z, nullptr,
                               s.adi() ? nullptr : s.part(2), s.st, kNoTail,
                               s.nz, s.nr, s.counts, s.stream);
  if (e != cudaSuccess || !s.adi()) return e;
  return launch_pcr_z(s.r, s.sm, s.pcrz, s.lz, s.z, s.part(2), s.st, kNoTail,
                      s.nz, s.nr, s.counts, s.stream);
}

cudaError_t finalize(const Solve& s, int mode) {
  k_finalize<<<1, kThreads, 0, s.stream>>>(
      s.st, s.part(1), s.part(2), s.part(3), s.elem_blocks(),
      s.n_rz(), mode, s.rtol, s.maxiter, s.wrt_r0, s.fixed);
  s.counts[kPhFinalize] += 1;
  return cudaGetLastError();
}

// The graph's loop condition: the handle, and the block-run counter (null
// for the start). A null LoopCond* leaves the condition alone.
struct LoopCond {
  cudaGraphConditionalHandle handle;
  unsigned long long* runs;
};

cudaError_t p_update(const Solve& s, int first, const LoopCond* lc) {
  k_p_update<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
      s.p, s.zout(), s.st, first, s.n(), lc != nullptr,
      lc ? lc->handle : 0, lc ? lc->runs : nullptr);
  s.counts[kPhPUpdate] += 1;
  return cudaGetLastError();
}

// The merged-dot tail of a step: w = A u with gamma, delta and <r, r>, the
// scalars, then p and q.
cudaError_t merged_tail(const Solve& s, int first, const LoopCond* lc) {
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
      s.p, s.q(), s.zout(), s.w(), s.st, first, s.n(), lc != nullptr,
      lc ? lc->handle : 0, lc ? lc->runs : nullptr);
  s.counts[kPhPqUpdate] += 1;
  return cudaGetLastError();
}

cudaError_t start(const Solve& s, const LoopCond* lc) {
  cudaError_t e = cudaMemsetAsync(s.st, 0, sizeof(CGState), s.stream);
  if (e != cudaSuccess) return e;
  k_init<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
      s.A, s.npts, s.sm, s.b, s.x0, s.x, s.r, s.part(1), s.part(3), s.nz,
      s.nr);
  s.counts[kPhInit] += 1;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if ((e = precondition(s)) != cudaSuccess) return e;
  if (s.merged) return merged_tail(s, 1, lc);
  if ((e = finalize(s, kFinInit)) != cudaSuccess) return e;
  return p_update(s, 1, lc);
}

// One iteration. The standard recurrence takes alpha in k_stencil_dot's
// tail and beta in the tail of the kernel that writes the last partials:
// identity 3 launches (k_stencil_dot, k_update, k_p_update), r-line 3
// (k_update folded into the row kernel), ADI 4 (+ k_pcr_z); the
// Chebyshev, mgz and multigrid forms keep k_update, their cycle and a
// k_finalize. The merged recurrence keeps its own five-phase sequence.
cudaError_t iterate(const Solve& s, const LoopCond* lc) {
  cudaError_t e;
  if (s.merged) {
    // x += alpha p, r -= alpha q; u = M^-1 r; then the merged tail
    k_update<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
        s.x, s.r, s.p, s.q(), s.part(1), s.st, kNoTail, s.n());
    s.counts[kPhUpdate] += 1;
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if ((e = precondition(s)) != cudaSuccess) return e;
    return merged_tail(s, 0, lc);
  }
  k_stencil_dot<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
      s.A, s.npts, s.sm, s.p, s.Ap, s.part(0), s.st, 1, s.nz, s.nr);
  s.counts[kPhStencilDot] += 1;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (s.rline() && !s.mgz()) {
    const BetaTail tail{s.st, s.part(1), s.part(2), s.nz,
                        s.adi() ? s.col_tiles() : s.nz, s.maxiter, s.fixed};
    e = launch_pcr_r(true, s.r, s.x, s.p, s.Ap, s.sm, s.pcr, s.lr, s.z,
                     s.part(1), s.adi() ? nullptr : s.part(2), s.st,
                     s.adi() ? kNoTail : tail, s.nz, s.nr, s.counts,
                     s.stream);
    if (e == cudaSuccess && s.adi())
      e = launch_pcr_z(s.r, s.sm, s.pcrz, s.lz, s.z, s.part(2), s.st, tail,
                       s.nz, s.nr, s.counts, s.stream);
    if (e != cudaSuccess) return e;
  } else {
    const bool identity = !s.preconditioned();
    const BetaTail tail{s.st, s.part(1), nullptr, s.elem_blocks(), 0,
                        s.maxiter, s.fixed};
    k_update<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
        s.x, s.r, s.p, s.Ap, s.part(1), s.st, identity ? tail : kNoTail,
        s.n());
    s.counts[kPhUpdate] += 1;
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (!identity) {
      if ((e = precondition(s)) != cudaSuccess) return e;
      if ((e = finalize(s, kFinBeta)) != cudaSuccess) return e;
    }
  }
  return p_update(s, 0, lc);
}

cudaError_t finish(const Solve& s, int poison, int* iters) {
  k_finish<<<s.elem_blocks(), kThreads, 0, s.stream>>>(s.x, iters, s.st,
                                                       poison, s.n());
  s.counts[kPhFinish] += 1;
  return cudaGetLastError();
}

// Record a whole solve into the graph being captured on s.stream: the
// start, a conditional WHILE node whose body (captured on `body_stream`,
// its launches counted in counts_body) is `check_every` iterations, and the
// finish. The start's and each body's last kernel set the loop condition
// from the done flag, so the device runs blocks of iterations until the
// solve stops and the host reads nothing before the end.
cudaError_t record_solve(const Solve& s, cudaStream_t body_stream,
                         int check_every, int poison, int* iters,
                         unsigned long long* runs, long long* counts_body) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t e =
      cudaStreamGetCaptureInfo(s.stream, &status, nullptr, &graph);
  if (e != cudaSuccess) return e;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 1,
                                       cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return e;
  const LoopCond at_start{handle, nullptr};
  if ((e = start(s, &at_start)) != cudaSuccess) return e;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  e = cudaStreamGetCaptureInfo(s.stream, &status, nullptr, &graph, &deps,
                               &ndeps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  if ((e = cudaGraphAddNode(&node, graph, deps, ndeps, &params)) !=
      cudaSuccess)
    return e;
  e = cudaStreamUpdateCaptureDependencies(s.stream, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  e = cudaStreamBeginCaptureToGraph(body_stream, body, nullptr, nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  if (e != cudaSuccess) return e;
  Solve b = s;
  b.stream = body_stream;
  b.counts = counts_body;
  const LoopCond at_end{handle, runs};
  for (int it = 0; it < check_every && e == cudaSuccess; ++it)
    e = iterate(b, it == check_every - 1 ? &at_end : nullptr);
  const cudaError_t ended = cudaStreamEndCapture(body_stream, &body);
  if (e != cudaSuccess) return e;
  if (ended != cudaSuccess) return ended;
  return finish(s, poison, iters);
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
      int maxiter, int wrt_r0, long long *counts, const float *lmax,         \
      int cheb, int merged, const float *ac9,             \
      const float *pcrc, int lc, const float *aux, int sweeps, float omega,  \
      float omega_c, float *extra, const void *mg, int fixed

#define HF_SOLVE_INIT                                                        \
  Solve s{A, sm, b, x0, rtol, pcr, pcrz, x, r, z, p, Ap, parts,              \
          (CGState *)state, npts, lr, lz, nz, nr, maxiter, wrt_r0, nparts,   \
          counts, nullptr, lmax, cheb, merged, ac9, pcrc, aux,               \
          lc, sweeps, omega, omega_c, extra, (const MGDesc *)mg, fixed}

extern "C" {

// Entries of each partial-sum plane the solve needs: one an elementwise
// block, a row or a z-line tile (at least one column a tile).
int hf_cg_nparts(int nz, int nr) {
  const int elem = (nz * nr + kThreads - 1) / kThreads;
  int m = elem > nz ? elem : nz;
  return m > nr ? m : nr;
}

int hf_cg_state_bytes() { return (int)sizeof(CGState); }

int hf_num_phases() { return kNumPhases; }

// (Nz, Nr) planes of `extra` a form needs: q and w (merged), d and the
// second z plane (Chebyshev), r1, yc, rcs and res (mgz).
int hf_cg_extra_planes(int cheb, int merged, int mgz) {
  return (merged ? 2 : 0) + (cheb > 0 ? 2 : 0) + (mgz ? 4 : 0);
}

// Capture a whole solve (see record_solve) into an executable graph
// (*exec_out): `counts` receives the launches of its start and finish,
// counts_body those of one block of check_every iterations, whose runs
// the device counts in *runs. The graph reads and writes the buffers
// given here whenever it is launched.
int hf_cg_tol_graph(HF_SOLVE_ARGS, int check_every, int poison, int *iters,
                    void *runs, long long *counts_body, void **exec_out) {
  HF_SOLVE_INIT;
  *exec_out = nullptr;
  if (check_every < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = configure();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t cs, bs;
  if ((e = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking)) !=
      cudaSuccess)
    return (int)e;
  if ((e = cudaStreamCreateWithFlags(&bs, cudaStreamNonBlocking)) !=
      cudaSuccess) {
    cudaStreamDestroy(cs);
    return (int)e;
  }
  s.stream = cs;
  cudaGraph_t graph = nullptr;
  e = cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (e == cudaSuccess) {
    const cudaError_t rec =
        record_solve(s, bs, check_every, poison, iters,
                     (unsigned long long *)runs, counts_body);
    const cudaError_t ended = cudaStreamEndCapture(cs, &graph);
    e = rec != cudaSuccess ? rec : ended;
  }
  if (e == cudaSuccess)
    e = cudaGraphInstantiate((cudaGraphExec_t *)exec_out, graph, 0);
  if (graph != nullptr) cudaGraphDestroy(graph);
  cudaStreamDestroy(bs);
  cudaStreamDestroy(cs);
  return (int)e;
}

int hf_graph_launch(void *exec, void *stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

int hf_graph_destroy(void *exec) {
  return (int)cudaGraphExecDestroy((cudaGraphExec_t)exec);
}

// Single phases, for checking each kernel against its plain version.
// Ap = sm A (sm p) with the <p, Ap> partials; with a state record, also
// the alpha tail on it.
int hf_stencil_dot(const float *A, int npts, const float *sm, const float *p,
                   float *Ap, double *part, void *state, int nz, int nr,
                   long long *counts, void *stream) {
  const int blocks = (nz * nr + kThreads - 1) / kThreads;
  k_stencil_dot<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      A, npts, sm, p, Ap, part, (CGState *)state, state != nullptr, nz, nr);
  counts[kPhStencilDot] += 1;
  return (int)cudaGetLastError();
}

int hf_pcr_r(const float *r, const float *sm, const float *F, int levels,
             float *z, double *part, int nz, int nr, long long *counts,
             void *stream) {
  return (int)launch_pcr_r(false, const_cast<float *>(r), nullptr, nullptr,
                           nullptr, sm, F, levels, z, nullptr, part, nullptr,
                           kNoTail, nz, nr, counts, (cudaStream_t)stream);
}

int hf_pcr_z(const float *r, const float *sm, const float *F, int levels,
             float *z, double *part, int nz, int nr, long long *counts,
             void *stream) {
  return (int)launch_pcr_z(r, sm, F, levels, z, part, nullptr, kNoTail, nz,
                           nr, counts, (cudaStream_t)stream);
}

// The fused iteration phase of the r-line (pcrz null) or ADI form, as the
// solve launches it, on the state record's alpha: x and r updated in
// place, z, the partials (4 x nparts: rr in plane 1, rz in plane 2) and
// the beta tail on the state.
int hf_update_pcr(float *x, float *r, const float *p, const float *Ap,
                  const float *sm, const float *pcr, int lr, const float *pcrz,
                  int lz, float *z, double *parts, int nparts, void *state,
                  int maxiter, int fixed, int nz, int nr, long long *counts,
                  void *stream) {
  Solve s{nullptr, sm, nullptr, nullptr, nullptr, pcr, pcrz, x, r, z,
          const_cast<float *>(p), const_cast<float *>(Ap), parts,
          (CGState *)state, 7, lr, lz, nz, nr, maxiter, 0, nparts, counts,
          (cudaStream_t)stream, nullptr, 0, 0, nullptr, nullptr, nullptr, 0,
          1, 0.0f, 0.0f, nullptr, nullptr, fixed};
  const BetaTail tail{s.st, s.part(1), s.part(2), nz,
                      s.adi() ? s.col_tiles() : nz, maxiter, fixed};
  cudaError_t e = launch_pcr_r(true, r, x, p, Ap, sm, pcr, lr, z, s.part(1),
                               s.adi() ? nullptr : s.part(2), s.st,
                               s.adi() ? kNoTail : tail, nz, nr, counts,
                               s.stream);
  if (e == cudaSuccess && s.adi())
    e = launch_pcr_z(r, sm, pcrz, lz, z, s.part(2), s.st, tail, nz, nr,
                     counts, s.stream);
  return (int)e;
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
                                        n, 0, 0, nullptr);
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
