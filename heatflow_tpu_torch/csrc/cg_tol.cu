// Tolerance-stopped preconditioned CG on the on-the-fly scaled stencil
// operator sm * A * (sm * y), for one (Nz, Nr) problem in float32.
//
// Replaces: heatflow_tpu/ops/pallas_cg.py:_cg_tol_kernel (the Pallas TPU
// kernel that keeps the whole solve resident in VMEM), in its identity,
// r-line, split-additive ADI (r-line + z-line), Chebyshev-polynomial
// and z-semicoarsened two-level multigrid (mgz) forms, with the standard
// recurrence or the Chronopoulos-Gear merged-dot recurrence.
//
// What bounds it on an H100: memory traffic, the latency of dependent
// loads, and the gaps between launches; not arithmetic. At the flagship
// shape (251 x 1107 = 277,857 nodes, one f32 plane is 1.11 MB) an r-line
// iteration must move ~16 planes (~18 MB, ~5.3 us at 3.35 TB/s): the 7
// stencil planes, the vectors (p, Ap, x, r, z, sm) and the r-line's 3
// Thomas factor planes; the ADI form adds the 17-plane z-line PCR stack.
// Shared memory is 227 KB a block: a z-line tile's stack does not fit it,
// and the working set (~18 MB r-line, ~37 MB ADI) fits no block. An
// earlier design ran the r-line as folded PCR too, from a 23-plane stack
// (~34 planes an iteration). The first design, one kernel per CG phase: 6
// launches and ~60 us an r-line iteration (28 us in a PCR kernel whose 11
// levels each waited on dependent global loads), 7 and ~149 us an ADI one,
// and a host read of the stop flag every 8 iterations.
//
// What this design does about that. Times: NVIDIA H100 80GB HBM3, 700 W,
// in-solve by torch.profiler (chip_smoke.py phase 3), solves by CUDA events
// (chip_smoke.py, tools/k1_ab.py against the one-kernel-a-phase design in
// the same run):
// - The r-line factored once, solved by scans. The line operator is fixed
//   for a transient, so k_rline_factor factors every row once per operand
//   set (Thomas' elimination, one thread a row, in float64) into three
//   float32 planes: 3.3 MB in place of the 25.6 MB folded PCR stack that
//   the earlier row kernel staged in every iteration (24.4 us a launch
//   in a solve against a 10.3 us traffic bound; 16-byte copies through L2
//   had made no difference, 11 levels a barrier each). The row kernel (one
//   block a grid row) now requests its row of r and Ap and its three factor
//   planes into shared memory with 4-byte cp.async copies, one group, and
//   solves the row's forward and back substitutions as two block-wide
//   scans of affine maps (a chunk a thread, shuffles within a warp, one
//   step across warps): 22.1 KB a block, six barriers. In the flagship
//   transient (tools/k1_ab.py, in-solve by torch.profiler): 8.68 us a
//   launch against 22.7 (the update with the folded PCR), its traffic
//   bound 3.7 us (11 planes); the stencil pass beside it went from 11.4 to
//   9.4 us with the stack out of L2. k_rline_factor takes 0.79 ms once a
//   transient, while the host still prepares the transient's operands.
//   The z-line kernel holds a tile's PCR factors in registers, each thread
//   requesting the next level's before it computes this one: 21.5 us
//   (bound 14.3), against 35 us for tiles narrowed to fit shared memory
//   and 76 us before.
// - Fewer launches. The scalars ride in the tails of the kernels: each
//   block writes its partial, fences and takes a ticket; the last block
//   reduces the partials in a fixed order (no atomics on the sums, so a
//   solve is bitwise repeatable) and sets alpha (after the stencil) or
//   beta, the count and the stop flag (after the kernel that writes the
//   last partials). An r-line iteration is 3 launches (k_stencil_dot,
//   k_row_update, k_p_update), an ADI one 4 (+ k_pcr_z), an identity one
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
//   543 iterations, 21.1 us an iteration, 11.4 ms (20.7 with the folded PCR
//   rows; 32.4-32.8 with a kernel a phase); ADI 229, 42.9 us, 9.8 ms (14.0;
//   34.2).
//
// The further forms reuse those phases. Chebyshev: each polynomial step is
// one pass (k_cheb_step) that reads z's neighbours from one plane and writes
// the new z into a second one, so no block reads a value another block is
// rewriting; the step coefficients come from the device scalar lmax inside
// the kernel, so no solve waits on a host read. Merged-dot: the vectors q =
// A p and w = A u are kept, gamma, delta and <r, r> are taken in the one
// pass that forms w (k_merged_w), one scalar kernel forms beta and the
// coupled alpha (k_finalize_merged), and one pass updates p and q
// (k_pq_update): 4 launches an identity iteration (k_update, k_merged_w,
// k_finalize_merged, k_pq_update), at one more plane of traffic than the
// standard recurrence; these forms keep k_update and a k_finalize of their
// own and share the graph loop.
//
// mgz, the z-semicoarsened V(1,1) cycle (the mgz branch of _cg_tol_kernel,
// operands from ops/mgz.py): its working set (A, the fine and the coarse
// stacks, aux, ~10 planes: 75-85 MB at the flagship) does not fit the 50 MB
// L2, so each pass streams from HBM, and each pass was a launch (11 an
// iteration with one coarse sweep, 13 with two). This design: 6 launches an
// iteration with one sweep, 7 with two. k_stencil_dot (alpha tail); the
// pre-smoothing row (k_row_update: the row kernel of the r-line form, its
// factors staged by cp.async, the CG update of x and r in its load); the
// coarse row (k_row_restrict, 1024 threads a block on the even rows only:
// the odd rows of the embedded coarse grid have zero couplings, unit
// diagonal and zero restriction weights, so there d = 0 and the block
// writes out = omega_c 0 without a line solve) with the fine residual formed on
// rows i-1 .. i+1 in its load from sm z staged in shared memory, then
// restricted; a further sweep's coarse residual in the next coarse row's
// load (k_row_coarse_res, into the other of two coarse planes); the
// prolongation with the second residual in one pass (k_mgz_prolong_res:
// the prolongated iterate formed at the point and its stencil neighbours);
// the post-smoothing row (k_row_plain, with the mask, the <r, z> partials
// and the beta tail); k_p_update. The row kernel requests its epilogue's
// operands before the line solve. With the earlier folded PCR rows:
// NVIDIA H100 80GB HBM3, 700 W, first-step
// solve (tools/mg_ab.py, in-solve by torch.profiler): one sweep 179
// iterations, 103.4-104.7 us an iteration (141.6-143.0 before), two sweeps
// 137 and 122.5-123.6 (178.2-179.3); in-solve the coarse row 32.9 us, the
// post row 24.6, the pre row 20.3, the prolongation 10.9.
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
// its compiler has no gathers; here a restriction gathers in a fixed order
// (no atomics, so a cycle is repeatable bitwise). The coarse levels (18 k
// and 4.7 k points on the flagship) are bound by latency, not traffic: a
// cycle of four levels was 31 launches. This design, 15 launches an
// iteration: level 0's first smoothing step takes the CG update (it reads r
// at its own point only) and its last the beta tail; a level's first step
// from zero is pointwise, so the other levels form it inside their second
// (k_mg_step, from_b); a restriction forms the residual once a fine point
// of its tile in shared memory (k_mg_restrict_res); a prolongation is
// formed inside the first post-smoothing step that reads it; 1 / diag(C)
// is a plane the wrapper forms once a level; and the coarsest level's
// right-hand side and its nu_coarse steps are one launch with no barrier
// between blocks (k_mg_last: each block a tile grown by a halo of
// nu_coarse - 1, in shared memory). Running the lower levels inside one
// thread-block cluster under cluster barriers instead was measured and
// dropped: a barrier alone costs 0.77 us, a pass over the 4.7 k points
// 2.3 us and over the 18 k 5-7 us, no faster than a launch in a graph. At
// 1e-5 on the flagship's first-step system: 120.6-121.3 us an iteration
// (145.0-145.9 before), in-solve the smoothing steps 64.9 us (10
// launches), the restrictions 21.2, the coarsest level 18.0 (8 x 8 tiles;
// 28.4 at 16 x 32, where fewer blocks each form more fine residuals in
// turn). The second
// is the standard loop with the stop test switched off (`fixed`), sm = 1
// and no preconditioner: no host read during the solve.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;     // elementwise and finalize blocks
constexpr int kTileCols = 16;     // k_pcr_z_tall: columns a block at most
constexpr int kRowThreads = 512;  // r-line row kernel: threads a block
constexpr int kCoarseThreads = 1024;  // the mgz coarse rows: one block an SM
constexpr int kZCols = 8;         // z-line kernel: columns a block,
constexpr int kZRows = 32;        // thread rows a block,
constexpr int kZPer = 8;          // rows a thread (Nz <= kZRows * kZPer)
constexpr int kZTallThreads = 512;  // z-line kernel for taller columns
// The most dynamic shared memory a block may ask for (227 KB opt-in, less
// the static shared memory of block_sum, last_block and the row kernel's
// scan totals: 784 bytes).
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
  kPhFinalizeMerged, kPhPqUpdate, kPhMgzPre, kPhMgzCoarse, kPhMgzCoarseRes,
  kPhMgzProlongRes, kPhMgzPost, kPhMgCheb, kPhMgChebUpdate, kPhMgChebPre,
  kPhMgRestrictRes, kPhMgProlongCheb, kPhMgLast, kPhUpdatePcrR, kNumPhases
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
// of heatflow_tpu_torch/ops/stencil.py: OFFSETS, then OFFSETS9's two. A
// neighbour outside the grid is read at the point itself and its term not
// added, so that the loads carry no branch and are issued together.
// The same with the scaled iterate u = sm . v given as a function of the
// grid point.
template <class U>
__device__ __forceinline__ float stencil_u(const float* __restrict__ A,
                                           int npts, U u, int i, int j,
                                           int nz, int nr) {
  const int n = nz * nr;
  const int idx = i * nr + j;
  float out = A[idx] * u(i, j);
  const int di[8] = {1, -1, 0, 0, 1, -1, 1, -1};
  const int dj[8] = {0, 0, 1, -1, 1, -1, -1, 1};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= npts - 1) break;
    const int ii = i + di[k], jj = j + dj[k];
    const bool in = ii >= 0 && ii < nz && jj >= 0 && jj < nr;
    const float t = A[(k + 1) * n + idx] * u(in ? ii : i, in ? jj : j);
    out = in ? out + t : out;
  }
  return out;
}

__device__ __forceinline__ float stencil_at(const float* __restrict__ A,
                                            int npts,
                                            const float* __restrict__ sm,
                                            const float* __restrict__ v,
                                            int i, int j, int nz, int nr) {
  return stencil_u(
      A, npts, [&](int ii, int jj) { return sm[ii * nr + jj] * v[ii * nr + jj]; },
      i, j, nz, nr);
}

// (C v)[i, j] for a baked 7-point (or 9-point) level operator of the
// multigrid cycle: no scaling, the same accumulation order and the same
// branch-free loads; the iterate is a function of the grid point (a plane,
// or a plane plus the prolongated coarse correction).
template <class V>
__device__ __forceinline__ float level_stencil_at(const float* __restrict__ C,
                                                  int npts, V v, int i, int j,
                                                  int nz, int nr) {
  const int n = nz * nr;
  const int idx = i * nr + j;
  float out = C[idx] * v(i, j);
  const int di[8] = {1, -1, 0, 0, 1, -1, 1, -1};
  const int dj[8] = {0, 0, 1, -1, 1, -1, -1, 1};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= npts - 1) break;
    const int ii = i + di[k], jj = j + dj[k];
    const bool in = ii >= 0 && ii < nz && jj >= 0 && jj < nr;
    const float t = C[(k + 1) * n + idx] * v(in ? ii : i, in ? jj : j);
    out = in ? out + t : out;
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
  const int n = nz * nr;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  double rr = 0.0, bb = 0.0;
  if (idx < n) {
    const int i = idx / nr, j = idx - i * nr;
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
  const int n = nz * nr;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  double acc = 0.0;
  if (idx < n) {
    const int i = idx / nr, j = idx - i * nr;
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

// ---- line solves -----------------------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The lines a block solves: `len` positions of `w` adjacent lines, of which
// the first `valid` exist; position i of line c lies at base + i * stride
// + c in a plane. In shared memory they are position-major: e = i * w + c.
// Thread (x, y) takes line x and positions y, y + blockDim.y, ...
struct Lines {
  size_t base, stride;
  int len, w, valid;
};

// The folded PCR levels of stack F (2L+1 planes of n values, read from
// device memory) on the block's lines, d0 holding them on entry; returns
// the buffer that holds the result. Level k (s = 2^k):
//   d[i] <- d[i] - F[2k][i] d[i-s] - F[2k+1][i] d[i+s]   (zeros outside).
__device__ float* pcr_levels(float* d0, float* d1,
                             const float* __restrict__ F, size_t n,
                             int levels, const Lines& ln) {
  const int c = threadIdx.x;
  int s = 1;
  for (int k = 0; k < levels; ++k) {
    __syncthreads();  // the previous level's d landed
    const float* lo = F + (2 * k) * n;
    const float* up = F + (2 * k + 1) * n;
    if (c < ln.valid) {
      for (int i = threadIdx.y; i < ln.len; i += blockDim.y) {
        const int e = i * ln.w + c;
        const size_t q = ln.base + (size_t)i * ln.stride + c;
        float v = d0[e];
        if (i - s >= 0) v = v - lo[q] * d0[e - s * ln.w];
        if (i + s < ln.len) v = v - up[q] * d0[e + s * ln.w];
        d1[e] = v;
      }
    }
    float* t = d0; d0 = d1; d1 = t;
    s <<= 1;
  }
  __syncthreads();
  return d0;
}

// The r-line systems x_j + l_j x_{j-1} + u_j x_{j+1} = d_j of a grid row
// (unit diagonal: (l, u) are the couplings of sm A sm along r, zero across
// a Dirichlet point and past the ends; SPD, so LU without pivoting is
// stable), factored once per operand set by Thomas' elimination, one
// thread a row sweeping it in float64: den_0 = 1, den_j = 1 - l_j cp_{j-1},
// and three float32 planes F[0] = m_j = -l_j / den_{j-1} (the forward
// multiplier), F[1] = 1 / den_j (the inverse pivot), F[2] = cp_j = u_j /
// den_j. The couplings are formed in float32 as
// heatflow_tpu_torch/ops/linesolve.py:line_couplings forms them, and the
// sweep rounds each product and difference alone (no contraction), so the
// factors are the plain version's (ops/linesolve.py:thomas_factor_lines).
__global__ void k_rline_factor(const float* __restrict__ A,
                               const float* __restrict__ s,
                               const float* __restrict__ fmask,
                               float* __restrict__ F, int nz, int nr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nz) return;
  const size_t n = (size_t)nz * nr;
  const size_t row = (size_t)i * nr;
  const float* up = A + 3 * n + row;  // couples j -> j+1
  const float* lo = A + 4 * n + row;  // couples j -> j-1
  const float* sr = s + row;
  const float* fr = fmask + row;
  double den_prev = 1.0, cp = 0.0;
  float sf_prev = 0.0f, sf = __fmul_rn(sr[0], fr[0]);
  for (int j = 0; j < nr; ++j) {
    const float sf_next =
        j + 1 < nr ? __fmul_rn(sr[j + 1], fr[j + 1]) : 0.0f;
    const double l = (double)__fmul_rn(__fmul_rn(sf, lo[j]), sf_prev);
    const double u = (double)__fmul_rn(__fmul_rn(sf, up[j]), sf_next);
    const double den = __dsub_rn(1.0, __dmul_rn(l, cp));
    F[row + j] = (float)(-l / den_prev);
    F[n + row + j] = (float)(1.0 / den);
    cp = u / den;
    F[2 * n + row + j] = (float)cp;
    den_prev = den;
    sf_prev = sf;
    sf = sf_next;
  }
}

// The value entering this thread's link of a chain of affine maps
// v <- a v + b, one link a thread (the composition of its chunk's maps),
// chained in thread order (`reverse`: in reverse thread order) from v = 0:
// an inclusive scan of the links across each warp by shuffles, then one
// across the block's warp totals (at most 32 warps) through `tot` in
// shared memory. The block is a whole number of warps.
__device__ float chain_carry(float a, float b, bool reverse, float2* tot) {
  const unsigned full = 0xffffffffu;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nw = (blockDim.x * blockDim.y) >> 5;
  const int lane = tid & 31;
  const int pos = reverse ? 31 - lane : lane;          // in chain order
  const int w = reverse ? nw - 1 - (tid >> 5) : tid >> 5;
  auto take = [&](float v, int o) {
    return reverse ? __shfl_down_sync(full, v, o) : __shfl_up_sync(full, v, o);
  };
  // (a, b) <- this link after the earlier ones: v -> a (pa v + pb) + b
  for (int o = 1; o < 32; o <<= 1) {
    const float pa = take(a, o), pb = take(b, o);
    if (pos >= o) {
      b = fmaf(a, pb, b);
      a = a * pa;
    }
  }
  // the warp's links before this one, and the warp's total
  float ea = take(a, 1), eb = take(b, 1);
  if (pos == 0) {
    ea = 1.0f;
    eb = 0.0f;
  }
  if (pos == 31) tot[w] = make_float2(a, b);
  __syncthreads();
  if (tid < 32) {
    float2 t = tid < nw ? tot[tid] : make_float2(1.0f, 0.0f);
    for (int o = 1; o < 32; o <<= 1) {
      const float pa = __shfl_up_sync(full, t.x, o);
      const float pb = __shfl_up_sync(full, t.y, o);
      if (tid >= o) {
        t.y = fmaf(t.x, pb, t.y);
        t.x = t.x * pa;
      }
    }
    if (tid < nw) tot[tid] = t;
  }
  __syncthreads();
  return fmaf(ea, w > 0 ? tot[w - 1].y : 0.0f, eb);
}

// x = T^-1 d on the block's row d in shared memory, in place, from the
// row's Thomas factors (fm, fi, fc: F[0..2] of k_rline_factor, in shared or
// device memory). The forward substitution w_j = m_j w_{j-1} + d_j and the
// back substitution x_j = w_j / den_j - cp_j x_{j+1} are each a chain of
// affine maps: thread t composes the maps of its contiguous chunk of
// ceil(nr / threads) points, chain_carry scans the chunks, and the thread
// reruns its chunk from the value that enters it. Six barriers; tot: two
// arrays of 32 in shared memory.
__device__ void thomas_row(float* d, const float* fm, const float* fi,
                           const float* fc, int nr, float2 (*tot)[32]) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const int per = (nr + nt - 1) / nt;
  const int j0 = min(tid * per, nr), j1 = min(j0 + per, nr);
  __syncthreads();  // the row and the staged factors landed
  float a = 1.0f, b = 0.0f;
  for (int j = j0; j < j1; ++j) {
    b = fmaf(fm[j], b, d[j]);
    a = a * fm[j];
  }
  float v = chain_carry(a, b, false, tot[0]);
  for (int j = j0; j < j1; ++j) {
    v = fmaf(fm[j], v, d[j]);
    d[j] = fi[j] * v;
  }
  a = 1.0f;
  b = 0.0f;
  for (int j = j1 - 1; j >= j0; --j) {
    b = fmaf(-fc[j], b, d[j]);
    a = a * -fc[j];
  }
  v = chain_carry(a, b, true, tot[1]);
  for (int j = j1 - 1; j >= j0; --j) {
    v = fmaf(-fc[j], v, d[j]);
    d[j] = v;
  }
  __syncthreads();
}

// The row kernel of the r-line forms, one block a z-row. Its shared memory
// is the row and a second row buffer and, when staged, the row's three
// Thomas factor planes (F[0..2] of k_rline_factor, 13.3 KB on the
// flagship). At its start the block requests its row's vectors and its
// factors into shared memory, one group of asynchronous copies. What the
// block loads as its row d (kLoad):
//   kRowPlain      d = r's row;
//   kRowUpdate     the CG update of its row, r -= alpha Ap (in place, with
//                  the row's partial of <r, r>) and x += alpha p; d = r's row
//                  (the r-line form's whole iteration after A p, and the
//                  mgz cycle's pre-smoothing);
//   kRowRestrict   the mgz cycle's first coarse sweep: the fine residual
//                  r1 = r - sm A (sm z) formed on fine rows i-1, i, i+1 and
//                  restricted onto the embedded coarse row i,
//                    d = sc (e_free r1[i] + (pp r1)[i-1] + (pm r1)[i+1]),
//                  stored into `store` when given;
//   kRowCoarseRes  a later coarse sweep: d = rcs - Ac9 y on coarse row i.
// Then the row's line solve T^-1 d from its factors (thomas_row), and
//   out = (acc + scale T^-1 d) * mask    (acc, mask = (sm != 0) optional)
// with optionally the row's partial of <dot, out>, and the beta tail. The
// two coarse modes run on the even rows only (block b: row 2b). The odd
// rows of the embedded coarse grid have zero couplings and unit diagonal,
// and every restriction weight is zero on them (ops/mgz.py), so there d is
// 0 and so is its solve: the block also writes the odd row below its own as
// out = acc + scale 0, and 0 into `store`.
enum RowLoad { kRowPlain = 0, kRowUpdate, kRowRestrict, kRowCoarseRes };

struct RowArgs {
  float* r;                 // the row (kRowUpdate: updated in place)
  float* x;                 // kRowUpdate: x, p, Ap
  const float *p, *Ap;
  const float* sm;          // the free mask; the scaling of kRowRestrict
  const float* F;           // the row factors, 3 planes (k_rline_factor)
  int staged;               // F staged in shared memory
  float scale;
  const float* acc;         // optional
  int mask;
  float* out;
  const float* dot;         // optional: partials of <dot, out> in part_dot
  double *part_rr, *part_dot;
  const CGState* st;
  BetaTail tail;
  const float *A, *z, *aux; // kRowRestrict: operator, iterate, [sc, pm, pp, ef]
  int npts;
  float* store;             // kRowRestrict: the restricted row (optional)
  const float *ac9, *rcs, *y;  // kRowCoarseRes
  int nz, nr;
};

// out = rcs - Ac9 y's operator part at (i, j): the embedded coarse 9-point
// stencil, z-offsets +-2 fine rows (the plane order of
// heatflow_tpu_torch/ops/mgz.py: MGZ_OFFSETS), zeros outside the grid.
__device__ __forceinline__ float coarse_apply_at(const float* __restrict__ Ac9,
                                                 const float* __restrict__ y,
                                                 int i, int j, int nz,
                                                 int nr) {
  const int n = nz * nr;
  const int idx = i * nr + j;
  const int di[8] = {2, -2, 0, 0, 2, -2, 2, -2};
  const int dj[8] = {0, 0, 1, -1, 1, -1, -1, 1};
  float acc = Ac9[idx] * y[idx];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int ii = i + di[k], jj = j + dj[k];
    const bool in = ii >= 0 && ii < nz && jj >= 0 && jj < nr;
    const float t = Ac9[(k + 1) * n + idx] * y[in ? ii * nr + jj : idx];
    acc = in ? acc + t : acc;
  }
  return acc;
}

template <int kLoad>
__device__ __forceinline__ void row_pass(const RowArgs& a) {
  if (a.st != nullptr && a.st->done) return;
  extern __shared__ float smem[];
  __shared__ float2 tot[2][32];
  constexpr bool kEven = kLoad == kRowRestrict || kLoad == kRowCoarseRes;
  const int nz = a.nz, nr = a.nr;
  const size_t n = (size_t)nz * nr;
  const int i = kEven ? 2 * blockIdx.x : blockIdx.x;
  const size_t row = (size_t)i * nr;
  float* d0 = smem;
  float* d1 = smem + nr;
  float* fs = smem + 2 * nr;
  for (int j = threadIdx.y; j < nr; j += blockDim.y) {
    if (!kEven) {
      cp_async4(d0 + j, a.r + row + j);
      if (kLoad == kRowUpdate) cp_async4(d1 + j, a.Ap + row + j);
    }
    if (a.staged)
      for (int q = 0; q < 3; ++q)
        cp_async4(fs + q * nr + j, a.F + q * n + row + j);
  }
  cp_async_commit();
  const float* fm = a.staged ? fs : a.F + row;
  const float* fi = a.staged ? fs + nr : a.F + n + row;
  const float* fc = a.staged ? fs + 2 * nr : a.F + 2 * n + row;
  const float alpha = kLoad == kRowUpdate ? (float)a.st->alpha : 0.0f;
  double rr = 0.0;
  if (!kEven) {
    // this thread's own row copies landed; it reads only those
    cp_async_wait_all();
    if (kLoad == kRowUpdate) {
      for (int j = threadIdx.y; j < nr; j += blockDim.y) {
        const float rv = d0[j] - alpha * d1[j];
        d0[j] = rv;
        a.r[row + j] = rv;
        rr += (double)(rv * rv);
      }
    }
  } else if (kLoad == kRowRestrict) {
    const float* sc = a.aux;
    const float* pm = a.aux + n;
    const float* pp = a.aux + 2 * n;
    const float* ef = a.aux + 3 * n;
    // sm . z on fine rows i-2 .. i+2 (clamped: a row past an end is never
    // read) into shared memory, while the factors stream in; then the fine
    // residual at (k, j), r - sm A (sm . z), with stencil_at's arithmetic
    float* us = fs + (a.staged ? 3 * nr : 0);
    for (int t = threadIdx.y; t < 5 * nr; t += blockDim.y) {
      const int rw = t / nr, j = t - rw * nr;
      const int q = min(max(i - 2 + rw, 0), nz - 1) * nr + j;
      us[t] = a.sm[q] * a.z[q];
    }
    __syncthreads();
    auto u = [&](int k, int j) { return us[(k - i + 2) * nr + j]; };
    auto res = [&](int k, int j) {
      const int q = k * nr + j;
      return a.r[q] - a.sm[q] * stencil_u(a.A, a.npts, u, k, j, nz, nr);
    };
    // rows past the ends are read at row i and their terms are 0
    const int im = i >= 1 ? i - 1 : i, ip = i + 1 < nz ? i + 1 : i;
    for (int j = threadIdx.y; j < nr; j += blockDim.y) {
      const float r0 = res(i, j), rm = res(im, j), rp = res(ip, j);
      float rc = ef[row + j] * r0;
      rc += i >= 1 ? pp[row - nr + j] * rm : 0.0f;
      rc += i + 1 < nz ? pm[row + nr + j] * rp : 0.0f;
      const float v = sc[row + j] * rc;
      d0[j] = v;
      if (a.store != nullptr) a.store[row + j] = v;
    }
  } else {
    for (int j = threadIdx.y; j < nr; j += blockDim.y)
      d0[j] = a.rcs[row + j] - coarse_apply_at(a.ac9, a.y, i, j, nz, nr);
  }
  // The epilogue's operands of this thread's first kEpi points (x and p,
  // acc, sm, dot) are requested before the line solve, so that they arrive
  // while it runs.
  constexpr int kEpi = 3;
  float ex[kEpi] = {}, ep[kEpi] = {}, ea[kEpi] = {}, es[kEpi] = {},
        ed[kEpi] = {};
#pragma unroll
  for (int m = 0; m < kEpi; ++m) {
    const int j = threadIdx.y + m * blockDim.y;
    if (j < nr) {
      if (kLoad == kRowUpdate) {
        ex[m] = a.x[row + j];
        ep[m] = a.p[row + j];
      }
      if (a.acc != nullptr) ea[m] = a.acc[row + j];
      if (a.mask) es[m] = a.sm[row + j];
      if (a.dot != nullptr) ed[m] = a.dot[row + j];
    }
  }
  cp_async_wait_all();
  thomas_row(d0, fm, fi, fc, nr, tot);
  double dsum = 0.0;
  // out = (acc + scale T^-1 d) * mask at point j, with its <dot, out> term
  auto epilogue = [&](int j, float xv, float pv, float av, float sv,
                      float dv) {
    if (kLoad == kRowUpdate) a.x[row + j] = xv + alpha * pv;
    float v = a.scale * d0[j];
    if (a.acc != nullptr) v = av + v;
    if (a.mask) v = v * (sv != 0.0f ? 1.0f : 0.0f);
    a.out[row + j] = v;
    if (a.dot != nullptr) dsum += (double)(dv * v);
  };
#pragma unroll
  for (int m = 0; m < kEpi; ++m) {
    const int j = threadIdx.y + m * blockDim.y;
    if (j < nr) epilogue(j, ex[m], ep[m], ea[m], es[m], ed[m]);
  }
  for (int j = threadIdx.y + kEpi * blockDim.y; j < nr; j += blockDim.y)
    epilogue(j, kLoad == kRowUpdate ? a.x[row + j] : 0.0f,
             kLoad == kRowUpdate ? a.p[row + j] : 0.0f,
             a.acc != nullptr ? a.acc[row + j] : 0.0f,
             a.mask ? a.sm[row + j] : 0.0f,
             a.dot != nullptr ? a.dot[row + j] : 0.0f);
  if (kEven && i + 1 < nz) {
    const size_t orow = row + nr;
    for (int j = threadIdx.y; j < nr; j += blockDim.y) {
      float v = a.scale * 0.0f;
      if (a.acc != nullptr) v = a.acc[orow + j] + v;
      a.out[orow + j] = v;
      if (a.store != nullptr) a.store[orow + j] = 0.0f;
    }
  }
  const bool tid0 = threadIdx.x == 0 && threadIdx.y == 0;
  if (a.part_rr != nullptr) {
    rr = block_sum(rr);
    if (tid0) a.part_rr[blockIdx.x] = rr;
  }
  if (a.dot != nullptr) {
    dsum = block_sum(dsum);
    if (tid0) a.part_dot[blockIdx.x] = dsum;
  }
  beta_tail(a.tail);
}

// The row kernel's instantiations, one name a load mode.
__global__ void __launch_bounds__(kRowThreads, 2)
    k_row_plain(const __grid_constant__ RowArgs a) {
  row_pass<kRowPlain>(a);
}

__global__ void __launch_bounds__(kRowThreads, 2)
    k_row_update(const __grid_constant__ RowArgs a) {
  row_pass<kRowUpdate>(a);
}

__global__ void __launch_bounds__(kCoarseThreads, 1)
    k_row_restrict(const __grid_constant__ RowArgs a) {
  row_pass<kRowRestrict>(a);
}

__global__ void __launch_bounds__(kCoarseThreads, 1)
    k_row_coarse_res(const __grid_constant__ RowArgs a) {
  row_pass<kRowCoarseRes>(a);
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
  d0 = pcr_levels(d0, d1, F, n, levels, ln);
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
  const int n = nz * nr;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  double acc = 0.0;
  if (idx < n) {
    const int i = idx / nr, j = idx - i * nr;
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
  const int n = nz * nr;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  double dl = 0.0, rr = 0.0, ga = 0.0;
  if (idx < n) {
    const int i = idx / nr, j = idx - i * nr;
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

// The mgz cycle's prolongation of the coarse correction, at (k, j):
//   x + e_free (sc y)[k] + pm (sc y)[k-1] + pp (sc y)[k+1]   (0 past the ends)
// with aux = [sc, pm, pp, e_free], in the order of the plain version.
__device__ __forceinline__ float mgz_prolong_at(const float* __restrict__ x,
                                                const float* __restrict__ y,
                                                const float* __restrict__ aux,
                                                int k, int j, int nz, int nr) {
  const int n = nz * nr;
  const int idx = k * nr + j;
  const float* sc = aux;
  const float* pm = aux + n;
  const float* pp = aux + 2 * n;
  const float* ef = aux + 3 * n;
  const int qm = k >= 1 ? idx - nr : idx, qp = k + 1 < nz ? idx + nr : idx;
  const float lo = sc[qm] * y[qm], hi = sc[qp] * y[qp];
  float v = x[idx] + ef[idx] * (sc[idx] * y[idx]);
  v += pm[idx] * (k >= 1 ? lo : 0.0f);
  v += pp[idx] * (k + 1 < nz ? hi : 0.0f);
  return v;
}

// The mgz cycle's prolongation fused into its second residual: with
// zp = z + P (sc y) formed at the point and at its stencil neighbours,
//   zout = zp,  r1 = r - sm A (sm zp)
// (zout is another plane than z: other blocks read z's neighbours).
__global__ void k_mgz_prolong_res(const float* __restrict__ A, int npts,
                                  const float* __restrict__ sm,
                                  const float* __restrict__ r,
                                  const float* __restrict__ z,
                                  const float* __restrict__ y,
                                  const float* __restrict__ aux,
                                  float* __restrict__ zout,
                                  float* __restrict__ r1, const CGState* st,
                                  int nz, int nr) {
  if (st != nullptr && st->done) return;
  const int n = nz * nr;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int i = idx / nr, j = idx - i * nr;
  const float zc = mgz_prolong_at(z, y, aux, i, j, nz, nr);
  // (A (sm . zp))[i, j] in stencil_at's order
  float out = A[idx] * (sm[idx] * zc);
  const int di[8] = {1, -1, 0, 0, 1, -1, 1, -1};
  const int dj[8] = {0, 0, 1, -1, 1, -1, -1, 1};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= npts - 1) break;
    const int ii = i + di[k], jj = j + dj[k];
    if (ii >= 0 && ii < nz && jj >= 0 && jj < nr) {
      const int q = ii * nr + jj;
      out += A[(k + 1) * n + idx] *
             (sm[q] * mgz_prolong_at(z, y, aux, ii, jj, nz, nr));
    }
  }
  zout[idx] = zc;
  r1[idx] = r[idx] - sm[idx] * out;
}

// ---- the multigrid cycle (K6) ---------------------------------------------

// The multigrid V-cycle's levels, finest first, built by the Python wrapper
// (heatflow_tpu_torch/ops/cuda_mg.py mirrors both records with ctypes) in
// host memory: device pointers, shapes, and the Chebyshev coefficients the
// host computed in float32 from each level's eigenvalue bound (c1[k], c2[k]
// belong to step k + 1). dinv is 1 / diag(C) (1 where the diagonal is 0),
// formed once per level by the wrapper; wz (nz/2) and wr (nr/2) are the
// transfer weights between this level and the next; b, xa, xb and d are
// scratch planes of the level's shape (level 0 needs no b: its right-hand
// side is the CG residual).
constexpr int kMaxLevels = 8;
constexpr int kMaxCheb = 32;

struct MGLevel {
  const float *C, *dinv, *wz, *wr;
  float *b, *xa, *xb, *d;
  int npts, nz, nr;
  float theta;
  float c1[kMaxCheb], c2[kMaxCheb];
};

struct MGDesc {
  int n_levels, nu, nu_coarse, reserved;
  MGLevel lv[kMaxLevels];
};

// The plane a level's smoothing step writes after reading `cur` (null:
// from zero): the first step from zero writes xa, then the planes
// alternate; and the plane that holds the iterate after `steps` steps.
__host__ __device__ inline float* mg_next(const MGLevel& L, const float* cur) {
  return cur == L.xa ? L.xb : L.xa;
}

__host__ __device__ inline float* mg_after(const MGLevel& L, const float* x_in,
                                           int steps) {
  float* cur = const_cast<float*>(x_in);
  for (int k = 0; k < steps; ++k) cur = mg_next(L, cur);
  return cur;
}

// x(i, j) + (P xc)(i, j): the bilinear prolongation of the coarse correction
// (its leading ((nz+1)/2, (nr+1)/2) part), with the fine iterate x and the
// coarse one xc given as functions of the grid point: along r then along
// z, fine 2i+1 takes w[i] of coarse i and (1 - w[i]) of coarse i+1. Every
// value is read, at row I (even i) and column J (even j) where the coarse
// point I+1 or J+1 is not used, so that the loads carry no branch.
template <class X, class XC>
__device__ __forceinline__ float mg_prolong_at(X x, XC xc,
                                               const float* __restrict__ wz,
                                               const float* __restrict__ wr,
                                               int i, int j) {
  const int I = i >> 1, J = j >> 1;
  const bool zo = i & 1, ro = j & 1;
  const int I1 = zo ? I + 1 : I, J1 = ro ? J + 1 : J;
  const float w = wr[ro ? J : 0], u = wz[zo ? I : 0];
  const float a0 = xc(I, J), b0 = xc(I, J1), a1 = xc(I1, J), b1 = xc(I1, J1);
  // the r-prolonged coarse rows I and I+1
  const float rows0 = ro ? w * a0 + (1.0f - w) * b0 : a0;
  const float rows1 = ro ? w * a1 + (1.0f - w) * b1 : a1;
  const float add = zo ? u * rows0 + (1.0f - u) * rows1 : rows0;
  return x(i, j) + add;
}

// The restriction (the transpose of the bilinear prolongation) of level L's
// residual v = b - C x (a function of the grid point) onto coarse point
// (I, J) of the next level: along z then along r, coarse i takes fine 2i,
// w[i] of fine 2i+1 and (1 - w[i-1]) of fine 2i-1, summed in that order.
// Points past the coarse grid ((nz+1)/2, (nr+1)/2), the next level's odd
// padding, get 0.
template <class V>
__device__ float mg_restrict_at(const MGLevel& L, V v, int I, int J) {
  const int nz = L.nz, nr = L.nr;
  const int mz = (nz + 1) / 2, mr = (nr + 1) / 2;
  if (I >= mz || J >= mr) return 0.0f;
  const bool hi = I < mz - 1, lo = I >= 1;
  const float wz_lo = hi ? L.wz[I] : 0.0f;
  const float wz_hi = lo ? 1.0f - L.wz[I - 1] : 0.0f;
  float cols[3] = {0.0f, 0.0f, 0.0f};   // z-restricted columns 2J-1, 2J, 2J+1
  // the nine values are read unconditionally (past an end: at a point
  // inside, their terms not added), so that their loads are issued together
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int jf = 2 * J - 1 + c;
    const bool in = jf >= 0 && jf < nr;
    const int jc = in ? jf : 2 * J;
    const float a = v(2 * I, jc);
    const float bh = v(hi ? 2 * I + 1 : 2 * I, jc);
    const float bl = v(lo ? 2 * I - 1 : 2 * I, jc);
    float s = a;
    s = hi ? s + wz_lo * bh : s;
    s = lo ? s + wz_hi * bl : s;
    cols[c] = in ? s : 0.0f;
  }
  float s = cols[1];
  if (J < mr - 1) s += L.wr[J] * cols[2];
  if (J >= 1) s += (1.0f - L.wr[J - 1]) * cols[0];
  return s;
}

// One Chebyshev smoothing step on D^-1 C of a multigrid level at one point,
// for the right-hand side res (b there): with an iterate x_in (a function
// of the grid point; none for a first step from zero)
//   res = b - C x_in,
//   first step:  d = dinv res / theta
//   later steps: d = c1 d + c2 (dinv res)
// and returns x_in + d (with *d_io the point's d, read and written).
template <class X>
__device__ __forceinline__ float mg_step_point(const float* __restrict__ C,
                                               int npts, float dinv,
                                               float res, X x_in, bool has_x,
                                               float* d_io, int first,
                                               float theta, float c1,
                                               float c2, int i, int j, int nz,
                                               int nr) {
  float xv = 0.0f;
  if (has_x) {
    xv = x_in(i, j);
    res = res - level_stencil_at(C, npts, x_in, i, j, nz, nr);
  }
  const float dv = first ? dinv * res / theta : c1 * *d_io + c2 * (dinv * res);
  *d_io = dv;
  return xv + dv;
}

// One smoothing step of a level as its own pass, one thread a point, for
// the right-hand side b, from x_in (null: zero) into x_out, another plane
// than x_in (the stencil reads x_in's neighbours while other blocks write
// x_out). With xc, the iterate read is x_in + P xc (the prolongation fused
// into the first post-smoothing step). With p (level 0's first step, from
// zero), the CG update comes first at the point, x += alpha p, r -= alpha
// Ap (b is r), with its <r, r> partial. With `mask` (the CG scaling plane
// sm) the result is multiplied by (sm > 0); with `dot` the <dot, x_out>
// partial is written.
struct MGStep {
  const float *C, *dinv, *b, *x_in;
  float *d, *x_out;
  int npts, nz, nr, first;
  float theta, c1, c2;
  const float *xc, *wz, *wr;
  int cstride;
  const float *mask, *dot;
  double* part;
  float *r, *x;
  const float *p, *Ap;
  double* part_rr;
  int from_b;   // x_in is the first step from zero, formed from b and dinv
};

__global__ void k_mg_step(const __grid_constant__ MGStep s, const CGState* st,
                          const __grid_constant__ BetaTail tail) {
  if (st != nullptr && st->done) return;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  double rr = 0.0, acc = 0.0;
  if (idx < s.nz * s.nr) {
    const int nr = s.nr;
    const int i = idx / nr, j = idx - i * nr;
    float res;
    if (s.p != nullptr) {
      const float alpha = (float)st->alpha;
      s.x[idx] = s.x[idx] + alpha * s.p[idx];
      const float rv = s.r[idx] - alpha * s.Ap[idx];
      s.r[idx] = rv;
      rr = (double)(rv * rv);
      res = rv;
    } else {
      res = s.b[idx];
    }
    auto xp = [&](int ii, int jj) { return s.x_in[ii * nr + jj]; };
    auto cp = [&](int I, int J) { return s.xc[I * s.cstride + J]; };
    auto xpro = [&](int ii, int jj) {
      return mg_prolong_at(xp, cp, s.wz, s.wr, ii, jj);
    };
    // the first step from zero at (ii, jj): 0 + dinv b / theta
    auto x1 = [&](int ii, int jj) {
      const int q = ii * nr + jj;
      return 0.0f + s.dinv[q] * s.b[q] / s.theta;
    };
    float d = s.from_b ? s.dinv[idx] * res / s.theta
              : s.first ? 0.0f : s.d[idx];
    float xo = s.xc != nullptr
                   ? mg_step_point(s.C, s.npts, s.dinv[idx], res, xpro, true,
                                   &d, s.first, s.theta, s.c1, s.c2, i, j,
                                   s.nz, nr)
               : s.from_b
                   ? mg_step_point(s.C, s.npts, s.dinv[idx], res, x1, true,
                                   &d, 0, s.theta, s.c1, s.c2, i, j, s.nz, nr)
                   : mg_step_point(s.C, s.npts, s.dinv[idx], res, xp,
                                   s.x_in != nullptr, &d, s.first, s.theta,
                                   s.c1, s.c2, i, j, s.nz, nr);
    if (s.mask != nullptr) xo = xo * (s.mask[idx] > 0.0f ? 1.0f : 0.0f);
    s.d[idx] = d;
    s.x_out[idx] = xo;
    if (s.dot != nullptr) acc = (double)(s.dot[idx] * xo);
  }
  if (s.part_rr != nullptr) {
    rr = block_sum(rr);
    if (threadIdx.x == 0) s.part_rr[blockIdx.x] = rr;
  }
  if (s.dot != nullptr) {
    acc = block_sum(acc);
    if (threadIdx.x == 0) s.part[blockIdx.x] = acc;
  }
  beta_tail(tail);
}

// The next level's right-hand side: the restriction of level L's residual
// b - C x. A block takes kRTI x kRTJ points of the next level's (padded)
// plane: it forms the residual once at each fine point they gather from
// (2 kRTI + 1 rows, 2 kRTJ + 1 columns) into shared memory, then one
// thread restricts each coarse point.
constexpr int kRTI = 8, kRTJ = 32;

__global__ void __launch_bounds__(kRTI * kRTJ)
    k_mg_restrict_res(const __grid_constant__ MGLevel L,
                      const float* __restrict__ b,
                      const float* __restrict__ x, float* __restrict__ out,
                      int cz, int cr, const CGState* st) {
  if (st != nullptr && st->done) return;
  constexpr int H = 2 * kRTI + 1, W = 2 * kRTJ + 1;
  __shared__ float res[H][W];
  const int nz = L.nz, nr = L.nr;
  const int I0 = blockIdx.y * kRTI, J0 = blockIdx.x * kRTJ;
  const int fi0 = 2 * I0 - 1, fj0 = 2 * J0 - 1;   // res's first point
  auto xv = [&](int ii, int jj) { return x[ii * nr + jj]; };
  for (int t = threadIdx.x; t < H * W; t += blockDim.x) {
    const int a = t / W, c = t - a * W;
    const int ii = fi0 + a, jj = fj0 + c;
    float v = 0.0f;
    if (ii >= 0 && ii < nz && jj >= 0 && jj < nr)
      v = b[ii * nr + jj] - level_stencil_at(L.C, L.npts, xv, ii, jj, nz, nr);
    res[a][c] = v;
  }
  __syncthreads();
  const int I = I0 + threadIdx.x / kRTJ, J = J0 + threadIdx.x % kRTJ;
  if (I >= cz || J >= cr) return;
  out[I * cr + J] = mg_restrict_at(
      L, [&](int ii, int jj) { return res[ii - fi0][jj - fj0]; }, I, J);
}

// ---- the coarsest level in one launch -------------------------------------
//
// The last level's right-hand side (the restriction of the residual of the
// level above) and its nu_coarse smoothing steps from zero in one launch,
// with no barrier between blocks: each block takes a tile of the level and
// works on the tile grown by a halo of nu_coarse - 1 points on each side
// (clipped to the grid), all in its shared memory. A step at a point reads
// the last iterate at its neighbours only, so step k is right on the
// region shrunk by k (the grid's own edges do not shrink), and after the
// last step on the tile. The fine residual the restriction gathers is
// formed once per fine point of the region, into shared memory too. Each
// point's arithmetic and order are those of the standalone passes.
constexpr int kLastRows = 8, kLastCols = 8;   // a block's tile
constexpr int kLastThreads = 1024;

// The region of the tile of block (bx, by) on a level of nz x nr points,
// halo h: rows [r0, r1), columns [c0, c1).
struct LastRegion {
  int r0, r1, c0, c1;
  __host__ __device__ LastRegion(int by, int bx, int h, int nz, int nr) {
    const int t0 = by * kLastRows, u0 = bx * kLastCols;
    r0 = t0 - h > 0 ? t0 - h : 0;
    c0 = u0 - h > 0 ? u0 - h : 0;
    r1 = t0 + kLastRows + h < nz ? t0 + kLastRows + h : nz;
    c1 = u0 + kLastCols + h < nr ? u0 + kLastCols + h : nr;
  }
  __host__ __device__ int rows() const { return r1 - r0; }
  __host__ __device__ int cols() const { return c1 - c0; }
};

// Shared memory of k_mg_last: the coarse region's four planes (xa, xb, d,
// b) and the fine residual region (2 rows + 1 by 2 columns + 1), for the
// largest region of any tile.
__host__ __device__ inline size_t last_smem(int nz, int nr, int h) {
  const int rh = kLastRows + 2 * h < nz ? kLastRows + 2 * h : nz;
  const int cw = kLastCols + 2 * h < nr ? kLastCols + 2 * h : nr;
  return (4 * (size_t)rh * cw + (size_t)(2 * rh + 1) * (2 * cw + 1)) *
         sizeof(float);
}

__global__ void __launch_bounds__(kLastThreads, 1)
    k_mg_last(const __grid_constant__ MGLevel P, const float* __restrict__ bp,
              const float* __restrict__ xp, const __grid_constant__ MGLevel Q,
              int steps, float* __restrict__ out, const CGState* st) {
  if (st != nullptr && st->done) return;
  extern __shared__ float lsm[];
  const int nz = Q.nz, nr = Q.nr;
  const int h = steps > 1 ? steps - 1 : 0;
  const LastRegion g(blockIdx.y, blockIdx.x, h, nz, nr);
  const int rw = g.rows(), cw = g.cols(), m = rw * cw;
  float* xa = lsm;
  float* xb = lsm + m;
  float* dd = lsm + 2 * m;
  float* bb = lsm + 3 * m;
  float* fr = lsm + 4 * m;   // the fine residual, rows 2 r0 - 1 .. 2 r1 - 1
  const int fr0 = 2 * g.r0 - 1, fc0 = 2 * g.c0 - 1;
  const int fh = 2 * rw + 1, fw = 2 * cw + 1;
  {
    const int pnr = P.nr;
    auto xv = [&](int ii, int jj) { return xp[ii * pnr + jj]; };
    for (int t = threadIdx.x; t < fh * fw; t += blockDim.x) {
      const int a = t / fw, c = t - a * fw;
      const int ii = fr0 + a, jj = fc0 + c;
      float v = 0.0f;
      if (ii >= 0 && ii < P.nz && jj >= 0 && jj < pnr)
        v = bp[ii * pnr + jj] -
            level_stencil_at(P.C, P.npts, xv, ii, jj, P.nz, pnr);
      fr[t] = v;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const int a = t / cw, c = t - a * cw;
    bb[t] = mg_restrict_at(
        P, [&](int ii, int jj) { return fr[(ii - fr0) * fw + jj - fc0]; },
        g.r0 + a, g.c0 + c);
  }
  __syncthreads();
  const float* cur = nullptr;
  float* nxt = xa;
  for (int k = 0; k < steps; ++k) {
    const float c1 = k ? Q.c1[k - 1] : 0.0f, c2 = k ? Q.c2[k - 1] : 0.0f;
    // the part of the region this step is right on
    const int a0 = g.r0 > 0 ? k : 0, a1 = g.r1 < nz ? rw - k : rw;
    const int e0 = g.c0 > 0 ? k : 0, e1 = g.c1 < nr ? cw - k : cw;
    const int w = e1 - e0;
    auto xv = [&](int ii, int jj) {
      return cur[(ii - g.r0) * cw + jj - g.c0];
    };
    for (int t = threadIdx.x; t < (a1 - a0) * w; t += blockDim.x) {
      const int a = a0 + t / w, c = e0 + t % w;
      const int i = g.r0 + a, j = g.c0 + c, q = a * cw + c;
      nxt[q] = mg_step_point(Q.C, Q.npts, Q.dinv[i * nr + j], bb[q], xv,
                             cur != nullptr, dd + q, k == 0, Q.theta, c1, c2,
                             i, j, nz, nr);
    }
    __syncthreads();
    cur = nxt;
    nxt = nxt == xa ? xb : xa;
  }
  // the tile's points of the last iterate
  const int t0 = blockIdx.y * kLastRows, u0 = blockIdx.x * kLastCols;
  for (int t = threadIdx.x; t < kLastRows * kLastCols; t += blockDim.x) {
    const int i = t0 + t / kLastCols, j = u0 + t % kLastCols;
    if (i < nz && j < nr) out[i * nr + j] = cur[(i - g.r0) * cw + j - g.c0];
  }
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

struct Solve {
  const float *A, *sm, *b, *x0, *rtol;
  const float* pcr;    // the r-line Thomas factors (3 planes)
  const float* pcrz;   // the z-line folded PCR stack (2 lz + 1 planes)
  float *x, *r, *z, *p, *Ap;
  double* parts;   // 4 x nparts: pAp (delta), rr, rz (gamma), bb
  CGState* st;
  int npts, lz, nz, nr, maxiter, wrt_r0, nparts;
  long long* counts;
  cudaStream_t stream;
  // the further forms (see hf_cg_extra_planes for the layout of `extra`)
  const float* lmax;   // Chebyshev: device scalar, the bound on lambda_max
  int cheb, merged;    // polynomial degree (0: none); merged-dot recurrence
  const float *ac9, *pcrc, *aux;   // mgz operands (ac9 null: one sweep;
                                   // pcrc the coarse rows' Thomas factors)
  int sweeps;
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
  // (r1, the coarse iterate's two planes ya and yb, rcs, the prolongated
  // iterate zp: see precondition_mgz)
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

// Shared memory of the r-line row kernel: two row buffers, then the
// staged factors (22.1 KB on the flagship), then in kRowRestrict five rows
// of sm . z. It stages its row's factors when they fit a block's shared
// memory; else it reads them from device memory.
size_t row_smem(int nr, int load, bool staged) {
  return (size_t)(2 + (staged ? 3 : 0) + (load == kRowRestrict ? 5 : 0)) *
         nr * sizeof(float);
}

bool r_staged(int nr, int load) {
  return row_smem(nr, load, true) <= kMaxDynSmem;
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
  const void* fns[] = {(const void*)k_row_plain, (const void*)k_row_update,
                       (const void*)k_row_restrict,
                       (const void*)k_row_coarse_res,
                       (const void*)k_pcr_z_tall};
  for (const void* fn : fns) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxDynSmem);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(fn,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
  }
  if (dev < 32) done |= 1u << dev;
  return cudaSuccess;
}

const BetaTail kNoTail{nullptr, nullptr, nullptr, 0, 0, 0, 0};

// The row kernel in load mode `load` (k_row_plain, ...), counted as `phase`: one block
// a row, the even rows only in the coarse modes.
cudaError_t launch_row(int load, const RowArgs& args, int phase,
                       long long* counts, cudaStream_t stream) {
  cudaError_t e = configure();
  if (e != cudaSuccess) return e;
  RowArgs a = args;
  a.staged = r_staged(a.nr, load);
  const size_t smem = row_smem(a.nr, load, a.staged);
  if (smem > kMaxDynSmem) return cudaErrorInvalidValue;
  const dim3 block(1, kRowThreads);
  const int even = (a.nz + 1) / 2;
  switch (load) {
    case kRowPlain:
      k_row_plain<<<a.nz, block, smem, stream>>>(a);
      break;
    case kRowUpdate:
      k_row_update<<<a.nz, block, smem, stream>>>(a);
      break;
    case kRowRestrict:
      k_row_restrict<<<even, dim3(1, kCoarseThreads), smem, stream>>>(a);
      break;
    case kRowCoarseRes:
      k_row_coarse_res<<<even, dim3(1, kCoarseThreads), smem, stream>>>(a);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  counts[phase] += 1;
  return cudaGetLastError();
}

// The r-line row kernel: with `update` (x and r updated by alpha from st,
// p and Ap given) the fused iteration phase, else the line solve of r
// alone; z = T^-1 d * free from the Thomas factors F, the <r, z> partials
// when part_rz is given.
cudaError_t launch_pcr_r(bool update, float* r, float* x, const float* p,
                         const float* Ap, const float* sm, const float* F,
                         float* z, double* part_rr, double* part_rz,
                         const CGState* st, const BetaTail& tail, int nz,
                         int nr, long long* counts, cudaStream_t stream) {
  RowArgs a = {};
  a.r = r; a.x = x; a.p = p; a.Ap = Ap; a.sm = sm; a.F = F;
  a.scale = 1.0f; a.mask = 1; a.out = z;
  a.dot = part_rz != nullptr ? r : nullptr;
  a.part_rr = part_rr; a.part_dot = part_rz; a.st = st; a.tail = tail;
  a.nz = nz; a.nr = nr;
  return launch_row(update ? kRowUpdate : kRowPlain, a,
                    update ? kPhUpdatePcrR : kPhPcrR, counts, stream);
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

cudaError_t launch_mgz_prolong_res(const float* A, int npts, const float* sm,
                                   const float* r, const float* z,
                                   const float* y, const float* aux,
                                   float* zout, float* r1, const CGState* st,
                                   int nz, int nr, long long* counts,
                                   cudaStream_t stream) {
  const int blocks = (nz * nr + kThreads - 1) / kThreads;
  k_mgz_prolong_res<<<blocks, kThreads, 0, stream>>>(
      A, npts, sm, r, z, y, aux, zout, r1, st, nz, nr);
  counts[kPhMgzProlongRes] += 1;
  return cudaGetLastError();
}

// The mgz V(1,1) cycle, z = M^-1 r with the <r, z> partials (one a row), in
// 4 launches with one coarse sweep (+1 a further sweep): the pre-smoothing
// row (in an iteration with the CG update of x and r before it: `update`),
// the coarse row with the fine residual and its restriction, the
// prolongation with the second residual, the post-smoothing row (with the
// beta tail `tail` when given).
cudaError_t precondition_mgz(const Solve& s, bool update,
                             const BetaTail& tail) {
  float *r1 = s.mg(0), *ya = s.mg(1), *yb = s.mg(2), *rcs = s.mg(3),
        *zp = s.mg(4);
  cudaError_t e;
#define HF_TRY(call) if ((e = (call)) != cudaSuccess) return e
  RowArgs a = {};
  a.sm = s.sm; a.st = s.st; a.nz = s.nz; a.nr = s.nr;
  // pre-smooth from zero: one damped fine r-line solve
  RowArgs pre = a;
  pre.r = s.r; pre.x = s.x; pre.p = s.p; pre.Ap = s.Ap;
  pre.F = s.pcr; pre.scale = s.omega; pre.out = s.z;
  pre.part_rr = update ? s.part(1) : nullptr;
  HF_TRY(launch_row(update ? kRowUpdate : kRowPlain, pre, kPhMgzPre,
                    s.counts, s.stream));
  // the fine residual, its restriction and the first coarse line solve,
  // from zero
  RowArgs co = a;
  co.r = s.r; co.A = s.A; co.npts = s.npts; co.z = s.z; co.aux = s.aux;
  co.store = s.sweeps > 1 ? rcs : nullptr;
  co.F = s.pcrc; co.scale = s.omega_c; co.out = ya;
  HF_TRY(launch_row(kRowRestrict, co, kPhMgzCoarse, s.counts, s.stream));
  float* y = ya;
  for (int k = 1; k < s.sweeps; ++k) {
    RowArgs cr = a;
    cr.ac9 = s.ac9; cr.rcs = rcs; cr.y = y; cr.acc = y;
    cr.F = s.pcrc; cr.scale = s.omega_c;
    cr.out = y == ya ? yb : ya;
    HF_TRY(launch_row(kRowCoarseRes, cr, kPhMgzCoarseRes, s.counts,
                      s.stream));
    y = cr.out;
  }
  HF_TRY(launch_mgz_prolong_res(s.A, s.npts, s.sm, s.r, s.z, y, s.aux, zp, r1,
                                s.st, s.nz, s.nr, s.counts, s.stream));
  // post-smooth, the free mask and the <r, z> partials
  RowArgs post = a;
  post.r = r1; post.F = s.pcr; post.scale = s.omega;
  post.acc = zp; post.mask = 1; post.out = s.z;
  post.dot = s.r; post.part_dot = s.part(2); post.tail = tail;
  return launch_row(kRowPlain, post, kPhMgzPost, s.counts, s.stream);
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

// Level 0's part in the cycle: its right-hand side r (the CG residual);
// the CG update its first smoothing step takes (p null: none); the mask,
// the <dot, x> partials and the beta tail of its last step.
struct MGRun {
  float* r;
  float* x;
  const float *p, *Ap;
  double* part_rr;
  const float *mask, *dot;
  double* part;
  BetaTail tail;
};

cudaError_t launch_mg_restrict_res(const MGLevel& L, const float* b,
                                   const float* x, const MGLevel& N,
                                   const CGState* st, long long* counts,
                                   cudaStream_t stream) {
  if (!(L.nz & 1) || !(L.nr & 1) || N.nz < (L.nz + 1) / 2 ||
      N.nr < (L.nr + 1) / 2)
    return cudaErrorInvalidValue;
  const dim3 grid((N.nr + kRTJ - 1) / kRTJ, (N.nz + kRTI - 1) / kRTI);
  k_mg_restrict_res<<<grid, kRTI * kRTJ, 0, stream>>>(L, b, x, N.b, N.nz,
                                                      N.nr, st);
  counts[kPhMgRestrictRes] += 1;
  return cudaGetLastError();
}

// `steps` smoothing steps of level L (one launch each) for the right-hand
// side b, from x_in (null: zero), alternating between the level's planes
// xa and xb (mg_next); the first reads x_in + P xc when xc (the coarse
// level N's iterate) is given, and takes the CG update of `upd` when
// given; the last takes the mask, partials and tail of `fin` when given.
// From zero without an update, the first step (pointwise: it reads b at
// its own point) is formed inside the second, one launch for both.
// *result is the plane of the last iterate.
cudaError_t mg_smooth(const MGLevel& L, const float* b, const float* x_in,
                      const MGLevel* N, const float* xc, int steps,
                      const MGRun* upd, const MGRun* fin, const CGState* st,
                      long long* counts, cudaStream_t stream,
                      float** result) {
  const int blocks = (L.nz * L.nr + kThreads - 1) / kThreads;
  const bool has_upd = upd != nullptr && upd->p != nullptr;
  const float* cur = x_in;
  float* nxt = mg_next(L, x_in);
  const bool fuse = x_in == nullptr && steps > 1 && !has_upd;
  if (fuse) {   // the first step's plane is never written
    cur = nxt;
    nxt = mg_next(L, nxt);
  }
  cudaError_t e;
  for (int k = fuse ? 1 : 0; k < steps; ++k) {
    MGStep s = {};
    s.C = L.C; s.dinv = L.dinv; s.b = b; s.x_in = cur; s.d = L.d;
    s.x_out = nxt; s.npts = L.npts; s.nz = L.nz; s.nr = L.nr;
    s.first = k == 0; s.theta = L.theta;
    s.c1 = k ? L.c1[k - 1] : 0.0f;
    s.c2 = k ? L.c2[k - 1] : 0.0f;
    int phase = kPhMgCheb;
    if (fuse && k == 1) {
      s.x_in = nullptr;
      s.from_b = 1;
      phase = kPhMgChebPre;
    }
    if (k == 0 && xc != nullptr) {
      s.xc = xc; s.wz = L.wz; s.wr = L.wr; s.cstride = N->nr;
      phase = kPhMgProlongCheb;
    }
    if (k == 0 && has_upd) {
      s.r = upd->r; s.x = upd->x; s.p = upd->p; s.Ap = upd->Ap;
      s.part_rr = upd->part_rr;
      phase = kPhMgChebUpdate;
    }
    const bool last = k == steps - 1 && fin != nullptr;
    if (last) {
      s.mask = fin->mask; s.dot = fin->dot; s.part = fin->part;
    }
    k_mg_step<<<blocks, kThreads, 0, stream>>>(s, st,
                                               last ? fin->tail : kNoTail);
    counts[phase] += 1;
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    cur = nxt;
    nxt = mg_next(L, nxt);
  }
  *result = const_cast<float*>(cur);
  return cudaSuccess;
}

// The coarsest level (k_mg_last): its right-hand side from the residual
// b - C x of the level above, P, its nu_coarse steps from zero, the last
// iterate into `out`; one block a tile.
cudaError_t launch_mg_last(const MGLevel& P, const float* b, const float* x,
                           const MGLevel& Q, int steps, float* out,
                           const CGState* st, long long* counts,
                           cudaStream_t stream) {
  if (!(P.nz & 1) || !(P.nr & 1) || Q.nz < (P.nz + 1) / 2 ||
      Q.nr < (P.nr + 1) / 2)
    return cudaErrorInvalidValue;
  const size_t smem = last_smem(Q.nz, Q.nr, steps > 1 ? steps - 1 : 0);
  if (smem > kMaxDynSmem) return cudaErrorInvalidValue;
  static unsigned configured = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !((configured >> dev) & 1u)) {
    e = cudaFuncSetAttribute((const void*)k_mg_last,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxDynSmem);
    if (e != cudaSuccess) return e;
    if (dev < 32) configured |= 1u << dev;
  }
  const dim3 grid((Q.nr + kLastCols - 1) / kLastCols,
                  (Q.nz + kLastRows - 1) / kLastRows);
  k_mg_last<<<grid, kLastThreads, smem, stream>>>(P, b, x, Q, steps, out, st);
  counts[kPhMgLast] += 1;
  return cudaGetLastError();
}

// The V-cycle for level 0's right-hand side run.r: down the levels (the
// smoothing steps from zero, the residual fused into the restriction), the
// coarsest level's right-hand side and smoothing in one launch (k_mg_last),
// then back up (the prolongation fused into the first post-smoothing
// step). *result is the plane of level 0's last iterate.
cudaError_t mg_cycle(const MGDesc* mg, const MGRun& run, const CGState* st,
                     long long* counts, cudaStream_t stream, float** result) {
  cudaError_t e = mg_check(mg);
  if (e != cudaSuccess) return e;
  const int last = mg->n_levels - 1;
  if (last == 0)
    return mg_smooth(mg->lv[0], run.r, nullptr, nullptr, nullptr,
                     mg->nu_coarse, &run, &run, st, counts, stream, result);
  float* pre[kMaxLevels];
#define HF_TRY(call) if ((e = (call)) != cudaSuccess) return e
  for (int l = 0; l < last; ++l) {
    const MGLevel& L = mg->lv[l];
    const float* b = l == 0 ? run.r : L.b;
    HF_TRY(mg_smooth(L, b, nullptr, nullptr, nullptr, mg->nu,
                     l == 0 ? &run : nullptr, nullptr, st, counts, stream,
                     &pre[l]));
    if (l < last - 1)
      HF_TRY(launch_mg_restrict_res(L, b, pre[l], mg->lv[l + 1], st, counts,
                                    stream));
  }
  const MGLevel& Q = mg->lv[last];
  float* xc = mg_after(Q, nullptr, mg->nu_coarse);
  HF_TRY(launch_mg_last(mg->lv[last - 1],
                        last == 1 ? run.r : mg->lv[last - 1].b,
                        pre[last - 1], Q, mg->nu_coarse, xc, st, counts,
                        stream));
  for (int l = last - 1; l >= 0; --l) {
    const MGLevel& L = mg->lv[l];
    const float* b = l == 0 ? run.r : L.b;
    HF_TRY(mg_smooth(L, b, pre[l], &mg->lv[l + 1], xc, mg->nu, nullptr,
                     l == 0 ? &run : nullptr, st, counts, stream, &xc));
  }
#undef HF_TRY
  *result = xc;
  return cudaSuccess;
}

// The multigrid form: z = V-cycle(r) (sm > 0) with the <r, z> partials (one
// an elementwise block); in an iteration (`update`) level 0's first step
// takes the CG update and its last step the beta tail. The wrapper lays out
// level 0's two planes so that the last iterate lands in s.z.
cudaError_t precondition_mg(const Solve& s, bool update,
                            const BetaTail& tail) {
  if (s.mgd->lv[0].nz != s.nz || s.mgd->lv[0].nr != s.nr)
    return cudaErrorInvalidValue;
  MGRun run = {};
  run.r = s.r; run.mask = s.sm; run.dot = s.r; run.part = s.part(2);
  run.tail = tail;
  if (update) {
    run.x = s.x; run.p = s.p; run.Ap = s.Ap; run.part_rr = s.part(1);
  }
  float* out = nullptr;
  cudaError_t e = mg_cycle(s.mgd, run, s.st, s.counts, s.stream, &out);
  if (e != cudaSuccess) return e;
  return out == s.z ? cudaSuccess : cudaErrorInvalidValue;
}

// M^-1 r for the solve's form, with the <r, z> partials; the result is in
// s.zout() (r itself in the identity form, where z aliases r). In an
// iteration (`update`) the multigrid forms take the CG update before their
// cycle and the beta tail `tail` in its last kernel.
cudaError_t precondition(const Solve& s, bool update, const BetaTail& tail) {
  if (s.mgd) return precondition_mg(s, update, tail);
  if (s.mgz()) return precondition_mgz(s, update, tail);
  if (s.cheb > 0) return precondition_cheb(s, s.r, s.st);
  if (!s.rline()) return cudaSuccess;   // identity: z aliases r
  cudaError_t e = launch_pcr_r(false, s.r, nullptr, nullptr, nullptr, s.sm,
                               s.pcr, s.z, nullptr,
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
  if ((e = precondition(s, false, kNoTail)) != cudaSuccess) return e;
  if (s.merged) return merged_tail(s, 1, lc);
  if ((e = finalize(s, kFinInit)) != cudaSuccess) return e;
  return p_update(s, 1, lc);
}

// One iteration. The standard recurrence takes alpha in k_stencil_dot's
// tail and beta in the tail of the kernel that writes the last partials:
// identity 3 launches (k_stencil_dot, k_update, k_p_update), r-line 3
// (k_update folded into the row kernel), ADI 4 (+ k_pcr_z); mgz 6 with one
// coarse sweep (the update folded into the pre-smoothing row, beta in the
// post-smoothing row's tail), 7 with two; multigrid at four levels 13 (the
// update folded into level 0's first smoothing step, beta in its last);
// the Chebyshev form keeps k_update, its polynomial and a k_finalize. The
// merged recurrence keeps its own five-phase sequence.
cudaError_t iterate(const Solve& s, const LoopCond* lc) {
  cudaError_t e;
  if (s.merged) {
    // x += alpha p, r -= alpha q; u = M^-1 r; then the merged tail
    k_update<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
        s.x, s.r, s.p, s.q(), s.part(1), s.st, kNoTail, s.n());
    s.counts[kPhUpdate] += 1;
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if ((e = precondition(s, false, kNoTail)) != cudaSuccess) return e;
    return merged_tail(s, 0, lc);
  }
  k_stencil_dot<<<s.elem_blocks(), kThreads, 0, s.stream>>>(
      s.A, s.npts, s.sm, s.p, s.Ap, s.part(0), s.st, 1, s.nz, s.nr);
  s.counts[kPhStencilDot] += 1;
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (s.mgz() || s.mgd) {
    // the partials of <r, r> and <r, z>: one a row (mgz), one an
    // elementwise block of level 0 (multigrid)
    const int np = s.mgz() ? s.nz : s.elem_blocks();
    const BetaTail tail{s.st, s.part(1), s.part(2), np, np, s.maxiter,
                        s.fixed};
    if ((e = precondition(s, true, tail)) != cudaSuccess) return e;
  } else if (s.rline()) {
    const BetaTail tail{s.st, s.part(1), s.part(2), s.nz,
                        s.adi() ? s.col_tiles() : s.nz, s.maxiter, s.fixed};
    e = launch_pcr_r(true, s.r, s.x, s.p, s.Ap, s.sm, s.pcr, s.z,
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
      if ((e = precondition(s, false, kNoTail)) != cudaSuccess) return e;
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

// A solve recorded into another graph's capture (csrc/step.cu records the
// transient's solves this way): `desc` is a solve record packed by
// hf_solve_desc, `stream` the stream capturing the graph that receives the
// start, the conditional WHILE node and the finish, `body_stream` a stream
// for the loop body's capture; `counts` receives the launches of the start
// and finish, counts_body those of one body.
namespace hf {

cudaError_t configure_solves() { return configure(); }

cudaError_t record_solve_desc(const void* desc, cudaStream_t stream,
                              cudaStream_t body_stream, int check_every,
                              int poison, int* iters,
                              unsigned long long* runs, long long* counts,
                              long long* counts_body) {
  if (check_every < 1) return cudaErrorInvalidValue;
  Solve s;
  memcpy(&s, desc, sizeof(Solve));
  s.stream = stream;
  s.counts = counts;
  return record_solve(s, body_stream, check_every, poison, iters, runs,
                      counts_body);
}

}  // namespace hf

// ---------------------------------------------------------------------
// C interface (bound with ctypes by heatflow_tpu_torch/ops/cuda_cg.py).
// Every entry returns a cudaError_t code, 0 on success. Pointers are
// device pointers; `stream` is the caller's cudaStream_t.
// ---------------------------------------------------------------------

#define HF_SOLVE_ARGS                                                        \
  const float *A, int npts, const float *sm, const float *b,                 \
      const float *x0, const float *rtol, const float *pcr,                  \
      const float *pcrz, int lz, float *x, float *r, float *z, float *p,     \
      float *Ap, double *parts, int nparts, void *state, int nz, int nr,     \
      int maxiter, int wrt_r0, long long *counts, const float *lmax,         \
      int cheb, int merged, const float *ac9,             \
      const float *pcrc, const float *aux, int sweeps, float omega,          \
      float omega_c, float *extra, const void *mg, int fixed

#define HF_SOLVE_INIT                                                        \
  Solve s{A, sm, b, x0, rtol, pcr, pcrz, x, r, z, p, Ap, parts,              \
          (CGState *)state, npts, lz, nz, nr, maxiter, wrt_r0, nparts,       \
          counts, nullptr, lmax, cheb, merged, ac9, pcrc, aux,               \
          sweeps, omega, omega_c, extra, (const MGDesc *)mg, fixed}

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
// second z plane (Chebyshev), r1, ya, yb, rcs and zp (mgz).
int hf_cg_extra_planes(int cheb, int merged, int mgz) {
  return (merged ? 2 : 0) + (cheb > 0 ? 2 : 0) + (mgz ? 5 : 0);
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

// A solve record (the arguments of hf_cg_tol_graph, packed) for
// hf::record_solve_desc, into `out` (hf_solve_desc_bytes() bytes).
int hf_solve_desc_bytes() { return (int)sizeof(Solve); }

int hf_solve_desc(HF_SOLVE_ARGS, void *out) {
  HF_SOLVE_INIT;
  memcpy(out, &s, sizeof(Solve));
  return 0;
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

// The r-line Thomas factors F (3 planes, see k_rline_factor) of the
// operator A (7 or 9 planes) under the scaling s and the free mask.
int hf_rline_factor(const float *A, const float *s, const float *fmask,
                    float *F, int nz, int nr, void *stream) {
  constexpr int kFactorThreads = 32;
  k_rline_factor<<<(nz + kFactorThreads - 1) / kFactorThreads,
                   kFactorThreads, 0, (cudaStream_t)stream>>>(A, s, fmask,
                                                              F, nz, nr);
  return (int)cudaGetLastError();
}

int hf_pcr_r(const float *r, const float *sm, const float *F, float *z,
             double *part, int nz, int nr, long long *counts, void *stream) {
  return (int)launch_pcr_r(false, const_cast<float *>(r), nullptr, nullptr,
                           nullptr, sm, F, z, nullptr, part, nullptr, kNoTail,
                           nz, nr, counts, (cudaStream_t)stream);
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
                  const float *sm, const float *pcr, const float *pcrz,
                  int lz, float *z, double *parts, int nparts, void *state,
                  int maxiter, int fixed, int nz, int nr, long long *counts,
                  void *stream) {
  Solve s{nullptr, sm, nullptr, nullptr, nullptr, pcr, pcrz, x, r, z,
          const_cast<float *>(p), const_cast<float *>(Ap), parts,
          (CGState *)state, 7, lz, nz, nr, maxiter, 0, nparts, counts,
          (cudaStream_t)stream, nullptr, 0, 0, nullptr, nullptr, nullptr,
          1, 0.0f, 0.0f, nullptr, nullptr, fixed};
  const BetaTail tail{s.st, s.part(1), s.part(2), nz,
                      s.adi() ? s.col_tiles() : nz, maxiter, fixed};
  cudaError_t e = launch_pcr_r(true, r, x, p, Ap, sm, pcr, z, s.part(1),
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
                     const float *r, const float *pcr, float *z,
                     double *parts, int nparts, int nz, int nr,
                     long long *counts, void *stream, const float *lmax,
                     int cheb, const float *ac9, const float *pcrc,
                     const float *aux, int sweeps, float omega, float omega_c,
                     float *extra, int *which) {
  Solve s{A, sm, nullptr, nullptr, nullptr, pcr, nullptr, nullptr,
          const_cast<float *>(r), z, nullptr, nullptr, parts, nullptr, npts,
          0, nz, nr, 0, 0, nparts, counts, (cudaStream_t)stream, lmax,
          cheb, 0, ac9, pcrc, aux, sweeps, omega, omega_c, extra,
          nullptr, 0};
  *which = s.zout() != z;
  return (int)precondition(s, false, kNoTail);
}

// The mgz cycle's pre-smoothing row alone: z = omega T^-1 r; with a
// state record (its alpha), after the CG update of the row: x += alpha p,
// r -= alpha Ap in place, the <r, r> partials (one a row) in part_rr.
int hf_mgz_pre(float *r, float *x, const float *p, const float *Ap,
               const float *pcr, float omega, float *z, double *part_rr,
               const void *state, int nz, int nr, long long *counts,
               void *stream) {
  RowArgs a = {};
  a.r = r; a.x = x; a.p = p; a.Ap = Ap; a.F = pcr;
  a.scale = omega; a.out = z; a.st = (const CGState *)state;
  a.part_rr = state != nullptr ? part_rr : nullptr; a.nz = nz; a.nr = nr;
  return (int)launch_row(state != nullptr ? kRowUpdate : kRowPlain, a,
                         kPhMgzPre, counts, (cudaStream_t)stream);
}

// The first coarse sweep alone: the fine residual r - sm A (sm z), its
// restriction (into store, when given) and yc = omega_c Tc^-1 of it, every
// row of yc written.
int hf_mgz_coarse(const float *A, int npts, const float *sm, const float *r,
                  const float *z, const float *aux, const float *pcrc,
                  float omega_c, float *yc, float *store, int nz, int nr,
                  long long *counts, void *stream) {
  RowArgs a = {};
  a.A = A; a.npts = npts; a.sm = sm; a.r = const_cast<float *>(r); a.z = z;
  a.aux = aux; a.store = store; a.F = pcrc;
  a.scale = omega_c; a.out = yc; a.nz = nz; a.nr = nr;
  return (int)launch_row(kRowRestrict, a, kPhMgzCoarse, counts,
                         (cudaStream_t)stream);
}

// A later coarse sweep alone: out = y + omega_c Tc^-1 (rcs - Ac9 y).
int hf_mgz_coarse_res(const float *ac9, const float *rcs, const float *y,
                      const float *pcrc, float omega_c, float *out, int nz,
                      int nr, long long *counts, void *stream) {
  RowArgs a = {};
  a.ac9 = ac9; a.rcs = rcs; a.y = y; a.acc = y; a.F = pcrc;
  a.scale = omega_c; a.out = out; a.nz = nz; a.nr = nr;
  return (int)launch_row(kRowCoarseRes, a, kPhMgzCoarseRes, counts,
                         (cudaStream_t)stream);
}

// The prolongation with the second residual alone: zout = z + P (sc y),
// r1 = r - sm A (sm zout).
int hf_mgz_prolong_res(const float *A, int npts, const float *sm,
                       const float *r, const float *z, const float *y,
                       const float *aux, float *zout, float *r1, int nz,
                       int nr, long long *counts, void *stream) {
  return (int)launch_mgz_prolong_res(A, npts, sm, r, z, y, aux, zout, r1,
                                     nullptr, nz, nr, counts,
                                     (cudaStream_t)stream);
}

// The post-smoothing row alone: z = (zp + omega T^-1 r1) * free with the
// <r, z> partials (one a row) in parts plane 2; with a state record, the
// beta tail on it, <r, r> from the n_rr partials in parts plane 1.
int hf_mgz_post(const float *r1, const float *zp, const float *pcr,
                float omega, const float *sm, const float *r, float *z,
                double *parts, int nparts, int n_rr, void *state,
                int maxiter, int fixed, int nz, int nr, long long *counts,
                void *stream) {
  RowArgs a = {};
  a.r = const_cast<float *>(r1); a.F = pcr; a.scale = omega;
  a.acc = zp; a.mask = 1; a.sm = sm; a.out = z; a.dot = r;
  a.part_dot = parts + 2 * (size_t)nparts; a.nz = nz; a.nr = nr;
  if (state != nullptr)
    a.tail = BetaTail{(CGState *)state, parts + nparts, a.part_dot, n_rr, nz,
                      maxiter, fixed};
  return (int)launch_row(kRowPlain, a, kPhMgzPost, counts,
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

// One smoothing step of a multigrid level alone (see k_mg_step). x_in, xc
// (with wz, wr and cstride), mask, dot and the CG update (r, x, p, Ap,
// with the state record's alpha and the <r, r> partials in part_rr) may be
// null; with `tail`, the beta tail on the state record, <r, r> from
// part_rr and <r, z> from part (one an elementwise block each).
int hf_mg_step(const float *C, const float *dinv, int npts, const float *b,
               const float *x_in, float *d, float *x_out, int first,
               float theta, float c1, float c2, const float *xc,
               const float *wz, const float *wr, int cstride,
               const float *mask, const float *dot, double *part, float *r,
               float *x, const float *p, const float *Ap, double *part_rr,
               void *state, int tail, int maxiter, int fixed, int from_b,
               int nz, int nr, long long *counts, void *stream) {
  MGStep s = {};
  s.C = C; s.dinv = dinv; s.b = b; s.x_in = x_in; s.d = d; s.x_out = x_out;
  s.npts = npts; s.nz = nz; s.nr = nr; s.first = first; s.theta = theta;
  s.c1 = c1; s.c2 = c2; s.xc = xc; s.wz = wz; s.wr = wr; s.cstride = cstride;
  s.mask = mask; s.dot = dot; s.part = part;
  s.r = r; s.x = x; s.p = p; s.Ap = Ap; s.part_rr = part_rr;
  s.from_b = from_b;
  const int blocks = (nz * nr + kThreads - 1) / kThreads;
  const BetaTail t = tail ? BetaTail{(CGState *)state, part_rr, part, blocks,
                                     blocks, maxiter, fixed}
                          : kNoTail;
  k_mg_step<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      s, (const CGState *)state, t);
  counts[xc != nullptr ? kPhMgProlongCheb
         : p != nullptr ? kPhMgChebUpdate
         : from_b ? kPhMgChebPre : kPhMgCheb] += 1;
  return (int)cudaGetLastError();
}

// The restriction of a level's residual b - C x onto the next level's
// (cz, cr) plane alone.
int hf_mg_restrict_res(const float *C, int npts, const float *b,
                       const float *x, const float *wz, const float *wr,
                       float *out, int nz, int nr, int cz, int cr,
                       long long *counts, void *stream) {
  MGLevel L = {};
  L.C = C; L.wz = wz; L.wr = wr; L.npts = npts; L.nz = nz; L.nr = nr;
  MGLevel N = {};
  N.b = out; N.nz = cz; N.nr = cr;
  return (int)launch_mg_restrict_res(L, b, x, N, nullptr, counts,
                                     (cudaStream_t)stream);
}

// The coarsest level alone (see k_mg_last): level q = mg->n_levels - 1's
// right-hand side from the residual b - C x of level q - 1, nu_coarse
// steps from zero; *result is the device pointer of the plane that holds
// the last iterate.
int hf_mg_last(const void *mg, const float *b, const float *x,
               long long *counts, void *stream, void **result) {
  const MGDesc *desc = (const MGDesc *)mg;
  cudaError_t e = mg_check(desc);
  if (e != cudaSuccess || desc->n_levels < 2)
    return (int)(e != cudaSuccess ? e : cudaErrorInvalidValue);
  const int q = desc->n_levels - 1;
  float *out = mg_after(desc->lv[q], nullptr, desc->nu_coarse);
  *result = out;
  return (int)launch_mg_last(desc->lv[q - 1], b, x, desc->lv[q],
                             desc->nu_coarse, out, nullptr, counts,
                             (cudaStream_t)stream);
}

// The whole V-cycle alone: the cycle of `mg` on the right-hand side r, the
// result times (mask > 0) when mask is given, with the <r, z> partials (one
// an elementwise block of level 0) in part; *result is the device pointer
// of the plane that holds z (level 0's xa or xb).
int hf_mg_vcycle(const void *mg, const float *r, const float *mask,
                 double *part, long long *counts, void *stream,
                 void **result) {
  MGRun run = {};
  run.r = const_cast<float *>(r); run.mask = mask; run.dot = r;
  run.part = part; run.tail = kNoTail;
  float *out = nullptr;
  const cudaError_t e = mg_cycle((const MGDesc *)mg, run, nullptr, counts,
                                 (cudaStream_t)stream, &out);
  *result = out;
  return (int)e;
}

}  // extern "C"

