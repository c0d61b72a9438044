// The structured transient's step on the kernel path, and the CUDA graph
// that runs a whole transient as one device program.
//
// Counterpart of: heatflow_tpu/sim/stepper.py _core, the JAX package's one
// XLA program for the transient (jax.jit of a lax.scan over the steps,
// stepper.py:643-652; the r-line/ADI choice a lax.cond on the previous
// step's iteration count carried in the scan state, :491-500, :559-570).
// The JAX package has no Pallas kernel here: XLA fuses the scan body's
// elementwise work (the right-hand side, lift, seed, float64 residual,
// refinement scale, field update and watcher gather, :463-482, :538-552,
// :590-594). These four kernels are the counterparts of those fusions:
//
// - k_step_prologue: one pass over the plane. g = g0 + amp_n g1 is affine,
//   so its lift is A g0 + amp_n A g1 (both applied once a run); b = M_op
//   u_n + b_src (the 7-point stencil), b_lift = (b - lift) s, the
//   warm-start seed from the ring of the last three fields, y0 = seed / s
//   free, bt = b_lift free, and the partial sums of <bt, bt>.
// - k_refine_residual: one pass a float64 refinement pass. r64 = bt - free
//   s A(s y), y first taking the previous pass's correction (formed at each
//   stencil point as it is read, and stored into the pass's own y plane),
//   the partials of <r64, r64>; a last-block tail sums the partials in a
//   fixed order and sets rnorm and the inner solve's rtol_eff as
//   ops/cg.py refine_inner_scale does.
// - k_refine_scale: r32 = r64 / rnorm and the inner seed (zero, or the
//   carried correction of refine_inner_seed) written straight into the
//   solve's right-hand side and seed planes: no copies around the solve.
// - k_step_epilogue: u = y s free + g (y with the last pass's correction),
//   into the ring (and the recorded fields), the watcher row, the step's
//   iteration count; its last block advances the step, records the count
//   the adaptive switch reads and sets the step loop's condition.
// The step index is read on the device, so each kernel is graph-safe.
// A mesh with no lattice (the ELL form: StepArgs.cols, the planes 1 x N)
// takes the operator products M_op u_n and A (s y) as ops/ell.py
// ell_apply's gathers, each row's slots in slot order (ell_rn), in place of
// the stencil; the rest of each kernel is the lattice's.
//
// Numerics: every product and sum is rounded as the eager expressions are
// (__fmul_rn, __dadd_rn, ...: no contraction into FMAs), the stencil summed
// in ops/stencil.py apply_stencil's order with a zero in place of a
// neighbour outside the grid, the divisions and the square root IEEE
// rounded: the planes are bitwise the eager loop's. Only the two inner
// products are summed in another order than torch.sum (each block in a
// tree, the blocks in order: repeatable).
//
// What bounds the kernels on an H100: bytes. At the flagship (251 x 1107,
// one float64 plane 2.22 MB) the prologue reads ~13 planes and writes 2,
// the residual reads ~12 and writes 1-2, the scale reads 1-2 and writes 2
// float32 planes, the epilogue reads ~7 and writes 1-2: ~70 MB a step
// with one refinement pass, ~21 us at 3.35 TB/s. The design keeps each a
// single elementwise pass with a one-block tail, launched from the graph.
//
// The graph (hf_step_graph): a conditional WHILE node over the steps whose
// body is [prologue; per pass: residual, scale, the solve; epilogue]. The
// solve is cg_tol's own recorded solve (csrc/cg_tol.cu record_solve: its
// start, a WHILE node over blocks of iterations, its finish); under
// 'adaptive' each pass holds two conditional IF nodes, the ADI and the
// r-line solve, whose conditions the kernel before them sets from the last
// step's count, so the host reads nothing between steps. The state counts
// on the device each kernel's launches, the solves of each form and their
// loop bodies' runs: the host reads them once, after the run.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace hf {
cudaError_t configure_solves();
cudaError_t record_solve_desc(const void* desc, cudaStream_t stream,
                              cudaStream_t body_stream, int check_every,
                              int poison, int* iters,
                              unsigned long long* runs, long long* counts,
                              long long* counts_body);
}  // namespace hf

namespace {

constexpr int kThreads = 256;

// The step state in device memory (mirrored by ops/cuda_step.py).
struct StepState {
  int n;                 // the step the next kernel works on
  int it_prev;           // the last step's iteration count
  unsigned ticket[2];    // the residual's and the epilogue's block tickets
  double floor2;         // 1e-30 <bt, bt>: the degenerate-rhs floor
  double rnorm[2];       // the refinement passes' residual norms
  long long solves[2];   // solves run on the r-line (or the one) form, ADI
  int adi;               // the form of the current solve (1: ADI)
  int pad;
  long long launches[4];  // prologue, residual, scale, epilogue launches
  unsigned long long runs[2];  // the forms' solve loop bodies run
};

// The arguments of every step kernel (mirrored by ops/cuda_step.py
// _StepArgs). Planes marked T are float64 when refining (f64), else
// float32; unrefined, bt is the solve's b32 and y0 its x0.
struct StepArgs {
  const void *Mop, *A, *s, *free, *g0, *g1, *Ag0, *Ag1, *src, *amps;  // T
  void *ring, *bt, *y0, *y1, *r64, *fields, *watch;                   // T
  const long long* watch_flat;
  const int* cols;   // ELL column ids (nz * nr rows, npts slots), or null
  float *b32, *x0, *dx0, *dx1, *rtol32;
  int *iters, *cg_iters;
  double *part_bt, *part_r;
  StepState* st;
  double rtol;
  unsigned long long h_rline0, h_rline1, h_adi0, h_adi1, h_loop;
  int npts, nz, nr, f64, order, passes, carry, n_watch, num_steps, adaptive,
      thresh, maxiter, set_if, set_loop;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float dv(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double dv(double a, double b) {
  return __ddiv_rn(a, b);
}

// Sum of v over the block; valid in every thread.
__device__ double block_sum(double v) {
  __shared__ double warp_part[32];
  __shared__ double total;
  const int tid = threadIdx.x;
  __syncthreads();
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

// n partials summed in a fixed order; valid in every thread. The partials
// bypass L1: the last block reads what the other blocks wrote.
__device__ double reduce_parts(const double* part, int n) {
  double s = 0.0;
  for (int t = threadIdx.x; t < n; t += blockDim.x) s += __ldcg(part + t);
  return block_sum(s);
}

// The last-block pattern: every block takes a ticket after a fence; the
// one that draws the last (true in all its threads) sees every block's
// writes.
__device__ bool last_block(unsigned* ticket) {
  __shared__ bool last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  return last;
}

// (C u)[i, j] for the 7-point (or 9-point) stencil C in apply_stencil's
// order: C0 u, then each neighbour's term added in turn, a neighbour
// outside the grid read as 0 (its term C_k 0 still added, as the eager
// shifted planes do).
template <class T, class U>
__device__ __forceinline__ T stencil_rn(const T* __restrict__ C, int npts,
                                        U u, int i, int j, int nz, int nr) {
  const int n = nz * nr;
  const int idx = i * nr + j;
  T out = mul(C[idx], u(i, j));
  const int di[8] = {1, -1, 0, 0, 1, -1, 1, -1};
  const int dj[8] = {0, 0, 1, -1, 1, -1, -1, 1};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k >= npts - 1) break;
    const int ii = i + di[k], jj = j + dj[k];
    const bool in = ii >= 0 && ii < nz && jj >= 0 && jj < nr;
    const T v = in ? u(ii, jj) : T(0);
    out = add(out, mul(C[(size_t)(k + 1) * n + idx], v));
  }
  return out;
}

// (C u)[row] for an ELL operator C (nz * nr rows of npts slots, column ids
// cols) in ell_apply's order: the row's slots in turn, each product and sum
// rounded; u is a function of the column.
template <class T, class U>
__device__ __forceinline__ T ell_rn(const T* __restrict__ C,
                                    const int* __restrict__ cols, int npts,
                                    U u, int row) {
  const T* c = C + (size_t)row * npts;
  const int* col = cols + (size_t)row * npts;
  T out = mul(c[0], u(col[0]));
  for (int k = 1; k < npts; ++k) out = add(out, mul(c[k], u(col[k])));
  return out;
}

// The form of pass p's solve (thread 0 of block 0 of the kernel before
// it): under 'adaptive' ADI when the last step's count (the first step:
// maxiter) exceeds the threshold; counted, and the IF nodes' conditions set
// inside the graph.
__device__ void set_form(const StepArgs& a, int p, int n) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const int it_prev = n == 0 ? a.maxiter : a.st->it_prev;
  const int adi = a.adaptive && it_prev > a.thresh ? 1 : 0;
  a.st->adi = adi;
  a.st->solves[adi] += 1;
  if (a.set_if) {
    cudaGraphSetConditional(p ? a.h_adi1 : a.h_adi0, adi ? 1u : 0u);
    cudaGraphSetConditional(p ? a.h_rline1 : a.h_rline0, adi ? 0u : 1u);
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads) k_step_prologue(StepArgs a) {
  const int n = a.st->n;
  const int N = a.nz * a.nr;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  double bb = 0.0;
  if (idx < N) {
    const T* ring = (const T*)a.ring;
    const T* up = ring + (size_t)((n + 2) % 3) * N;
    const T* upp = ring + (size_t)((n + 1) % 3) * N;
    const T* uppp = ring + (size_t)(n % 3) * N;
    const int i = idx / a.nr, j = idx - i * a.nr;
    const int nr = a.nr;
    T b = a.cols != nullptr
              ? ell_rn<T>((const T*)a.Mop, a.cols, a.npts,
                          [&](int q) { return up[q]; }, idx)
              : stencil_rn<T>(
                    (const T*)a.Mop, a.npts,
                    [&](int ii, int jj) { return up[ii * nr + jj]; }, i, j,
                    a.nz, a.nr);
    b = add(b, a.src != nullptr ? ((const T*)a.src)[idx] : T(0));
    const T amp = ((const T*)a.amps)[n];
    const T s = ((const T*)a.s)[idx];
    const T fr = ((const T*)a.free)[idx];
    const T lift = add(((const T*)a.Ag0)[idx],
                       mul(amp, ((const T*)a.Ag1)[idx]));
    const T b_lift = mul(sub(b, lift), s);
    T seed = up[idx];
    if (a.order == 1)
      seed = sub(mul(T(2), up[idx]), upp[idx]);
    else if (a.order == 2)
      seed = add(mul(T(3), sub(up[idx], upp[idx])), uppp[idx]);
    const T y0 = mul(dv(seed, s > T(0) ? s : T(1)), fr);
    const T bt = mul(b_lift, fr);
    ((T*)a.bt)[idx] = bt;
    ((T*)a.y0)[idx] = y0;
    bb = mul((double)bt, (double)bt);
  }
  if (a.part_bt != nullptr) {
    const double t = block_sum(bb);
    if (threadIdx.x == 0) a.part_bt[blockIdx.x] = t;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.st->launches[0] += 1;
  if (a.passes == 0) set_form(a, 0, n);
}

// Refinement pass p (float64 planes).
__global__ void __launch_bounds__(kThreads) k_refine_residual(StepArgs a,
                                                              int p) {
  StepState* st = a.st;
  const int N = a.nz * a.nr;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const double* yin = (const double*)a.y0;   // pass 1 writes y1
  const float* dy = p ? a.dx0 : nullptr;
  const double rn_prev = p ? st->rnorm[0] : 0.0;
  const double* s = (const double*)a.s;
  auto yv = [&](int k) {
    const double v = yin[k];
    return dy != nullptr ? __dadd_rn(v, __dmul_rn((double)dy[k], rn_prev))
                         : v;
  };
  double rr = 0.0;
  if (idx < N) {
    const int i = idx / a.nr, j = idx - i * a.nr;
    const int nr = a.nr;
    auto sy = [&](int k) { return __dmul_rn(s[k], yv(k)); };
    const double Au =
        a.cols != nullptr
            ? ell_rn<double>((const double*)a.A, a.cols, a.npts, sy, idx)
            : stencil_rn<double>(
                  (const double*)a.A, a.npts,
                  [&](int ii, int jj) { return sy(ii * nr + jj); }, i, j,
                  a.nz, a.nr);
    const double r = __dsub_rn(
        ((const double*)a.bt)[idx],
        __dmul_rn(((const double*)a.free)[idx], __dmul_rn(s[idx], Au)));
    if (p) ((double*)a.y1)[idx] = yv(idx);
    ((double*)a.r64)[idx] = r;
    rr = __dmul_rn(r, r);
  }
  const double t = block_sum(rr);
  if (threadIdx.x == 0) a.part_r[blockIdx.x] = t;
  if (!last_block(&st->ticket[0])) return;
  const double rn2 = reduce_parts(a.part_r, gridDim.x);
  const double floor2 =
      p == 0 ? __dmul_rn(1e-30, reduce_parts(a.part_bt, gridDim.x))
             : st->floor2;
  if (threadIdx.x == 0) {
    const bool degen = rn2 <= floor2;
    st->floor2 = floor2;
    st->rnorm[p] = sqrt(degen ? 1.0 : rn2);
    *a.rtol32 = __double2float_rn(degen ? 2.0 : a.rtol);
    st->ticket[0] = 0;
    st->launches[1] += 1;
  }
}

__global__ void __launch_bounds__(kThreads) k_refine_scale(StepArgs a,
                                                           int p) {
  const int N = a.nz * a.nr;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const double rnorm = a.st->rnorm[p];
  if (idx < N) {
    a.b32[idx] = __double2float_rn(__ddiv_rn(((const double*)a.r64)[idx],
                                             rnorm));
    const float* dx = p ? a.dx1 : a.dx0;
    a.x0[idx] = a.carry ? __fmul_rn(dx[idx], *a.rtol32 < 1.0f ? 1.0f : 0.0f)
                        : 0.0f;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) a.st->launches[2] += 1;
  set_form(a, p, a.st->n);
}

template <class T>
__global__ void __launch_bounds__(kThreads) k_step_epilogue(StepArgs a) {
  StepState* st = a.st;
  const int n = st->n;
  const int N = a.nz * a.nr;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int last = a.passes > 0 ? a.passes - 1 : 0;
  // the solve's output (unrefined), or y and the last pass's correction
  const T* xin = (const T*)(a.passes == 0 ? (const void*)a.dx0
                            : last == 0 ? a.y0 : a.y1);
  const float* dy = a.passes == 0 ? nullptr : last == 0 ? a.dx0 : a.dx1;
  const T rn = a.passes == 0 ? T(0) : T(st->rnorm[last]);
  const T amp = ((const T*)a.amps)[n];
  const T* s = (const T*)a.s;
  const T* fr = (const T*)a.free;
  const T* g0 = (const T*)a.g0;
  const T* g1 = (const T*)a.g1;
  auto u_at = [&](long long k) {
    T x = xin[k];
    if (dy != nullptr) x = add(x, mul(T(dy[k]), rn));
    return add(mul(mul(x, s[k]), fr[k]), add(g0[k], mul(amp, g1[k])));
  };
  if (idx < N) {
    const T u = u_at(idx);
    ((T*)a.ring)[(size_t)(n % 3) * N + idx] = u;
    if (a.fields != nullptr) ((T*)a.fields)[(size_t)n * N + idx] = u;
  }
  if (blockIdx.x == 0 && (int)threadIdx.x < a.n_watch)
    ((T*)a.watch)[(size_t)n * a.n_watch + threadIdx.x] =
        u_at(a.watch_flat[threadIdx.x]);
  if (!last_block(&st->ticket[1])) return;
  if (threadIdx.x == 0) {
    int it = a.iters[0];
    for (int p = 1; p < a.passes; ++p) it += a.iters[p];
    a.cg_iters[n] = it;
    st->it_prev = it;
    st->n = n + 1;
    st->ticket[1] = 0;
    st->launches[3] += 1;
    if (a.set_loop)
      cudaGraphSetConditional(a.h_loop, n + 1 < a.num_steps ? 1u : 0u);
  }
}

int blocks(const StepArgs& a) {
  return (a.nz * a.nr + kThreads - 1) / kThreads;
}

cudaError_t launch_prologue(const StepArgs& a, cudaStream_t stream) {
  if (a.f64)
    k_step_prologue<double><<<blocks(a), kThreads, 0, stream>>>(a);
  else
    k_step_prologue<float><<<blocks(a), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_residual(const StepArgs& a, int p, cudaStream_t stream) {
  if (!a.f64 || p < 0 || p >= a.passes || p > 1) return cudaErrorInvalidValue;
  k_refine_residual<<<blocks(a), kThreads, 0, stream>>>(a, p);
  return cudaGetLastError();
}

cudaError_t launch_scale(const StepArgs& a, int p, cudaStream_t stream) {
  if (!a.f64 || p < 0 || p >= a.passes || p > 1) return cudaErrorInvalidValue;
  k_refine_scale<<<blocks(a), kThreads, 0, stream>>>(a, p);
  return cudaGetLastError();
}

cudaError_t launch_epilogue(const StepArgs& a, cudaStream_t stream) {
  if (a.n_watch > kThreads) return cudaErrorInvalidValue;
  if (a.f64)
    k_step_epilogue<double><<<blocks(a), kThreads, 0, stream>>>(a);
  else
    k_step_epilogue<float><<<blocks(a), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Add a conditional node of `type` after the work captured so far on
// `stream`; the stream's capture continues after it. *body is the node's
// body graph.
cudaError_t add_conditional(cudaStream_t stream,
                            cudaGraphConditionalHandle handle,
                            cudaGraphConditionalNodeType type,
                            cudaGraph_t* body) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph,
                                           &deps, &ndeps);
  if (e != cudaSuccess) return e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  if ((e = cudaGraphAddNode(&node, graph, deps, ndeps, &params)) !=
      cudaSuccess)
    return e;
  e = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return e;
  *body = params.conditional.phGraph_out[0];
  return cudaSuccess;
}

cudaError_t capture_graph(cudaStream_t stream, cudaGraph_t* graph) {
  cudaStreamCaptureStatus status;
  return cudaStreamGetCaptureInfo(stream, &status, nullptr, graph);
}

// The streams of one capture: the step's, an IF body's, a solve loop's.
struct Streams {
  cudaStream_t step, branch, body;
};

// The solves of the forms (descs[f * passes + p]) record into the capture;
// their loop bodies count their runs in runs[f] (device memory), pass 0's
// launches are counted in counts[f], counts_body[f].
struct SolveRecs {
  const void* const* descs;
  int n_forms, check_every;
  unsigned long long* runs;
  long long* const* counts;
  long long* const* counts_body;
};

// One step recorded on ss.step: the prologue, each pass's residual, scale
// and solve (under 'adaptive' an IF node a form), the epilogue. The IF
// nodes' handles are made first: the kernels that set them carry them.
cudaError_t record_step(StepArgs a, const Streams& ss, const SolveRecs& rec) {
  cudaError_t e;
#define HF_TRY(call) if ((e = (call)) != cudaSuccess) return e
  const int passes = a.passes > 0 ? a.passes : 1;
  unsigned long long h[2][2] = {{0, 0}, {0, 0}};   // [pass][form]
  if (rec.n_forms == 2) {
    cudaGraph_t graph;
    HF_TRY(capture_graph(ss.step, &graph));
    for (int p = 0; p < passes; ++p)
      for (int f = 0; f < 2; ++f) {
        cudaGraphConditionalHandle hc;
        HF_TRY(cudaGraphConditionalHandleCreate(&hc, graph, 0, 0));
        h[p][f] = hc;
      }
    a.h_rline0 = h[0][0]; a.h_adi0 = h[0][1];
    a.h_rline1 = h[1][0]; a.h_adi1 = h[1][1];
    a.set_if = 1;
  }
  long long scratch[64] = {0};
  long long scratch_body[64] = {0};
  HF_TRY(launch_prologue(a, ss.step));
  for (int p = 0; p < passes; ++p) {
    if (a.passes > 0) {
      HF_TRY(launch_residual(a, p, ss.step));
      HF_TRY(launch_scale(a, p, ss.step));
    }
    // the ADI branch first, then the r-line branch: one of them runs
    for (int k = 0; k < rec.n_forms; ++k) {
      const int f = rec.n_forms == 2 ? 1 - k : 0;
      const void* desc = rec.descs[f * passes + p];
      unsigned long long* runs = rec.runs + f;
      long long* cnt = p == 0 ? rec.counts[f] : scratch;
      long long* cnt_body = p == 0 ? rec.counts_body[f] : scratch_body;
      if (rec.n_forms == 1) {
        HF_TRY(hf::record_solve_desc(desc, ss.step, ss.body,
                                     rec.check_every, 1, a.iters + p, runs,
                                     cnt, cnt_body));
        continue;
      }
      cudaGraph_t body;
      HF_TRY(add_conditional(ss.step, h[p][f], cudaGraphCondTypeIf, &body));
      HF_TRY(cudaStreamBeginCaptureToGraph(ss.branch, body, nullptr, nullptr,
                                           0,
                                           cudaStreamCaptureModeThreadLocal));
      const cudaError_t r = hf::record_solve_desc(
          desc, ss.branch, ss.body, rec.check_every, 1, a.iters + p, runs,
          cnt, cnt_body);
      const cudaError_t ended = cudaStreamEndCapture(ss.branch, &body);
      HF_TRY(r);
      HF_TRY(ended);
    }
  }
  return launch_epilogue(a, ss.step);
#undef HF_TRY
}

}  // namespace

// ---------------------------------------------------------------------
// C interface (bound with ctypes by heatflow_tpu_torch/ops/cuda_step.py).
// Every entry returns a cudaError_t code, 0 on success.
// ---------------------------------------------------------------------

extern "C" {

int hf_step_args_bytes() { return (int)sizeof(StepArgs); }

int hf_step_state_bytes() { return (int)sizeof(StepState); }

// One kernel on `stream`, for the step the state holds (the IF and loop
// conditions are not touched).
int hf_step_prologue(const void* args, void* stream) {
  StepArgs a = *(const StepArgs*)args;
  a.set_if = a.set_loop = 0;
  return (int)launch_prologue(a, (cudaStream_t)stream);
}

int hf_refine_residual(const void* args, int p, void* stream) {
  StepArgs a = *(const StepArgs*)args;
  a.set_if = a.set_loop = 0;
  return (int)launch_residual(a, p, (cudaStream_t)stream);
}

int hf_refine_scale(const void* args, int p, void* stream) {
  StepArgs a = *(const StepArgs*)args;
  a.set_if = a.set_loop = 0;
  return (int)launch_scale(a, p, (cudaStream_t)stream);
}

int hf_step_epilogue(const void* args, void* stream) {
  StepArgs a = *(const StepArgs*)args;
  a.set_if = a.set_loop = 0;
  return (int)launch_epilogue(a, (cudaStream_t)stream);
}

// Capture a transient into an executable graph (*exec_out): the steps
// under a conditional WHILE node (the step state's n must be 0 at launch).
// `args` hold the workspace's planes; descs[f * passes + p] the solve
// records (hf_solve_desc) of form f (n_forms 2: r-line, ADI) and pass p,
// whose loop bodies count their runs in the state's runs[f] and whose
// launches are counted in counts[f] (a solve's start and finish) and
// counts_body[f] (one body).
int hf_step_graph(const void* args, const void* const* descs, int n_forms,
                  int check_every, long long* const* counts,
                  long long* const* counts_body, void** exec_out) {
  *exec_out = nullptr;
  StepArgs a = *(const StepArgs*)args;
  a.set_if = a.set_loop = 0;
  if (n_forms < 1 || n_forms > 2 || a.passes > 2 || a.num_steps < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = hf::configure_solves();
  if (e != cudaSuccess) return (int)e;
  cudaStream_t cs = nullptr;
  Streams ss = {nullptr, nullptr, nullptr};
  cudaStream_t* all[4] = {&cs, &ss.step, &ss.branch, &ss.body};
  for (cudaStream_t* st : all)
    if (e == cudaSuccess)
      e = cudaStreamCreateWithFlags(st, cudaStreamNonBlocking);
  // the runs counters' device address (a.st is not read on the host)
  auto* runs = (unsigned long long*)((char*)a.st + offsetof(StepState, runs));
  const SolveRecs rec{descs, n_forms, check_every, runs, counts, counts_body};
  cudaGraph_t graph = nullptr;
  if (e == cudaSuccess)
    e = cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (e == cudaSuccess) {
    cudaGraph_t top, body;
    cudaGraphConditionalHandle hl;
    cudaError_t r = capture_graph(cs, &top);
    if (r == cudaSuccess)
      r = cudaGraphConditionalHandleCreate(&hl, top, 1,
                                           cudaGraphCondAssignDefault);
    if (r == cudaSuccess)
      r = add_conditional(cs, hl, cudaGraphCondTypeWhile, &body);
    if (r == cudaSuccess)
      r = cudaStreamBeginCaptureToGraph(ss.step, body, nullptr, nullptr, 0,
                                        cudaStreamCaptureModeThreadLocal);
    if (r == cudaSuccess) {
      a.h_loop = hl;
      a.set_loop = 1;
      r = record_step(a, ss, rec);
      const cudaError_t ended = cudaStreamEndCapture(ss.step, &body);
      if (r == cudaSuccess) r = ended;
    }
    const cudaError_t ended = cudaStreamEndCapture(cs, &graph);
    e = r != cudaSuccess ? r : ended;
  }
  if (e == cudaSuccess)
    e = cudaGraphInstantiate((cudaGraphExec_t*)exec_out, graph, 0);
  if (graph != nullptr) cudaGraphDestroy(graph);
  for (cudaStream_t* st : all)
    if (*st != nullptr) cudaStreamDestroy(*st);
  return (int)e;
}

}  // extern "C"
