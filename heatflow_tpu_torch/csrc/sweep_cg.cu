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
// What bounds it on an H100: device memory, and the instructions and
// latency of the line solves. One lane's working set is ~10 planes of
// Nz*Nr floats (0.97 MB each on the 243 x 1001 sweep grid), so no block
// holds a solve, and at B = 1024 one per-lane plane is 1 GB: an identity
// iteration of all lanes streams ~12 such planes, ~3.5 us a lane at
// 3.35 TB/s. The 14 shared planes of A0 and Kv (13.6 MB) stay in the 50 MB
// L2; the per-lane operator A0 + dk_b Kv is combined as it is read and
// never stored.
//
// Times below: NVIDIA H100 80GB HBM3, 700 W; device time a lane-iteration
// in the sweeps by torch.profiler (tools/k2_ab.py), where each kernel runs
// with its tail. The variants weighed while the design was chosen were
// timed alone, without tails, by CUDA events ("alone" below). The first
// design (one kernel per CG
// phase over (1024-element tiles x lanes), two scalar kernels an
// iteration) took 9.33 us a lane-iteration in the B = 1024 Jacobi sweep:
// its stencil (4.25 us) re-read the 14 coefficient planes from L2 for
// every lane and divided a 64-bit index per element; its z-line kernel
// (17.5 us in the ADI sweep, 32.9 us a lane-iteration in all) held six
// double-buffered work arrays of Nz x 32 floats (187 KB), one block an SM;
// an identity / r-line / ADI iteration took 5 / 6 / 7 launches. This
// design (6.02 us a lane-iteration at B = 1024, 19.1 in the ADI sweep):
//  * lane-blocked operator passes (ks_apply: the stencil with <p, Ap>, the
//    first residual, the merged-dot pass): a block takes a 16 x 32 tile of
//    the grid and a group of kLaneBlock = 8 consecutive entries of the lane
//    list. Each thread first requests its points' coefficients
//    of A0 and Kv, read once for the group; then the block stages, lane by
//    lane, sm * v over the tile and its halo, and v and sm at its points,
//    in shared memory (a thread loads its own points, the first threads
//    the halo's border, four lanes' loads issued before their stores), and
//    combines each coefficient with each lane's dk: a 2-D tile needs no
//    index division. Lanes past the list's end or done are masked and
//    write no partial. 1.96 us a lane-iteration (0.90 us of traffic); the
//    first form, with the tile's centre values read from device memory
//    lane by lane (each lane's loads waiting for the lane before), took
//    3.15 us alone; 4 or 16 lanes a block, or a bound of four blocks an SM
//    (spills), were slower;
//  * the z-line phase (ks_pcr_z) keeps a column in one warp: the block
//    stages its tile with coalesced reads, lane t of a warp takes kZP
//    consecutive rows into registers, and a PCR level's neighbours at
//    strides below kZP come from its own registers or the next lane, above
//    it by one shuffle: no barrier between the levels, three blocks an SM.
//    8.08 us a lane-iteration in the ADI sweep; alone 7.4 us against 9.4
//    at two blocks an SM, 13.7 with each lane reading its column straight
//    from device memory (32 sectors a load), and 18.2 for one buffer of
//    d, l, u in shared memory (151 registers, one block an SM). Columns
//    taller than 32 * kZP rows take ks_pcr_z_tall, the first design's tile;
//  * the CG scalars ride in per-lane tails: each block writes its partials,
//    fences and takes a ticket of its lane (B words); the block that draws a
//    lane's last ticket reduces that lane's partials in a fixed order (no
//    atomics on values: a run is bitwise repeatable) and sets alpha (after
//    the stencil), or beta, the count and the done flag (after the kernel
//    that writes the last <r, z> partials), or the first step's scalars.
//    ks_pcr_r<true> takes the update x += alpha p, r -= alpha Ap into the
//    r-line PCR of its row. An identity iteration is 3 launches (ks_apply,
//    ks_update with the beta tail, ks_p_update), an r-line one 3 (ks_apply,
//    ks_pcr_r<true>, ks_p_update), an ADI one 4 (+ ks_pcr_z with the beta
//    tail); the merged-dot recurrence's scalars are the tail of its pass
//    (3 / 3 / 4 launches);
//  * the elementwise and row kernels issue a thread's loads before its
//    stores: ks_update 2.41 us a lane-iteration in the B = 1024 sweep
//    (six planes, with the beta tail) against the first design's 3.18;
//    alone, 2.0 us against 3.8;
//  * the host reads one word, the number of lanes still running, every
//    CHECK_EVERY iterations, with a compaction of the running lanes into
//    the lane list; the next launches cover only those lanes. The device
//    idles after those reads for 1.0 % of the B = 1024 sweep's span and
//    2.7 % of the B = 64 ADI sweep's. A lane's arithmetic depends neither
//    on the list, nor on CHECK_EVERY, nor on the lanes that share its
//    block;
//  * the r-line PCR is factored inside the apply: a block of 128 threads
//    takes one grid row of one lane, builds the row's couplings from A0,
//    Kv, dk and sm, and runs the PCR levels on the couplings and the
//    right-hand side together in shared memory (6 rows of Nr floats, 24 KB
//    at Nr = 1001; with the update, 7.4 us a lane-iteration in the ADI
//    sweep; alone, 7.0 us against 7.8 with 256 threads a block). A stored
//    per-lane factor stack would be 21 planes a lane (21 GB at B = 1024);
//  * <r, z> partials: the r-line phase writes one a grid row, the z phase
//    one a column tile; the tails read n_rz = max(Nz, tiles) of them in
//    every ADI or adaptive lane, each phase writing zeros over the slots it
//    does not own, so a lane's sum is the same whichever form ran (adding
//    0.0 changes no sum) and does not depend on its neighbours.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;                   // threads of every 1-D block
constexpr int kPerThread = 4;                   // elements a thread, elementwise
constexpr int kTile = kThreads * kPerThread;    // elements a block, elementwise
constexpr int kCompactThreads = 1024;
constexpr int kMaxSmem = 232448;                // a block's shared memory, H100
constexpr int kTX = 32, kTY = 16, kTYT = 8;     // ks_apply: tile columns, rows,
                                                // thread rows (kTX x kTYT threads)
constexpr int kHX = kTX + 2, kHY = kTY + 2;     // the tile with its halo
constexpr int kZWarps = 8;                      // ks_pcr_z: columns (warps) a block
constexpr int kZP = 8;                          // rows a lane: Nz <= 32 * kZP
constexpr int kZStride = 32 * kZP + kZP + 1;   // ks_pcr_z: a column's slots in
                                                // shared memory (odd)
constexpr int kZStage = 8;                      // ks_pcr_z: loads a thread a batch
constexpr int kReduceThreads = 128;             // threads that sum partials
constexpr int kLaneBlock = 8;                   // ks_apply: lanes a block
constexpr int kRowThreads = 128;                // ks_pcr_r: threads a block
constexpr int kRowPer = 4;                      // ks_pcr_r: loads a thread a batch


// Per-lane solve state (mirrored by heatflow_tpu_torch/ops/cuda_sweep.py:
// k is int32 word 10 and done int32 word 11 of each 48-byte record).
struct LaneState {
  double rz, rr, stop2, alpha, beta;
  int k, done;
};

// Launch-count slots; the Kv-free forms of init and stencil_dot count apart.
enum Phase {
  kPhInit = 0, kPhStencilDot, kPhUpdate, kPhPcrR, kPhPUpdate, kPhCompact,
  kPhFinish, kPhInitNoKv, kPhStencilDotNoKv, kPhPcrZ, kPhMergedW,
  kPhMergedWNoKv, kPhPqUpdate, kPhPcrRUpdate,
  kNumPhases
};

// Partial-sum planes: 4 x B x nparts doubles.
enum Part { kPartPap = 0, kPartRr = 1, kPartRz = 2, kPartBb = 3 };

// What a kernel's per-lane tail computes.
enum TailMode {
  kTailAlpha = 0, kTailInit, kTailBeta, kTailMergedFirst, kTailMerged
};

// A per-lane tail: off when st is null. It runs for the lanes the kernel
// works on and, with flag_sel >= 0, only those whose adaptive flag is
// (flag_sel != 0). n_* partials of each kind a lane (n_rz = 0: z is r).
struct Tail {
  LaneState* st;
  unsigned* tickets;        // one a lane; the last block resets it to 0
  const double* parts;      // the four partial planes
  const float* rtol;
  const int* flags;
  int B, nparts, mode, n_pap, n_rr, n_rz, n_bb;
  int maxiter, wrt_r0, fixed, precond, flag_sel;
};

__device__ __forceinline__ int tid_of() {
  return threadIdx.y * blockDim.x + threadIdx.x;
}

// Sum of v over the block; the result is valid in every thread.
__device__ double block_sum(double v) {
  __shared__ double warp_part[32];
  __shared__ double total;
  const int tid = tid_of();
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

// Reduce n partials in a fixed order, the same whatever the block's size
// (kReduceThreads of its threads sum); valid in all threads. The partials
// bypass L1: a tail reads what the other blocks wrote.
__device__ double reduce_parts(const double* part, int n) {
  const int tid = tid_of();
  double s = 0.0;
  if (tid < kReduceThreads)
    for (int t = tid; t < n; t += kReduceThreads) s += __ldcg(part + t);
  return block_sum(s);
}

// The CG scalars: the guards and stop rule of the TPU kernel. pAp == 0 ->
// 1, rz == 0 -> 1; rr is <r, r> when preconditioned and rz otherwise; the
// tolerance mode runs while k < maxiter && rr > stop2 (a NaN rr stops the
// lane), the fixed mode while k < maxiter.
__device__ void init_rule(LaneState* s, double rr, double rz, double bb,
                          bool precond, double rt, int maxiter, int wrt_r0,
                          int fixed) {
  s->rz = rz;
  s->rr = precond ? rr : rz;
  s->stop2 = rt * rt * (wrt_r0 ? s->rr : bb);
  s->alpha = 0.0;
  s->beta = 0.0;
  s->k = 0;
  s->done = fixed ? !(0 < maxiter) : !(0 < maxiter && s->rr > s->stop2);
}

__device__ void alpha_rule(LaneState* s, double pap) {
  s->alpha = s->rz / (pap != 0.0 ? pap : 1.0);
}

__device__ void beta_rule(LaneState* s, double rr, double rz, bool precond,
                          int maxiter, int fixed) {
  s->beta = rz / (s->rz != 0.0 ? s->rz : 1.0);
  s->rz = rz;
  s->rr = precond ? rr : rz;
  s->k += 1;
  s->done = fixed ? !(s->k < maxiter) : !(s->k < maxiter && s->rr > s->stop2);
}

// The merged recurrence: gamma = <r, u> (kept in rz), delta = <w, u>. First
// call: alpha = gamma / delta, the stop target and the first stop test on
// <r0, r0>; later: beta = gamma' / gamma, alpha' = gamma' / (delta -
// beta gamma' / alpha), each divisor 0 -> 1.
__device__ void merged_rule(LaneState* s, double delta, double rr,
                            double gamma, double bb, bool first, bool precond,
                            double rt, int maxiter, int wrt_r0) {
  if (first) {
    s->rz = gamma;
    s->rr = rr;
    s->stop2 = rt * rt * (wrt_r0 ? rr : bb);
    s->alpha = gamma / (delta != 0.0 ? delta : 1.0);
    s->beta = 0.0;
    s->k = 0;
    s->done = !(0 < maxiter && s->rr > s->stop2);
    return;
  }
  const double beta = gamma / (s->rz != 0.0 ? s->rz : 1.0);
  const double denom =
      delta - beta * gamma / (s->alpha != 0.0 ? s->alpha : 1.0);
  s->alpha = gamma / (denom != 0.0 ? denom : 1.0);
  s->beta = beta;
  s->rz = gamma;
  s->rr = precond ? rr : gamma;
  s->k += 1;
  s->done = !(s->k < maxiter && s->rr > s->stop2);
}

__device__ __forceinline__ bool tail_on(const Tail& t, int lane) {
  return t.st != nullptr &&
         (t.flag_sel < 0 || (t.flags[lane] != 0) == (t.flag_sel != 0));
}

// The tail of one lane, run by every thread of the block that drew the
// lane's last ticket.
__device__ void lane_tail(const Tail& t, int lane) {
  const size_t plane = (size_t)t.B * t.nparts;
  const double* base = t.parts + (size_t)lane * t.nparts;
  LaneState* s = t.st + lane;
  const bool tid0 = tid_of() == 0;
  const bool first = t.mode == kTailInit || t.mode == kTailMergedFirst;
  const double rt = first && !t.fixed ? (double)t.rtol[lane] : 0.0;
  if (t.mode == kTailAlpha) {
    const double pap = reduce_parts(base + kPartPap * plane, t.n_pap);
    if (tid0) alpha_rule(s, pap);
  } else if (t.mode == kTailInit || t.mode == kTailBeta) {
    const double rr = reduce_parts(base + kPartRr * plane, t.n_rr);
    const double rz =
        t.n_rz > 0 ? reduce_parts(base + kPartRz * plane, t.n_rz) : rr;
    if (t.mode == kTailInit) {
      const double bb = reduce_parts(base + kPartBb * plane, t.n_bb);
      if (tid0)
        init_rule(s, rr, rz, bb, t.n_rz > 0, rt, t.maxiter, t.wrt_r0,
                  t.fixed);
    } else if (tid0) {
      beta_rule(s, rr, rz, t.n_rz > 0, t.maxiter, t.fixed);
    }
  } else {
    const double delta = reduce_parts(base + kPartPap * plane, t.n_pap);
    const double rr = reduce_parts(base + kPartRr * plane, t.n_rr);
    const double gamma = reduce_parts(base + kPartRz * plane, t.n_rz);
    const double bb =
        first ? reduce_parts(base + kPartBb * plane, t.n_bb) : 0.0;
    if (tid0)
      merged_rule(s, delta, rr, gamma, bb, first, t.precond != 0, rt,
                  t.maxiter, t.wrt_r0);
  }
  if (tid0) t.tickets[lane] = 0;
}

// The tail of a block that works on one lane: every thread that wrote a
// partial has fenced; the block takes a ticket of the lane, and the block
// that draws the last one (gridDim.x blocks a lane) runs the lane's tail.
__device__ void single_tail(const Tail& t, int lane) {
  if (!tail_on(t, lane)) return;
  __shared__ bool last;
  __syncthreads();
  if (tid_of() == 0) {
    __threadfence();
    last = atomicAdd(t.tickets + lane, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) lane_tail(t, lane);
}

// The same for a block that works on a group of lanes (lane_s[j] < 0: not
// worked on): a ticket of each lane, then the tail of each lane whose last
// ticket the block drew.
__device__ void group_tail(const Tail& t, const int* lane_s, int L) {
  if (t.st == nullptr) return;
  __shared__ unsigned last_mask;
  __syncthreads();
  if (tid_of() == 0) {
    __threadfence();
    unsigned m = 0;
    for (int j = 0; j < L; ++j) {
      const int lane = lane_s[j];
      if (lane >= 0 && tail_on(t, lane) &&
          atomicAdd(t.tickets + lane, 1u) == gridDim.x - 1)
        m |= 1u << j;
    }
    last_mask = m;
  }
  __syncthreads();
  const unsigned m = last_mask;
  for (int j = 0; j < L; ++j)
    if ((m >> j) & 1u) lane_tail(t, lane_s[j]);
}

// Thread 0 writes a one-lane block's partial, with zeros over the slots
// [gridDim.x, n_fill) it does not own, and fences.
__device__ void write_partial(double* part, double v, int n_fill) {
  if (tid_of() != 0 || part == nullptr) return;
  part[blockIdx.x] = v;
  for (int q = gridDim.x + blockIdx.x; q < n_fill; q += gridDim.x)
    part[q] = 0.0;
  __threadfence();
}

// The shared-memory slot of row i of a ks_pcr_z column.
__device__ __forceinline__ int zslot(int i) { return i + (i >> 5); }

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

enum ApplyMode { kApStencil = 0, kApInit = 1, kApMerged = 2 };

// The lane-blocked operator pass. A block takes a kTY x kTX tile of the
// grid (blockIdx.x, row-major over the tiles) and the lanes
// lanes[blockIdx.y * L .. + L) (a lane past n_lanes, or done, is masked).
// Each thread first requests its points' NPTS coefficients of A0 and Kv
// (read once for all the lanes); then for each lane the block stages
// sv = sm * v over the tile and its one-point halo (0 outside the grid),
// and v, sm (and aux) at the tile's points, in shared memory, a thread
// loading its own points and the first threads the halo's border; at each
// point
//   A_b (sm v) = sum_k (A0[k] + dk_b Kv[k]) sv[point + offset_k]
// in the offset order of heatflow_tpu_torch/ops/stencil.py (OFFSETS, then
// OFFSETS9's two). Then, with s = sm A_b (sm v):
//   kApStencil: out = Ap = s, the tile's partial of <p, Ap> (part0);
//   kApInit: x = x0 (v), out = r = b - s (aux = b), partials of <r, r>
//     (part0) and <b, b> (part1);
//   kApMerged: out = w = s (v = u, aux = r), partials of delta = <w, u>
//     (part0), <r, r> (part1) and gamma = <r, u> (part2).
// A thread sums its points in order, a warp by shuffles, the block over its
// warps in order: one partial a (lane, tile), whichever lanes share the
// block. Then the per-lane tail.
template <bool HAS_KV, int MODE, int NPTS>
__global__ void __launch_bounds__(kTX * kTYT)
    ks_apply(const float* __restrict__ A0, const float* __restrict__ Kv,
             const float* __restrict__ dks, const float* __restrict__ sm,
             size_t sm_stride, const float* __restrict__ v,
             const float* __restrict__ aux, float* __restrict__ out,
             float* __restrict__ x, double* part0, double* part1,
             double* part2, const LaneState* st,
             const int* __restrict__ lanes, int n_lanes, int nz, int nr,
             int nparts, Tail tail) {
  constexpr int K = MODE == kApStencil ? 1 : MODE == kApInit ? 2 : 3;
  constexpr int R = kTY / kTYT, L = kLaneBlock;
  constexpr int NB = 2 * kHX + 2 * kTY;       // the halo's border points
  constexpr int HALO = kHY * kHX, PTS = kTY * kTX;
  extern __shared__ float apply_sh[];
  float* sv = apply_sh;                       // L x HALO
  float* cv = sv + L * HALO;                  // L x PTS: v at the points
  float* cs = cv + L * PTS;                   // sm at the points
  float* ca = cs + L * PTS;                   // aux at the points
  __shared__ int lane_s[L];
  __shared__ float dk_s[L];
  __shared__ double wsum[K][L][kTYT];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTX + tx;
  const int tiles_x = (nr + kTX - 1) / kTX;
  const int i0 = (blockIdx.x / tiles_x) * kTY;
  const int j0 = (blockIdx.x % tiles_x) * kTX;
  if (tid < L) {
    const int g = blockIdx.y * L + tid;
    int lane = g < n_lanes ? lanes[g] : -1;
    if (lane >= 0 && st != nullptr && st[lane].done) lane = -1;
    lane_s[tid] = lane;
    dk_s[tid] = HAS_KV && lane >= 0 ? dks[lane] : 0.0f;
  }
  __syncthreads();
  bool any = false;
  for (int j = 0; j < L; ++j) any |= lane_s[j] >= 0;
  if (!any) return;
  const int n = nz * nr;
  // this thread's points and their coefficients, requested first
  const int jj = j0 + tx;
  bool in[R];
  int idx[R];
  float a[R][NPTS], kv[R][NPTS];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = i0 + ty + r * kTYT;
    in[r] = i < nz && jj < nr;
    idx[r] = in[r] ? i * nr + jj : 0;
#pragma unroll
    for (int k = 0; k < NPTS; ++k) {
      a[r][k] = in[r] ? A0[(size_t)k * n + idx[r]] : 0.0f;
      kv[r][k] = HAS_KV && in[r] ? Kv[(size_t)k * n + idx[r]] : 0.0f;
    }
  }
  // the border point this thread loads (tid < NB): the halo's top and
  // bottom rows, then its left and right columns
  const int bhi = tid < kHX ? 0 : tid < 2 * kHX ? kHY - 1
                                                 : 1 + (tid - 2 * kHX) / 2;
  const int bhj = tid < 2 * kHX ? tid % kHX : ((tid - 2 * kHX) % 2) * (kHX - 1);
  const int bi = i0 - 1 + bhi, bj = j0 - 1 + bhj;
  const bool bin = tid < NB && bi >= 0 && bi < nz && bj >= 0 && bj < nr;
  const int bidx = bin ? bi * nr + bj : 0;
  // the lanes' tiles, four lanes' loads issued before their stores
#pragma unroll
  for (int j4 = 0; j4 < L; j4 += 4) {
    float pv[4][R], ps[4][R], pa[4][R], bv[4], bs[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int lane = lane_s[j4 + q];
      const float* vl = v + (size_t)(lane < 0 ? 0 : lane) * n;
      const float* sl = sm + (size_t)(lane < 0 ? 0 : lane) * sm_stride;
      const float* al = aux + (size_t)(lane < 0 ? 0 : lane) * n;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool ok = lane >= 0 && in[r];
        pv[q][r] = ok ? vl[idx[r]] : 0.0f;
        ps[q][r] = ok ? sl[idx[r]] : 0.0f;
        pa[q][r] = MODE != kApStencil && ok ? al[idx[r]] : 0.0f;
      }
      bv[q] = lane >= 0 && bin ? vl[bidx] : 0.0f;
      bs[q] = lane >= 0 && bin ? sl[bidx] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j4 + q;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int pt = (ty + r * kTYT) * kTX + tx;
        sv[j * HALO + (ty + r * kTYT + 1) * kHX + tx + 1] = ps[q][r] * pv[q][r];
        cv[j * PTS + pt] = pv[q][r];
        cs[j * PTS + pt] = ps[q][r];
        if (MODE != kApStencil) ca[j * PTS + pt] = pa[q][r];
      }
      if (tid < NB) sv[j * HALO + bhi * kHX + bhj] = bs[q] * bv[q];
    }
  }
  __syncthreads();
  double acc0[L], acc1[L], acc2[L];
#pragma unroll
  for (int j = 0; j < L; ++j) {
    acc0[j] = acc1[j] = acc2[j] = 0.0;
    const int lane = lane_s[j];
    if (lane < 0) continue;
    const float dk = dk_s[j];
    const size_t off = (size_t)lane * n;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* t = sv + j * HALO + (ty + r * kTYT + 1) * kHX + tx + 1;
      float c[NPTS];
#pragma unroll
      for (int k = 0; k < NPTS; ++k)
        c[k] = HAS_KV ? a[r][k] + dk * kv[r][k] : a[r][k];
      float acc = c[0] * t[0];
      acc += c[1] * t[kHX];
      acc += c[2] * t[-kHX];
      acc += c[3] * t[1];
      acc += c[4] * t[-1];
      acc += c[5] * t[kHX + 1];
      acc += c[6] * t[-kHX - 1];
      if constexpr (NPTS > 7) {
        acc += c[7] * t[kHX - 1];
        acc += c[8] * t[-kHX + 1];
      }
      const int pt = j * PTS + (ty + r * kTYT) * kTX + tx;
      const float smv = cs[pt], vv = cv[pt];
      if (MODE == kApStencil) {
        const float val = smv * acc;
        if (in[r]) out[off + idx[r]] = val;
        s0 += (double)(vv * val);
      } else if (MODE == kApInit) {
        const float bv = ca[pt];
        const float rv = bv - smv * acc;
        if (in[r]) {
          x[off + idx[r]] = vv;
          out[off + idx[r]] = rv;
        }
        s0 += (double)(rv * rv);
        s1 += (double)(bv * bv);
      } else {
        const float wv = smv * acc;
        const float rv = ca[pt];
        if (in[r]) out[off + idx[r]] = wv;
        s0 += (double)(wv * vv);
        s1 += (double)(rv * rv);
        s2 += (double)(rv * vv);
      }
    }
    acc0[j] = s0;
    acc1[j] = s1;
    acc2[j] = s2;
  }
  // the lanes' warp sums, independent of each other
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const double s0 = warp_sum(acc0[j]);
    const double s1 = K > 1 ? warp_sum(acc1[j]) : 0.0;
    const double s2 = K > 2 ? warp_sum(acc2[j]) : 0.0;
    if (tx == 0) {
      wsum[0][j][ty] = s0;
      if (K > 1) wsum[K > 1 ? 1 : 0][j][ty] = s1;
      if (K > 2) wsum[K > 2 ? 2 : 0][j][ty] = s2;
    }
  }
  __syncthreads();
  if (tid < K * L) {
    const int k = tid / L, j = tid % L;
    const int lane = lane_s[j];
    if (lane >= 0) {
      double s = 0.0;
      for (int w = 0; w < kTYT; ++w) s += wsum[k][j][w];
      double* part = k == 0 ? part0 : k == 1 ? part1 : part2;
      part[(size_t)lane * nparts + blockIdx.x] = s;
      __threadfence();
    }
  }
  group_tail(tail, lane_s, L);
}

// ks_apply's dynamic shared memory: the halo tiles and the point tiles.
constexpr size_t apply_smem(int mode) {
  return (size_t)kLaneBlock *
         (kHY * kHX + (mode == kApStencil ? 2 : 3) * kTY * kTX) *
         sizeof(float);
}

__device__ __forceinline__ size_t elem(int m) {
  return (size_t)blockIdx.x * kTile + (size_t)m * kThreads + threadIdx.x;
}

// x += alpha p, r -= alpha Ap; partials of <r, r> (part_rr may be null: the
// merged recurrence takes <r, r> in its own pass); then the tail (the
// identity form's beta step).
__global__ void ks_update(float* __restrict__ x, float* __restrict__ r,
                          const float* __restrict__ p,
                          const float* __restrict__ Ap, double* part_rr,
                          const LaneState* st, const int* __restrict__ lanes,
                          size_t n, int nparts, Tail tail) {
  const int lane = lanes[blockIdx.y];
  if (st[lane].done) return;
  const float alpha = (float)st[lane].alpha;
  const size_t off = (size_t)lane * n;
  float xv[kPerThread], pv[kPerThread], rv[kPerThread], av[kPerThread];
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) {
      xv[m] = x[off + idx];
      pv[m] = p[off + idx];
      rv[m] = r[off + idx];
      av[m] = Ap[off + idx];
    }
  }
  double acc = 0.0;
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) {
      x[off + idx] = xv[m] + alpha * pv[m];
      const float rn = rv[m] - alpha * av[m];
      r[off + idx] = rn;
      acc += (double)(rn * rn);
    }
  }
  if (part_rr != nullptr) {
    acc = block_sum(acc);
    write_partial(part_rr + (size_t)lane * nparts, acc, 0);
  }
  single_tail(tail, lane);
}

// r-line PCR apply with the factorization done on the fly; one block per
// (grid row, lane). With kUpdate the block first takes the CG update of its
// row, x += alpha p, r -= alpha Ap, and the row's partial of <r, r>
// (part_rr, may be null). The row's couplings of the scaled operator,
//   u[j] = sm[j] (A0 + dk Kv)[3][j] sm[j+1],  l[j] = sm[j] (A0 + dk Kv)[4][j] sm[j-1]
// (zero past the row's ends), and the right-hand side d = r go to shared
// memory; level k (stride s = 2^k) of parallel cyclic reduction is
//   a = 1 - l[j] u[j-s] - u[j] l[j+s]
//   d'[j] = (d[j] - l[j] d[j-s] - u[j] d[j+s]) / a
//   l'[j] = -l[j] l[j-s] / a,   u'[j] = -u[j] u[j+s] / a,
// double buffered, until the stride covers the row; then
// z = d * free with free = (sm != 0), the row's partial of <r, z> (zeros
// over the slots [Nz, n_rz)), and the tail.
template <bool kUpdate>
__global__ void __launch_bounds__(kRowThreads, 8)
    ks_pcr_r(const float* __restrict__ A0, const float* __restrict__ Kv,
             const float* __restrict__ dks, const float* __restrict__ sm,
             size_t sm_stride, float* __restrict__ r, float* __restrict__ z,
             float* __restrict__ x, const float* __restrict__ p,
             const float* __restrict__ Ap, double* part_rr, double* part_rz,
             int n_rz, const LaneState* st, const int* __restrict__ lanes,
             int nz, int nr, int nparts, Tail tail) {
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
  const float alpha = kUpdate ? (float)st[lane].alpha : 0.0f;
  const float* smr = sm + (size_t)lane * sm_stride + row;
  double rr = 0.0;
  for (int j0 = 0; j0 < nr; j0 += kRowThreads * kRowPer) {
    // the chunk's loads, all issued before its stores
    float sj[kRowPer], sp[kRowPer], sq[kRowPer], cu[kRowPer], cl[kRowPer];
    float rv[kRowPer], xv[kRowPer], pv[kRowPer], av[kRowPer];
#pragma unroll
    for (int k = 0; k < kRowPer; ++k) {
      const int j = j0 + k * kRowThreads + threadIdx.x;
      if (j < nr) {
        sj[k] = smr[j];
        sp[k] = j + 1 < nr ? smr[j + 1] : 0.0f;
        sq[k] = j >= 1 ? smr[j - 1] : 0.0f;
        cu[k] = Kv != nullptr ? A0[3 * n + row + j] + dk * Kv[3 * n + row + j]
                              : A0[3 * n + row + j];
        cl[k] = Kv != nullptr ? A0[4 * n + row + j] + dk * Kv[4 * n + row + j]
                              : A0[4 * n + row + j];
        rv[k] = r[off + j];
        if (kUpdate) {
          xv[k] = x[off + j];
          pv[k] = p[off + j];
          av[k] = Ap[off + j];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kRowPer; ++k) {
      const int j = j0 + k * kRowThreads + threadIdx.x;
      if (j < nr) {
        u0[j] = j + 1 < nr ? sj[k] * cu[k] * sp[k] : 0.0f;
        l0[j] = j >= 1 ? sj[k] * cl[k] * sq[k] : 0.0f;
        float rn = rv[k];
        if (kUpdate) {
          x[off + j] = xv[k] + alpha * pv[k];
          rn = rv[k] - alpha * av[k];
          r[off + j] = rn;
          rr += (double)(rn * rn);
        }
        d0[j] = rn;
      }
    }
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
  if (kUpdate && part_rr != nullptr) {
    rr = block_sum(rr);
    write_partial(part_rr + (size_t)lane * nparts, rr, 0);
  }
  acc = block_sum(acc);
  write_partial(part_rz + (size_t)lane * nparts, acc, n_rz);
  single_tail(tail, lane);
}

// One PCR level of ks_pcr_z at stride S on the kZP rows i = t * kZP + m a
// lane holds (t the lane of the warp): the rows i -/+ S lie in the same
// lane's registers or the lane before / after it (S < kZP), or S / kZP
// lanes away in the same slot; rows outside [0, nz) read as 0.
template <int S>
__device__ __forceinline__ void z_level(float (&l)[kZP], float (&u)[kZP],
                                        float (&d)[kZP], int t, int nz) {
  constexpr unsigned kAll = 0xffffffffu;
  float lm[kZP], um[kZP], dm[kZP], lp[kZP], up[kZP], dp[kZP];
#pragma unroll
  for (int m = 0; m < kZP; ++m) {
    if constexpr (S < kZP) {
      if (m >= S) {
        lm[m] = l[m - S]; um[m] = u[m - S]; dm[m] = d[m - S];
      } else {
        lm[m] = __shfl_up_sync(kAll, l[m - S + kZP], 1);
        um[m] = __shfl_up_sync(kAll, u[m - S + kZP], 1);
        dm[m] = __shfl_up_sync(kAll, d[m - S + kZP], 1);
      }
      if (m + S < kZP) {
        lp[m] = l[m + S]; up[m] = u[m + S]; dp[m] = d[m + S];
      } else {
        lp[m] = __shfl_down_sync(kAll, l[m + S - kZP], 1);
        up[m] = __shfl_down_sync(kAll, u[m + S - kZP], 1);
        dp[m] = __shfl_down_sync(kAll, d[m + S - kZP], 1);
      }
    } else {
      constexpr int A = S / kZP;
      lm[m] = __shfl_up_sync(kAll, l[m], A);
      um[m] = __shfl_up_sync(kAll, u[m], A);
      dm[m] = __shfl_up_sync(kAll, d[m], A);
      lp[m] = __shfl_down_sync(kAll, l[m], A);
      up[m] = __shfl_down_sync(kAll, u[m], A);
      dp[m] = __shfl_down_sync(kAll, d[m], A);
    }
  }
#pragma unroll
  for (int m = 0; m < kZP; ++m) {
    const int i = t * kZP + m;
    const bool lo_in = i - S >= 0, up_in = i + S < nz;
    const float lj = l[m], uj = u[m];
    const float u_m = lo_in ? um[m] : 0.0f;
    const float l_p = up_in ? lp[m] : 0.0f;
    const float d_m = lo_in ? dm[m] : 0.0f;
    const float d_p = up_in ? dp[m] : 0.0f;
    const float inv_a = 1.0f / (1.0f - lj * u_m - uj * l_p);
    d[m] = (d[m] - lj * d_m - uj * d_p) * inv_a;
    l[m] = -lj * (lo_in ? lm[m] : 0.0f) * inv_a;
    u[m] = -uj * (up_in ? up[m] : 0.0f) * inv_a;
  }
}

// z-line PCR of the ADI form, z = R r + Z r - r, with the factorization
// done on the fly, for columns of at most 32 * kZP rows; one block per
// (kZWarps adjacent columns, lane), one warp a column. On entry z holds
// R r (ks_pcr_r). The block first copies its tile (sm, r and the two
// coupling coefficients A0 + dk Kv; slots 1/2 are offsets (+1, 0) /
// (-1, 0)) into shared memory with coalesced reads, a column at stride
// kZStride with slot i + i / 32, so that a lane's kZP consecutive rows fall
// in distinct banks. Lane t of a warp then takes rows t * kZP .. + kZP of
// its column into registers: the column's couplings of the scaled operator,
//   u[i] = sm[i] (A0 + dk Kv)[1][i] sm[i+1],  l[i] = sm[i] (A0 + dk Kv)[2][i] sm[i-1]
// (zero past the column's ends), and d = r; the PCR levels of ks_pcr_r run
// along i with the neighbours from registers and shuffles (z_level), no
// barrier between them; each warp writes d back, and the block forms
// z = (R r + d - r) * free over the tile with coalesced reads and writes,
// the block's partial of <r, z> (zeros over [tiles, n_rz)) and the tail.
// Three blocks an SM (80 registers a thread). With flags (the adaptive
// form) a lane whose flag is 0 returns at once: its z stays R r.
__global__ void __launch_bounds__(kZWarps * 32, 3)
    ks_pcr_z(const float* __restrict__ A0, const float* __restrict__ Kv,
             const float* __restrict__ dks, const float* __restrict__ sm,
             size_t sm_stride, const float* __restrict__ r,
             float* __restrict__ z, double* part_rz, int n_rz,
             const LaneState* st, const int* __restrict__ flags,
             const int* __restrict__ lanes, int nz, int nr, int nparts,
             Tail tail) {
  constexpr int W = kZWarps, NT = kZWarps * 32;
  __shared__ float sh_s[W * kZStride], sh_r[W * kZStride];
  __shared__ float sh_u[W * kZStride], sh_l[W * kZStride];
  const int lane = lanes[blockIdx.y];
  if (st != nullptr && st[lane].done) return;
  if (flags != nullptr && flags[lane] == 0) return;
  const size_t n = (size_t)nz * nr;
  const size_t off = (size_t)lane * n;
  const float dk = Kv != nullptr ? dks[lane] : 0.0f;
  const float* sml = sm + (size_t)lane * sm_stride;
  const int c0 = blockIdx.x * W;
  const int tid = threadIdx.x;
  const int total = nz * W;
  for (int e0 = 0; e0 < total; e0 += NT * kZStage) {
    float vs[kZStage], vr[kZStage], vu[kZStage], vl[kZStage];
#pragma unroll
    for (int k = 0; k < kZStage; ++k) {
      const int e = e0 + k * NT + tid;
      const int i = e / W, j = c0 + e % W;
      const bool ok = e < total && j < nr;
      const size_t idx = ok ? (size_t)i * nr + j : 0;
      vs[k] = ok ? sml[idx] : 0.0f;
      vr[k] = ok ? r[off + idx] : 0.0f;
      vu[k] = !ok ? 0.0f
                  : Kv != nullptr ? A0[n + idx] + dk * Kv[n + idx]
                                  : A0[n + idx];
      vl[k] = !ok ? 0.0f
                  : Kv != nullptr ? A0[2 * n + idx] + dk * Kv[2 * n + idx]
                                  : A0[2 * n + idx];
    }
#pragma unroll
    for (int k = 0; k < kZStage; ++k) {
      const int e = e0 + k * NT + tid;
      if (e < total) {
        const int q = (e % W) * kZStride + zslot(e / W);
        sh_s[q] = vs[k];
        sh_r[q] = vr[k];
        sh_u[q] = vu[k];
        sh_l[q] = vl[k];
      }
    }
  }
  __syncthreads();
  const int t = tid & 31, c = tid >> 5;
  const bool col = c0 + c < nr;
  float s[kZP], cu[kZP], cl[kZP], l[kZP], u[kZP], d[kZP];
#pragma unroll
  for (int m = 0; m < kZP; ++m) {
    const int i = t * kZP + m;
    const bool ok = i < nz;
    const int q = c * kZStride + zslot(ok ? i : 0);
    s[m] = ok ? sh_s[q] : 0.0f;
    d[m] = ok ? sh_r[q] : 0.0f;
    cu[m] = ok ? sh_u[q] : 0.0f;
    cl[m] = ok ? sh_l[q] : 0.0f;
  }
  // sm of the rows just below / above this lane's block of rows
  const float s_next = __shfl_down_sync(0xffffffffu, s[0], 1);
  const float s_prev = __shfl_up_sync(0xffffffffu, s[kZP - 1], 1);
#pragma unroll
  for (int m = 0; m < kZP; ++m) {
    const int i = t * kZP + m;
    const bool ok = col && i < nz;
    const float s_up = m + 1 < kZP ? s[m + 1] : s_next;
    const float s_dn = m > 0 ? s[m - 1] : s_prev;
    u[m] = ok && i + 1 < nz ? s[m] * cu[m] * s_up : 0.0f;
    l[m] = ok && i >= 1 ? s[m] * cl[m] * s_dn : 0.0f;
  }
  if (1 < nz) z_level<1>(l, u, d, t, nz);
  if (2 < nz) z_level<2>(l, u, d, t, nz);
  if (4 < nz) z_level<4>(l, u, d, t, nz);
  if (8 < nz) z_level<8>(l, u, d, t, nz);
  if (16 < nz) z_level<16>(l, u, d, t, nz);
  if (32 < nz) z_level<32>(l, u, d, t, nz);
  if (64 < nz) z_level<64>(l, u, d, t, nz);
  if (128 < nz) z_level<128>(l, u, d, t, nz);
#pragma unroll
  for (int m = 0; m < kZP; ++m) {
    const int i = t * kZP + m;
    if (i < nz) sh_u[c * kZStride + zslot(i)] = d[m];
  }
  __syncthreads();
  double acc = 0.0;
  for (int e = tid; e < total; e += NT) {
    const int i = e / W, j = c0 + e % W;
    if (j < nr) {
      const int q = (e % W) * kZStride + zslot(i);
      const size_t idx = off + (size_t)i * nr + j;
      const float fm = sh_s[q] != 0.0f ? 1.0f : 0.0f;
      const float rv = sh_r[q];
      const float zv = (z[idx] + sh_u[q] - rv) * fm;
      z[idx] = zv;
      acc += (double)(rv * zv);
    }
  }
  acc = block_sum(acc);
  write_partial(part_rz + (size_t)lane * nparts, acc, n_rz);
  single_tail(tail, lane);
}

// The same for taller columns: a tile of tw adjacent columns of one lane
// (the widest power of two up to 32 whose six double-buffered work arrays
// of Nz floats fit a block's shared memory, pcr_z_width), element (i, tx)
// at i * tw + tx; thread x takes column x % tw and rows x / tw, + 256 / tw,
// ...
__global__ void __launch_bounds__(kThreads)
    ks_pcr_z_tall(const float* __restrict__ A0, const float* __restrict__ Kv,
                  const float* __restrict__ dks, const float* __restrict__ sm,
                  size_t sm_stride, const float* __restrict__ r,
                  float* __restrict__ z, double* part_rz, int n_rz,
                  const LaneState* st, const int* __restrict__ flags,
                  const int* __restrict__ lanes, int nz, int nr, int nparts,
                  int tw, Tail tail) {
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
  write_partial(part_rz + (size_t)lane * nparts, acc, n_rz);
  single_tail(tail, lane);
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
  float zv[kPerThread], pv[kPerThread];
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) {
      zv[m] = z[off + idx];
      pv[m] = first ? 0.0f : p[off + idx];
    }
  }
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) p[off + idx] = first ? zv[m] : zv[m] + beta * pv[m];
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
  float uv[kPerThread], wv[kPerThread], pv[kPerThread], qv[kPerThread];
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) {
      uv[m] = u[off + idx];
      wv[m] = w[off + idx];
      pv[m] = first ? 0.0f : p[off + idx];
      qv[m] = first ? 0.0f : q[off + idx];
    }
  }
#pragma unroll
  for (int m = 0; m < kPerThread; ++m) {
    const size_t idx = elem(m);
    if (idx < n) {
      p[off + idx] = first ? uv[m] : uv[m] + beta * pv[m];
      q[off + idx] = first ? wv[m] : wv[m] + beta * qv[m];
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

int tiles2d_of(int nz, int nr) {
  return ((nz + kTY - 1) / kTY) * ((nr + kTX - 1) / kTX);
}

// Columns of a ks_pcr_z_tall tile: the widest power of two up to 32 whose
// six work arrays of nz floats fit in a block's shared memory (0: none fits).
int pcr_z_width(int nz) {
  for (int tw = 32; tw >= 1; tw >>= 1)
    if (6 * (size_t)nz * tw * sizeof(float) <= (size_t)kMaxSmem) return tw;
  return 0;
}

// The z-line kernel a column of nz rows takes: 0 ks_pcr_z, 1
// ks_pcr_z_tall, -1 none.
int z_path(int nz) {
  if (nz <= 32 * kZP) return 0;
  return pcr_z_width(nz) > 0 ? 1 : -1;
}

int z_tiles_of(int nz, int nr) {
  switch (z_path(nz)) {
    case 0: return (nr + kZWarps - 1) / kZWarps;
    case 1: return (nr + pcr_z_width(nz) - 1) / pcr_z_width(nz);
    default: return 0;
  }
}

// <r, z> partials a lane's tail reads: one a grid row (r-line),
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
  unsigned* tickets;  // the tails' tickets, B words

  size_t n() const { return (size_t)nz * nr; }
  int tiles() const { return tiles_of(nz, nr); }
  int tiles2d() const { return tiles2d_of(nz, nr); }
  double* part(int which) const {
    return parts + (size_t)which * B * nparts;
  }
  int n_rz() const { return n_rz_of(nz, nr, rline, adi); }
  // a tail of this solve: <r, r> from n_rr partials, <r, z> from n_rz
  Tail tail(int mode, int n_rr, int n_rz, int flag_sel) const {
    return Tail{st, tickets, parts, rtol, flags, B, nparts, mode, tiles2d(),
                n_rr, n_rz, tiles2d(), maxiter, wrt_r0, fixed, rline,
                flag_sel};
  }
};

Tail no_tail() { return Tail{}; }

// One launcher per phase kernel, shared by the solves and by the
// single-phase entry points; each counts its launch. Kv == nullptr selects
// the Kv-free form of the kernels that read the operator.
template <bool HAS_KV, int MODE, int NPTS>
cudaError_t apply_kernel(dim3 grid, cudaStream_t stream, const float* A0,
                         const float* Kv, const float* dks, const float* sm,
                         size_t sm_stride, const float* v, const float* aux,
                         float* out, float* x, double* p0, double* p1,
                         double* p2, const LaneState* st, const int* lanes,
                         int n_lanes, int nz, int nr, int nparts,
                         const Tail& tail) {
  constexpr size_t smem = apply_smem(MODE);
  // the kernel's shared-memory opt-in, once a process and device
  static unsigned sized = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 32 || !((sized >> dev) & 1u)) {
    e = cudaFuncSetAttribute((const void*)ks_apply<HAS_KV, MODE, NPTS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < 32) sized |= 1u << dev;
  }
  ks_apply<HAS_KV, MODE, NPTS><<<grid, dim3(kTX, kTYT), smem, stream>>>(
      A0, Kv, dks, sm, sm_stride, v, aux, out, x, p0, p1, p2, st, lanes,
      n_lanes, nz, nr, nparts, tail);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_apply(const float* A0, const float* Kv, int npts,
                         const float* dks, const float* sm, size_t sm_stride,
                         const float* v, const float* aux, float* out,
                         float* x, double* p0, double* p1, double* p2,
                         const LaneState* st, const int* lanes, int n_lanes,
                         int nz, int nr, int nparts, const Tail& tail,
                         long long* counts, cudaStream_t stream) {
  const dim3 grid(tiles2d_of(nz, nr),
                  (n_lanes + kLaneBlock - 1) / kLaneBlock);
#define HF_APPLY(KV, NP)                                                    \
  apply_kernel<KV, MODE, NP>(grid, stream, A0, Kv, dks, sm, sm_stride, v,   \
                             aux, out, x, p0, p1, p2, st, lanes, n_lanes,   \
                             nz, nr, nparts, tail)
  const cudaError_t e = Kv != nullptr
                            ? (npts == 9 ? HF_APPLY(true, 9)
                                         : HF_APPLY(true, 7))
                            : (npts == 9 ? HF_APPLY(false, 9)
                                         : HF_APPLY(false, 7));
#undef HF_APPLY
  const int kv = Kv != nullptr;
  counts[MODE == kApStencil ? (kv ? kPhStencilDot : kPhStencilDotNoKv)
         : MODE == kApInit  ? (kv ? kPhInit : kPhInitNoKv)
                            : (kv ? kPhMergedW : kPhMergedWNoKv)] += 1;
  return e;
}

cudaError_t launch_update(float* x, float* r, const float* p, const float* Ap,
                          double* part_rr, const LaneState* st,
                          const int* lanes, int n_lanes, int nz, int nr,
                          int nparts, const Tail& tail, long long* counts,
                          cudaStream_t stream) {
  ks_update<<<dim3(tiles_of(nz, nr), n_lanes), kThreads, 0, stream>>>(
      x, r, p, Ap, part_rr, st, lanes, (size_t)nz * nr, nparts, tail);
  counts[kPhUpdate] += 1;
  return cudaGetLastError();
}

// The r-line row kernel; with `update` the CG update fused before the PCR
// (x, p, Ap, part_rr used; st's alpha read).
cudaError_t launch_pcr_r(bool update, const float* A0, const float* Kv,
                         const float* dks, const float* sm, size_t sm_stride,
                         float* r, float* z, float* x, const float* p,
                         const float* Ap, double* part_rr, double* part_rz,
                         int n_rz, const LaneState* st, const int* lanes,
                         int n_lanes, int nz, int nr, int nparts,
                         const Tail& tail, long long* counts,
                         cudaStream_t stream) {
  const size_t smem = pcr_smem(nr);
  const void* fn = update ? (const void*)ks_pcr_r<true>
                          : (const void*)ks_pcr_r<false>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nz, n_lanes);
  if (update) {
    ks_pcr_r<true><<<grid, kRowThreads, smem, stream>>>(
        A0, Kv, dks, sm, sm_stride, r, z, x, p, Ap, part_rr, part_rz, n_rz,
        st, lanes, nz, nr, nparts, tail);
    counts[kPhPcrRUpdate] += 1;
  } else {
    ks_pcr_r<false><<<grid, kRowThreads, smem, stream>>>(
        A0, Kv, dks, sm, sm_stride, r, z, x, p, Ap, part_rr, part_rz, n_rz,
        st, lanes, nz, nr, nparts, tail);
    counts[kPhPcrR] += 1;
  }
  return cudaGetLastError();
}

cudaError_t launch_pcr_z(const float* A0, const float* Kv, const float* dks,
                         const float* sm, size_t sm_stride, const float* r,
                         float* z, double* part_rz, int n_rz,
                         const LaneState* st, const int* flags,
                         const int* lanes, int n_lanes, int nz, int nr,
                         int nparts, const Tail& tail, long long* counts,
                         cudaStream_t stream) {
  const int path = z_path(nz);
  const dim3 grid(z_tiles_of(nz, nr), n_lanes);
  if (path == 0) {
    ks_pcr_z<<<grid, kZWarps * 32, 0, stream>>>(
        A0, Kv, dks, sm, sm_stride, r, z, part_rz, n_rz, st, flags, lanes,
        nz, nr, nparts, tail);
  } else if (path == 1) {
    const int tw = pcr_z_width(nz);
    const size_t smem = 6 * (size_t)nz * tw * sizeof(float);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          (const void*)ks_pcr_z_tall,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    ks_pcr_z_tall<<<grid, kThreads, smem, stream>>>(
        A0, Kv, dks, sm, sm_stride, r, z, part_rz, n_rz, st, flags, lanes,
        nz, nr, nparts, tw, tail);
  } else {
    return cudaErrorInvalidValue;
  }
  counts[kPhPcrZ] += 1;
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

cudaError_t launch_pq_update(float* p, float* q, const float* u,
                             const float* w, const LaneState* st,
                             const int* lanes, int first, int n_lanes, int nz,
                             int nr, long long* counts, cudaStream_t stream) {
  ks_pq_update<<<dim3(tiles_of(nz, nr), n_lanes), kThreads, 0, stream>>>(
      p, q, u, w, st, lanes, first, (size_t)nz * nr);
  counts[kPhPqUpdate] += 1;
  return cudaGetLastError();
}

// z = M^-1 r with the <r, z> partials: the r-line solve (with the CG update
// x += alpha p, r -= alpha Ap fused in front when `update`), then in the ADI
// and adaptive forms the z-line phase (every lane, or the flagged ones).
// `mode` >= 0: the tail of the phase that writes a lane's last <r, z>
// partials, with <r, r> from the row kernel (update) or the first residual.
cudaError_t precondition(const Sweep& s, int n_lanes, bool update,
                         const float* Ap, int mode) {
  const int nrz = s.n_rz();
  Tail tr = no_tail(), tz = no_tail();
  if (mode >= 0) {
    const int n_rr = update ? s.nz : s.tiles2d();
    if (s.adi != 1) tr = s.tail(mode, n_rr, nrz, s.adi == 2 ? 0 : -1);
    if (s.adi) tz = s.tail(mode, n_rr, nrz, -1);
  }
  cudaError_t e = launch_pcr_r(
      update, s.A0, s.Kv, s.dks, s.sm, s.sm_stride, s.r, s.z, s.x, s.p, Ap,
      update && !s.merged ? s.part(kPartRr) : nullptr, s.part(kPartRz), nrz,
      s.st, s.lanes, n_lanes, s.nz, s.nr, s.nparts, tr, s.counts, s.stream);
  if (e != cudaSuccess || !s.adi) return e;
  return launch_pcr_z(s.A0, s.Kv, s.dks, s.sm, s.sm_stride, s.r, s.z,
                      s.part(kPartRz), nrz, s.st,
                      s.adi == 2 ? s.flags : nullptr, s.lanes, n_lanes, s.nz,
                      s.nr, s.nparts, tz, s.counts, s.stream);
}

// The merged-dot tail of a step: w = A u with gamma, delta and <r, r> and
// the scalars in its tail, then p and q.
cudaError_t merged_tail(const Sweep& s, int first, int n_lanes) {
  const int t2 = s.tiles2d();
  cudaError_t e = launch_apply<kApMerged>(
      s.A0, s.Kv, s.npts, s.dks, s.sm, s.sm_stride, s.z, s.r, s.w, nullptr,
      s.part(kPartPap), s.part(kPartRr), s.part(kPartRz), s.st, s.lanes,
      n_lanes, s.nz, s.nr, s.nparts,
      s.tail(first ? kTailMergedFirst : kTailMerged, t2, t2, -1), s.counts,
      s.stream);
  if (e != cudaSuccess) return e;
  return launch_pq_update(s.p, s.q, s.z, s.w, s.st, s.lanes, first, n_lanes,
                          s.nz, s.nr, s.counts, s.stream);
}

cudaError_t start(const Sweep& s) {
  cudaError_t e = cudaMemsetAsync(s.st, 0, (size_t)s.B * sizeof(LaneState),
                                  s.stream);
  if (e != cudaSuccess) return e;
  if ((e = cudaMemsetAsync(s.tickets, 0, (size_t)s.B * sizeof(unsigned),
                           s.stream)) != cudaSuccess)
    return e;
  const int t2 = s.tiles2d();
  // the identity form's first scalars are the tail of the first residual
  const Tail ti = s.merged || s.rline ? no_tail()
                                      : s.tail(kTailInit, t2, 0, -1);
  if ((e = launch_apply<kApInit>(s.A0, s.Kv, s.npts, s.dks, s.sm,
                                 s.sm_stride, s.x0, s.b, s.r, s.x,
                                 s.part(kPartRr), s.part(kPartBb), nullptr,
                                 nullptr, s.lanes, s.B, s.nz, s.nr, s.nparts,
                                 ti, s.counts, s.stream)) != cudaSuccess)
    return e;
  if (s.rline &&
      (e = precondition(s, s.B, false, nullptr, s.merged ? -1 : kTailInit))
          != cudaSuccess)
    return e;
  if (s.merged) return merged_tail(s, 1, s.B);
  return launch_p_update(s.p, s.z, s.st, s.lanes, 1, s.B, s.nz, s.nr,
                         s.counts, s.stream);
}

cudaError_t iterate(const Sweep& s, int n_lanes) {
  cudaError_t e;
  if (s.merged) {
    // x += alpha p, r -= alpha q; u = M^-1 r; then the merged tail
    e = s.rline ? precondition(s, n_lanes, true, s.q, -1)
                : launch_update(s.x, s.r, s.p, s.q, nullptr, s.st, s.lanes,
                                n_lanes, s.nz, s.nr, s.nparts, no_tail(),
                                s.counts, s.stream);
    if (e != cudaSuccess) return e;
    return merged_tail(s, 0, n_lanes);
  }
  if ((e = launch_apply<kApStencil>(
           s.A0, s.Kv, s.npts, s.dks, s.sm, s.sm_stride, s.p, nullptr, s.Ap,
           nullptr, s.part(kPartPap), nullptr, nullptr, s.st, s.lanes,
           n_lanes, s.nz, s.nr, s.nparts, s.tail(kTailAlpha, 0, 0, -1),
           s.counts, s.stream)) != cudaSuccess)
    return e;
  e = s.rline ? precondition(s, n_lanes, true, s.Ap, kTailBeta)
              : launch_update(s.x, s.r, s.p, s.Ap, s.part(kPartRr), s.st,
                              s.lanes, n_lanes, s.nz, s.nr, s.nparts,
                              s.tail(kTailBeta, s.tiles(), 0, -1), s.counts,
                              s.stream);
  if (e != cudaSuccess) return e;
  return launch_p_update(s.p, s.z, s.st, s.lanes, 0, n_lanes, s.nz, s.nr,
                         s.counts, s.stream);
}

// A tail for the single-phase entry points (off when state is null).
Tail phase_tail(void* state, unsigned* tickets, const double* parts, int B,
                int nparts, int mode, int n_pap, int n_rr, int n_rz,
                const float* rtol, int maxiter, int wrt_r0, int fixed,
                int precond) {
  if (state == nullptr) return no_tail();
  return Tail{(LaneState*)state, tickets, parts, rtol, nullptr, B, nparts,
              mode, n_pap, n_rr, n_rz, n_pap, maxiter, wrt_r0, fixed,
              precond, -1};
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
      float *q, float *w, unsigned *tickets

#define HF_SWEEP_INIT                                                        \
  Sweep s{A0, Kv, dks, sm, b, x0, rtol, x, r, z, p, Ap, parts,               \
          (LaneState *)state, lanes, npts, nz, nr, B, maxiter, wrt_r0,       \
          rline, fixed, nparts, sm_lane ? (size_t)nz * nr : 0, counts,       \
          (cudaStream_t)stream, flags, adi, merged, q, w, tickets}

#define HF_PLANE(k) (parts + (size_t)(k) * B * nparts)

extern "C" {

// Partial sums a lane needs per kind: one per elementwise block, one per
// operator tile (ks_apply), one per grid row (r-line PCR), one per column
// tile (z-line PCR).
int hf_sweep_tiles(int nz, int nr) { return tiles_of(nz, nr); }

int hf_sweep_tiles2d(int nz, int nr) { return tiles2d_of(nz, nr); }

int hf_sweep_z_tiles(int nz, int nr) { return z_tiles_of(nz, nr); }

int hf_sweep_nparts(int nz, int nr) {
  int n = tiles_of(nz, nr);
  if (tiles2d_of(nz, nr) > n) n = tiles2d_of(nz, nr);
  if (nz > n) n = nz;
  const int zt = z_tiles_of(nz, nr);
  return zt > n ? zt : n;
}

// <r, z> partials the tails read in a solve (see n_rz_of).
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
// form. `parts` is four partial-sum planes of B x nparts doubles (pAp, rr,
// rz, bb); a phase writes the planes it owns. `state` holds B LaneState
// records (null: no tail; the scalars a phase reads: alpha for the updates,
// beta for p_update) and `tickets` B zero words; with a state, the phase
// runs its tail on the lanes it works on (the tails of a solve: init the
// identity form's first step, stencil_dot alpha, update and
// pcr_r_update beta, merged_w the merged recurrence's step).
int hf_sweep_init(const float *A0, const float *Kv, int npts,
                  const float *dks, const float *sm, int sm_lane,
                  const float *b, const float *x0, float *x, float *r,
                  double *parts, const int *lanes, int n_lanes, int B, int nz,
                  int nr, int nparts, void *state, unsigned *tickets,
                  const float *rtol, int maxiter, int wrt_r0, int fixed,
                  long long *counts, void *stream) {
  const int t2 = tiles2d_of(nz, nr);
  return (int)launch_apply<kApInit>(
      A0, Kv, npts, dks, sm, sm_lane ? (size_t)nz * nr : 0, x0, b, r, x,
      HF_PLANE(kPartRr), HF_PLANE(kPartBb), nullptr, nullptr, lanes, n_lanes,
      nz, nr, nparts,
      phase_tail(state, tickets, parts, B, nparts, kTailInit, t2, t2, 0, rtol,
                 maxiter, wrt_r0, fixed, 0),
      counts, (cudaStream_t)stream);
}

int hf_sweep_stencil_dot(const float *A0, const float *Kv, int npts,
                         const float *dks, const float *sm, int sm_lane,
                         const float *p, float *Ap, double *parts,
                         const int *lanes, int n_lanes, int B, int nz, int nr,
                         int nparts, void *state, unsigned *tickets,
                         long long *counts, void *stream) {
  return (int)launch_apply<kApStencil>(
      A0, Kv, npts, dks, sm, sm_lane ? (size_t)nz * nr : 0, p, nullptr, Ap,
      nullptr, HF_PLANE(kPartPap), nullptr, nullptr,
      (const LaneState *)state, lanes, n_lanes, nz, nr, nparts,
      phase_tail(state, tickets, parts, B, nparts, kTailAlpha,
                 tiles2d_of(nz, nr), 0, 0, nullptr, 0, 0, 0, 0),
      counts, (cudaStream_t)stream);
}

// tail = 1: the identity form's beta tail on <r, r>.
int hf_sweep_update(float *x, float *r, const float *p, const float *Ap,
                    double *parts, void *state, unsigned *tickets, int tail,
                    const int *lanes, int n_lanes, int B, int nz, int nr,
                    int nparts, int maxiter, int fixed, long long *counts,
                    void *stream) {
  return (int)launch_update(
      x, r, p, Ap, HF_PLANE(kPartRr), (const LaneState *)state, lanes,
      n_lanes, nz, nr, nparts,
      phase_tail(tail ? state : nullptr, tickets, parts, B, nparts,
                 kTailBeta, 0, tiles_of(nz, nr), 0, nullptr, maxiter, 0,
                 fixed, 0),
      counts, (cudaStream_t)stream);
}

// The r-line PCR alone (the start's row kernel, ks_pcr_r<false>): <r, z>
// partials, one a grid row. With a state, the lanes it marks done are
// skipped and the others get the r-line form's first scalars (the init
// tail) from <r, z> and one <r, r> and one <b, b> partial a lane, which
// the caller puts in the first slot of those planes.
int hf_sweep_pcr_r(const float *A0, const float *Kv, const float *dks,
                   const float *sm, int sm_lane, float *r, float *z,
                   double *parts, const int *lanes, int n_lanes, int B,
                   int nz, int nr, int nparts, void *state,
                   unsigned *tickets, const float *rtol, int maxiter,
                   int wrt_r0, int fixed, long long *counts, void *stream) {
  return (int)launch_pcr_r(
      false, A0, Kv, dks, sm, sm_lane ? (size_t)nz * nr : 0, r, z, nullptr,
      nullptr, nullptr, nullptr, HF_PLANE(kPartRz), nz,
      (const LaneState *)state, lanes, n_lanes, nz, nr, nparts,
      phase_tail(state, tickets, parts, B, nparts, kTailInit, 1, 1, nz, rtol,
                 maxiter, wrt_r0, fixed, 1),
      counts, (cudaStream_t)stream);
}

// The fused update and r-line PCR (ks_pcr_r<true>): x += alpha p,
// r -= alpha Ap, z = R r, partials of <r, r> and <r, z> a grid row; with
// adi the z-line phase after it (z = R r + Z r - r, <r, z> a column
// tile). tail = 1: the beta tail, in the kernel that writes <r, z> last.
int hf_sweep_pcr_r_update(const float *A0, const float *Kv, const float *dks,
                          const float *sm, int sm_lane, float *x, float *r,
                          const float *p, const float *Ap, float *z,
                          double *parts, void *state, unsigned *tickets,
                          int tail, int adi, const int *lanes, int n_lanes,
                          int B, int nz, int nr, int nparts, int maxiter,
                          int fixed, long long *counts, void *stream) {
  const size_t stride = sm_lane ? (size_t)nz * nr : 0;
  const int nrz = n_rz_of(nz, nr, 1, adi);
  const Tail t = phase_tail(tail ? state : nullptr, tickets, parts, B,
                            nparts, kTailBeta, 0, nz, nrz, nullptr, maxiter,
                            0, fixed, 1);
  cudaError_t e = launch_pcr_r(
      true, A0, Kv, dks, sm, stride, r, z, x, p, Ap, HF_PLANE(kPartRr),
      HF_PLANE(kPartRz), nrz, (const LaneState *)state, lanes, n_lanes, nz,
      nr, nparts, adi ? no_tail() : t, counts, (cudaStream_t)stream);
  if (e != cudaSuccess || !adi) return (int)e;
  return (int)launch_pcr_z(A0, Kv, dks, sm, stride, r, z, HF_PLANE(kPartRz),
                           nrz, (const LaneState *)state, nullptr, lanes,
                           n_lanes, nz, nr, nparts, t, counts,
                           (cudaStream_t)stream);
}

// The z-line phase alone: z holds R r on entry and z = R r + Z r - r on
// exit; one <r, z> partial a column tile (hf_sweep_z_tiles of them).
int hf_sweep_pcr_z(const float *A0, const float *Kv, const float *dks,
                   const float *sm, int sm_lane, const float *r, float *z,
                   double *parts, const int *lanes, int n_lanes, int B,
                   int nz, int nr, int nparts, long long *counts,
                   void *stream) {
  return (int)launch_pcr_z(A0, Kv, dks, sm, sm_lane ? (size_t)nz * nr : 0, r,
                           z, HF_PLANE(kPartRz), z_tiles_of(nz, nr), nullptr,
                           nullptr, lanes, n_lanes, nz, nr, nparts,
                           no_tail(), counts, (cudaStream_t)stream);
}

int hf_sweep_p_update(float *p, const float *z, const void *state,
                      const int *lanes, int first, int n_lanes, int nz,
                      int nr, long long *counts, void *stream) {
  return (int)launch_p_update(p, z, (const LaneState *)state, lanes, first,
                              n_lanes, nz, nr, counts, (cudaStream_t)stream);
}

// The merged-dot pass alone: w = sm A_b (sm u) with the partials of delta,
// <r, r> and gamma (planes pAp, rr, rz); with a state, the merged
// recurrence's tail (a later step).
int hf_sweep_merged_w(const float *A0, const float *Kv, int npts,
                      const float *dks, const float *sm, int sm_lane,
                      const float *u, const float *r, float *w, double *parts,
                      const int *lanes, int n_lanes, int B, int nz, int nr,
                      int nparts, void *state, unsigned *tickets,
                      int preconditioned, int maxiter, long long *counts,
                      void *stream) {
  const int t2 = tiles2d_of(nz, nr);
  return (int)launch_apply<kApMerged>(
      A0, Kv, npts, dks, sm, sm_lane ? (size_t)nz * nr : 0, u, r, w, nullptr,
      HF_PLANE(kPartPap), HF_PLANE(kPartRr), HF_PLANE(kPartRz),
      (const LaneState *)state, lanes, n_lanes, nz, nr, nparts,
      phase_tail(state, tickets, parts, B, nparts, kTailMerged, t2, t2, t2,
                 nullptr, maxiter, 0, 0, preconditioned),
      counts, (cudaStream_t)stream);
}

// p = u + beta p, q = w + beta q in place, beta from each lane's state.
int hf_sweep_pq_update(float *p, float *q, const float *u, const float *w,
                       const void *state, const int *lanes, int n_lanes,
                       int nz, int nr, long long *counts, void *stream) {
  return (int)launch_pq_update(p, q, u, w, (const LaneState *)state, lanes, 0,
                               n_lanes, nz, nr, counts, (cudaStream_t)stream);
}

}  // extern "C"
