// Obs-tiled chain-batched BART Gibbs sweep for Hopper (sm_90a): the sweep
// at any number of observations.
//
// Replaces the TPU kernel stan4bart_tpu/ops/bart_sweep_kernel.py:
// _sweep_call_tiled (body _make_tiled_kernel).  It computes what
// bart_sweep_batch.cu computes (the same forest, leaf values, leaf
// indices, tree fits and final residual from the same variates; plain
// version ops/bart.py:sweep_trees) at any n.  Each chain is one cluster of
// K thread blocks (sweep_cluster.cuh), block rank r owning one range of
// the observations, and one of two kernels runs:
//
// * where a block's slice of the residual and a byte copy of its leaf
//   indices fit in shared memory (n / K up to about 38 000), the
//   single-pass sweep sweep_on_chip, the same code as
//   bart_sweep_batch.cu's: 16 B of device memory per observation and tree,
//   the operands streamed through a ring of tiles with the next tree's
//   first tiles in flight during the decision;
// * otherwise the residual lives in device memory (the resid output
//   buffer), and per tree the block streams its observations in tiles of
//   kStreamTile twice, each thread issuing all kStreamPer loads of a tile
//   before it uses them:
//
//     pass A  applies the previous tree's new fit (its leaf values kept in
//             shared memory, its leaf indices read back from lidx_out),
//             writes that fit to tfit_out, rolls the residual to this
//             tree's partial residual and sums the six move statistics;
//             the Metropolis-Hastings decision follows;
//     pass B  rewrites the leaf indices and sums the per-node leaf
//             statistics; where the tree's regrow gate opens (p_regrow),
//             a regrow pass reads the new leaf indices back and walks the
//             observations under eta down the proposed subtree (and again,
//             rewriting their leaf indices, if the move is accepted); the
//             leaf draw follows;
//
//   and a flush pass after the last tree applies its fit.  This moves 36 B
//   per observation and tree: pass A reads the previous leaf indices, the
//   residual, the tree fit and the leaf indices and writes the previous
//   fit and the residual; pass B reads the leaf indices and the residual
//   again and writes the new leaf indices.  A regrow adds 4 B per
//   observation and tree, and the residual and the cut ranks of the
//   observations under eta.
//
// Both are built for heaps of 128 slots (max_depth <= 6), 512 (max_depth
// 7 and 8) and 1024 (max_depth 9).  The deep builds' on-chip kernel keeps
// a two-byte leaf index copy and a 4x or 8x larger per-tree state, so its
// slice fits to about 23 500 (512) or 14 600 (1024) observations a block
// (38 000 at 128); the streaming kernel holds TreeShared and
// RegrowShared in 35 520 B of static shared memory at 512 and in 70 656 B
// of dynamic shared memory at 1024.  The float64 build (S4B_F64,
// bart_sweep_tiled_f64) moves 8-byte residuals and tree fits, so its
// slice fits to about half as many observations a block.  Trees of
// max_depth 10 and deeper run the heap builds (bart_sweep_batch.cu says
// how): the on-chip kernel's slice fits to about 32 000 observations a
// block, and one streaming kernel, with no copy of the leaf indices,
// serves every heap size (kStreamPad).
//
// Both take every sum in the order of sweep_common.cuh over the same
// observation ranges and per-thread order (tid + j * kThreads within a
// block's range), so the two kernels, and bart_sweep_batch.cu at the same
// K, give bit-identical results.  What bounds the sweep: bytes (16 B per
// observation and tree must move).  The cluster puts several SMs on a
// chain where few chains would leave most SMs idle; the cut-rank row and
// the weights are shared by every chain and stay in L2.

#include "sweep_cluster.cuh"

namespace {

using namespace s4b;

constexpr int kStreamPer = 8;                    // per thread per tile
constexpr int kStreamTile = kThreads * kStreamPer;

template <typename Real, int kPad, bool kRegrow>
__global__ void __launch_bounds__(kThreads)
bart_sweep_tiled_on_chip_kernel(SweepArgs<Real> a, int K) {
  extern __shared__ float4 smem4[];
  on_chip_kernel<kRegrow, kPad>(a, K,
                                reinterpret_cast<unsigned char*>(smem4));
}

// The regrow step of tree ct of a block of the streaming kernel, whose
// observations [start, start + n) hold their post-move leaves in li_out
// and their partial residuals in R (weights wts, both offset to start):
// the post-move sums gathered, the proposal, a pass that reads the leaf
// indices back (each thread those it wrote) and walks the observations
// under eta down the proposed subtree into r.hist2 (regrow_pass), the
// decision and, if accepted, the rows and those leaf indices rewritten.
// Called by every thread after a block barrier; ends on one.  Not
// inlined, as regrow_on_chip.
template <int kPad, typename Real>
__device__ __noinline__ Regrow regrow_streamed(RegrowArgs<Real> ra,
                                               TreeShared<kPad, Real>& s,
                                               RegrowShared<kPad>& r,
                                               size_t ct,
                                               int start, int n,
                                               int32_t* li_out,
                                               const Real* R,
                                               const Real* wts, Real s2,
                                               Real t2, int K) {
  const SweepArgs<Real> a = ra.args();
  const int tid = threadIdx.x;
  const Real* row = regrow_row(a, ct);
  gather_hist(s, a.M, K);
  regrow_propose(a, s, r, row);
  const int eta = r.rsc[0];
  regrow_pass(a, s, r, start, n, wts, [&](int i) { return li_out[i]; },
              [&](int i) { return R[i]; });
  __syncthreads();
  if (!regrow_decide(a, s, r, row, s2, t2, K)) return Regrow::kRefused;
  for (int i = tid; i < n; i += kThreads)
    if (bit(r.sub_bits, li_out[i]))
      li_out[i] = regrow_leaf(a, r, eta, start + i);
  regrow_accept(s, r);
  return Regrow::kAccepted;
}

template <typename Real, int kPad, bool kRegrow>
__global__ void __launch_bounds__(kThreads)
bart_sweep_tiled_stream_kernel(SweepArgs<Real> a, int K) {
  // the per-tree state (dynamic shared memory at 1024 heap slots, device
  // memory in the heap builds) and the regrow step's, in the kernel that
  // runs it
  extern __shared__ float4 smem4[];
  unsigned char* dyn = reinterpret_cast<unsigned char*>(smem4);
  TreeShared<kPad, Real>& s = tree_state<kPad, Real>(dyn);
  RegrowShared<kPad>* rs = nullptr;
  if constexpr (kRegrow) rs = &regrow_state<kPad, Real>(dyn);
  bind_state(a, s, rs, K);

  const int N = a.N, T = a.T;
  const int rank = block_rank(K);
  const int c = blockIdx.x / K;
  int start, n;
  obs_range(N, K, rank, start, n);
  const int tid = threadIdx.x;
  const Real s2 = a.sigma2[c], t2 = a.tau2[c];
  const Real* __restrict__ R0 = a.resid0 + (size_t)c * N + start;
  Real* __restrict__ R = a.resid_out + (size_t)c * N + start;
  const Real* __restrict__ wts = a.weights ? a.weights + start : nullptr;

  for (int t = 0; t <= T; ++t) {
    const bool flush = t == T;
    const size_t ct = (size_t)c * T + t;
    const TreeRows<Real> rows = global_rows<kPad>(a, ct);
    const bool regrow = kRegrow && !flush && regrow_gate(a, ct);
    Move mv{};
    if (!flush) mv = begin_tree(a, s, rows);
    // the previous tree's new leaf indices and its fit (t > 0)
    const int32_t* __restrict__ li_prev =
        t > 0 ? a.lidx_out + (ct - 1) * N + start : nullptr;
    Real* __restrict__ tf_prev =
        t > 0 ? a.tfit_out + (ct - 1) * N + start : nullptr;
    const int32_t* __restrict__ li_in =
        flush ? nullptr : a.lidx_in + ct * N + start;
    const Real* __restrict__ tf_in =
        flush ? nullptr : a.tfit_in + ct * N + start;
    const int32_t* __restrict__ rank_row =
        flush ? nullptr : mv.rank_row + start;

    // pass A: apply tree t-1's fit, roll the residual, move statistics
    Real acc[8] = {Real(0), Real(0), Real(0), Real(0),
                   Real(0), Real(0), Real(0), Real(0)};
    for (int base = 0; base < n; base += kStreamTile) {
      Real rv[kStreamPer], tfv[kStreamPer];
      int lpv[kStreamPer], liv[kStreamPer], rkv[kStreamPer];
#pragma unroll
      for (int k = 0; k < kStreamPer; ++k) {
        const int i = base + k * kThreads + tid;
        if (i < n) {
          rv[k] = t == 0 ? R0[i] : R[i];
          if (t > 0) lpv[k] = li_prev[i];
          if (!flush) {
            liv[k] = li_in[i];
            tfv[k] = tf_in[i];
            rkv[k] = rank_row[i];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kStreamPer; ++k) {
        const int i = base + k * kThreads + tid;
        if (i < n) {
          Real r = rv[k];
          if (t > 0) {
            Real nf = s.lv[lpv[k]];
            tf_prev[i] = nf;
            r = r - nf;
          }
          if (!flush) {
            r = r + tfv[k];
            Real w = wts ? wts[i] : Real(1);
            Real wr = wts ? w * r : r;
            add_move_stats(acc, mv, liv[k], rkv[k] <= mv.cn, w, wr);
          }
          R[i] = r;
        }
      }
    }
    if (flush) break;
    const bool accept = decide(a, s, mv, acc, rows, s2, t2, K);

    // pass B: new leaf indices and per-node leaf statistics
    int32_t* __restrict__ li_out = a.lidx_out + ct * N + start;
    for (int base = 0; base < n; base += kStreamTile) {
      Real rv[kStreamPer];
      int liv[kStreamPer], rkv[kStreamPer];
#pragma unroll
      for (int k = 0; k < kStreamPer; ++k) {
        const int i = base + k * kThreads + tid;
        if (i < n) {
          rv[k] = R[i];
          liv[k] = li_in[i];
          rkv[k] = rank_row[i];
        }
      }
      bool in[kStreamPer];
      int li[kStreamPer];
      Real w[kStreamPer], wr[kStreamPer];
#pragma unroll
      for (int k = 0; k < kStreamPer; ++k) {
        const int i = base + k * kThreads + tid;
        in[k] = i < n;
        li[k] = -1;
        w[k] = Real(0);
        wr[k] = Real(0);
        if (in[k]) {
          li[k] = moved_leaf(mv, accept, liv[k], rkv[k] <= mv.cn);
          li_out[i] = li[k];
          w[k] = wts ? wts[i] : Real(1);
          wr[k] = wts ? w[k] * rv[k] : rv[k];
        }
      }
      hist_add<kStreamPer>(s, in, li, w, wr, wts != nullptr);
    }
    __syncthreads();
    const Regrow rg = regrow ? regrow_streamed<kPad>(RegrowArgs<Real>(a), s,
                                                     *rs, ct, start, n,
                                                     li_out, R, wts, s2, t2,
                                                     K)
                             : Regrow::kNone;
    draw_leaves(a, s, ct, rows, s2, t2, K, rank == 0, rg, rs);
  }
  // no block leaves while another may still read its shared memory
  if (K > 1) cluster_sync();
}

// The streaming kernel of the build for kPad: the heap builds share one,
// which keeps no copy of the leaf indices to size by the heap.
template <int kPad>
constexpr int kStreamPad = heap_build(kPad) ? kPadHeapWide : kPad;

// The kernel that runs at N, T and K, with the regrow step or without
// (on chip where its shared memory fits the device's opt-in limit per
// block) and its dynamic shared memory, for heaps of kPad slots.
template <typename Real, int kPad>
int pick(int N, int T, int K, bool regrow, bool* on_chip, size_t* dyn) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(
      &attr, regrow ? bart_sweep_tiled_on_chip_kernel<Real, kPad, true>
                    : bart_sweep_tiled_on_chip_kernel<Real, kPad, false>);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  *dyn = on_chip_bytes<kPad, Real>(N, T, K)
      + state_bytes<kPad, Real>(regrow);
  *on_chip = attr.sharedSizeBytes + *dyn <= (size_t)optin;
  if (!*on_chip) *dyn = state_bytes<kPad, Real>(regrow);
  return 0;
}

// The kernel that runs at N, T and K with the regrow step or without,
// for heaps of kPad slots.
template <typename Real, bool kRegrow, int kPad>
int info(int N, int T, int K, long long* static_b, long long* dynamic_b,
         int* optin, int* clusters, int* resid_on_chip) {
  bool on_chip = false;
  size_t dyn = 0;
  int e = pick<Real, kPad>(N, T, K, kRegrow, &on_chip, &dyn);
  if (e != 0) return e;
  *dynamic_b = (long long)dyn;
  *resid_on_chip = on_chip ? 1 : 0;
  return on_chip
      ? cluster_info(bart_sweep_tiled_on_chip_kernel<Real, kPad, kRegrow>, K,
                     dyn, static_b, optin, clusters)
      : cluster_info(
            bart_sweep_tiled_stream_kernel<Real, kStreamPad<kPad>, kRegrow>,
            K, dyn, static_b, optin, clusters);
}

template <typename Real, bool kRegrow, int kPad>
int launch(const SweepArgs<Real>& a, int C, int K, void* stream) {
  bool on_chip = false;
  size_t dyn = 0;
  int e = pick<Real, kPad>(a.N, a.T, K, kRegrow, &on_chip, &dyn);
  if (e != 0) return e;
  return on_chip
      ? launch_clusters(bart_sweep_tiled_on_chip_kernel<Real, kPad, kRegrow>,
                        a, C, K, dyn, stream)
      : launch_clusters(
            bart_sweep_tiled_stream_kernel<Real, kStreamPad<kPad>, kRegrow>,
            a, C, K, dyn, stream);
}

template <typename Real, int kPad>
int info_pad(int N, int T, int K, int regrow, long long* static_b,
             long long* dynamic_b, int* optin, int* clusters,
             int* resid_on_chip) {
  return regrow ? info<Real, true, kPad>(N, T, K, static_b, dynamic_b, optin,
                                         clusters, resid_on_chip)
                : info<Real, false, kPad>(N, T, K, static_b, dynamic_b,
                                          optin, clusters, resid_on_chip);
}

template <typename Real, int kPad>
int launch_pad(const SweepArgs<Real>& a, int C, int K, void* stream) {
  return with_regrow(a) ? launch<Real, true, kPad>(a, C, K, stream)
                        : launch<Real, false, kPad>(a, C, K, stream);
}

}  // namespace

// Writes the shared memory per block (static, dynamic) of the kernel that
// runs at N, T and K (the build's real type, for heaps of ``pad`` slots:
// with ``heap`` the heap build, any power of two from 128, else the static
// build for 128, 512 or 1024; with the regrow step when ``regrow``), the
// device's opt-in limit per block, the number of clusters of K blocks that
// can be resident at once, whether the residual stays on chip and the
// heap build's slab bytes per block (0 in a static build); returns the
// CUDA error code.
extern "C" int S4B_SYM(bart_sweep_tiled_info)(int N, int T, int K, int pad,
                                              int regrow, int heap,
                                              long long* static_b,
                                              long long* dynamic_b,
                                              int* optin, int* clusters,
                                              int* resid_on_chip,
                                              long long* heap_b) {
  *heap_b = 0;
  if (heap) {
    if (!pad_ok(pad, 0, true)) return (int)cudaErrorInvalidValue;
    *heap_b = (long long)heap_bytes<BuildReal>(pad, regrow);
    return pad <= kPadHeap
        ? info_pad<BuildReal, kPadHeap>(N, T, K, regrow, static_b, dynamic_b,
                                        optin, clusters, resid_on_chip)
        : info_pad<BuildReal, kPadHeapWide>(N, T, K, regrow, static_b,
                                            dynamic_b, optin, clusters,
                                            resid_on_chip);
  }
  switch (pad) {
    case kPadShallow:
      return info_pad<BuildReal, kPadShallow>(N, T, K, regrow, static_b,
                                              dynamic_b, optin, clusters,
                                              resid_on_chip);
    case kPadDeep:
      return info_pad<BuildReal, kPadDeep>(N, T, K, regrow, static_b,
                                           dynamic_b, optin, clusters,
                                           resid_on_chip);
    case kPadDeepest:
      return info_pad<BuildReal, kPadDeepest>(N, T, K, regrow, static_b,
                                              dynamic_b, optin, clusters,
                                              resid_on_chip);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches one sweep over C chains in clusters of K blocks on ``stream``
// (the operands in the build's real type), the build for heaps of ``pad``
// slots (at least M + 1; zn rows of pad normals): with a ``heap`` slab
// (heap_bytes with the regrow step when it runs, per block: C * K of
// them) the heap build, any power of two from 128, else the static build
// for 128, 512 or 1024; returns the CUDA error code of the launch (0 on
// success).  resid_out holds the final residual when the kernel ends
// (and, where the residual does not fit on chip, serves as the running
// residual throughout).
extern "C" int S4B_SYM(bart_sweep_tiled_launch)(SWEEP_HEAD, int K,
                                                void* stream) {
  const SweepArgs<BuildReal> a = SWEEP_ARGS;
  if (!pad_ok(pad, M, heap != nullptr)) return (int)cudaErrorInvalidValue;
  if (heap != nullptr)
    return pad <= kPadHeap
        ? launch_pad<BuildReal, kPadHeap>(a, C, K, stream)
        : launch_pad<BuildReal, kPadHeapWide>(a, C, K, stream);
  switch (pad) {
    case kPadShallow:
      return launch_pad<BuildReal, kPadShallow>(a, C, K, stream);
    case kPadDeep:
      return launch_pad<BuildReal, kPadDeep>(a, C, K, stream);
    case kPadDeepest:
      return launch_pad<BuildReal, kPadDeepest>(a, C, K, stream);
  }
  return (int)cudaErrorInvalidValue;
}
