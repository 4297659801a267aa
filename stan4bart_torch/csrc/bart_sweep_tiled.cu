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

template <bool kRegrow>
__global__ void __launch_bounds__(kThreads)
bart_sweep_tiled_on_chip_kernel(SweepArgs a, int K) {
  extern __shared__ float4 smem4[];
  on_chip_kernel<kRegrow>(a, K, reinterpret_cast<unsigned char*>(smem4));
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
__device__ __noinline__ Regrow regrow_streamed(RegrowArgs ra, TreeShared& s,
                                               RegrowShared& r, size_t ct,
                                               int start, int n,
                                               int32_t* li_out,
                                               const float* R,
                                               const float* wts, float s2,
                                               float t2, int K) {
  const SweepArgs a = ra.args();
  const int tid = threadIdx.x;
  const float* row = regrow_row(a, ct);
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

template <bool kRegrow>
__global__ void __launch_bounds__(kThreads)
bart_sweep_tiled_stream_kernel(SweepArgs a, int K) {
  __shared__ TreeShared s;
  // the regrow step's state, in the kernel that runs it
  RegrowShared* rs = nullptr;
  if constexpr (kRegrow) {
    __shared__ RegrowShared r;
    rs = &r;
  }

  const int N = a.N, T = a.T;
  const int rank = block_rank(K);
  const int c = blockIdx.x / K;
  int start, n;
  obs_range(N, K, rank, start, n);
  const int tid = threadIdx.x;
  const float s2 = a.sigma2[c], t2 = a.tau2[c];
  const float* __restrict__ R0 = a.resid0 + (size_t)c * N + start;
  float* __restrict__ R = a.resid_out + (size_t)c * N + start;
  const float* __restrict__ wts = a.weights ? a.weights + start : nullptr;

  for (int t = 0; t <= T; ++t) {
    const bool flush = t == T;
    const size_t ct = (size_t)c * T + t;
    const TreeRows rows = global_rows(a, ct);
    const bool regrow = kRegrow && !flush && regrow_gate(a, ct);
    Move mv{};
    if (!flush) mv = begin_tree(a, s, rows);
    // the previous tree's new leaf indices and its fit (t > 0)
    const int32_t* __restrict__ li_prev =
        t > 0 ? a.lidx_out + (ct - 1) * N + start : nullptr;
    float* __restrict__ tf_prev =
        t > 0 ? a.tfit_out + (ct - 1) * N + start : nullptr;
    const int32_t* __restrict__ li_in =
        flush ? nullptr : a.lidx_in + ct * N + start;
    const float* __restrict__ tf_in =
        flush ? nullptr : a.tfit_in + ct * N + start;
    const int32_t* __restrict__ rank_row =
        flush ? nullptr : mv.rank_row + start;

    // pass A: apply tree t-1's fit, roll the residual, move statistics
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int base = 0; base < n; base += kStreamTile) {
      float rv[kStreamPer], tfv[kStreamPer];
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
          float r = rv[k];
          if (t > 0) {
            float nf = s.lv[lpv[k]];
            tf_prev[i] = nf;
            r = r - nf;
          }
          if (!flush) {
            r = r + tfv[k];
            float w = wts ? wts[i] : 1.0f;
            float wr = wts ? w * r : r;
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
      float rv[kStreamPer];
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
      float w[kStreamPer], wr[kStreamPer];
#pragma unroll
      for (int k = 0; k < kStreamPer; ++k) {
        const int i = base + k * kThreads + tid;
        in[k] = i < n;
        li[k] = -1;
        w[k] = 0.0f;
        wr[k] = 0.0f;
        if (in[k]) {
          li[k] = moved_leaf(mv, accept, liv[k], rkv[k] <= mv.cn);
          li_out[i] = li[k];
          w[k] = wts ? wts[i] : 1.0f;
          wr[k] = wts ? w[k] * rv[k] : rv[k];
        }
      }
      hist_add<kStreamPer>(s, in, li, w, wr, wts != nullptr);
    }
    __syncthreads();
    const Regrow rg = regrow ? regrow_streamed(RegrowArgs(a), s, *rs, ct,
                                               start, n, li_out, R, wts, s2,
                                               t2, K)
                             : Regrow::kNone;
    draw_leaves(a, s, ct, rows, s2, t2, K, rank == 0, rg, rs);
  }
  // no block leaves while another may still read its shared memory
  if (K > 1) cluster_sync();
}

// The kernel that runs at N, T and K, with the regrow step or without
// (on chip where its shared memory fits the device's opt-in limit per
// block) and its dynamic shared memory.
int pick(int N, int T, int K, bool regrow, bool* on_chip, size_t* dyn) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(
      &attr, regrow ? bart_sweep_tiled_on_chip_kernel<true>
                    : bart_sweep_tiled_on_chip_kernel<false>);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, optin = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  *dyn = on_chip_bytes(N, T, K);
  *on_chip = attr.sharedSizeBytes + *dyn <= (size_t)optin;
  if (!*on_chip) *dyn = 0;
  return 0;
}

}  // namespace

// The kernel that runs at N, T and K with the regrow step or without.
template <bool kRegrow>
int info(int N, int T, int K, long long* static_b, long long* dynamic_b,
         int* optin, int* clusters, int* resid_on_chip) {
  bool on_chip = false;
  size_t dyn = 0;
  int e = pick(N, T, K, kRegrow, &on_chip, &dyn);
  if (e != 0) return e;
  *dynamic_b = (long long)dyn;
  *resid_on_chip = on_chip ? 1 : 0;
  return on_chip ? cluster_info(bart_sweep_tiled_on_chip_kernel<kRegrow>, K,
                                dyn, static_b, optin, clusters)
                 : cluster_info(bart_sweep_tiled_stream_kernel<kRegrow>, K,
                                dyn, static_b, optin, clusters);
}

template <bool kRegrow>
int launch(const SweepArgs& a, int C, int K, void* stream) {
  bool on_chip = false;
  size_t dyn = 0;
  int e = pick(a.N, a.T, K, kRegrow, &on_chip, &dyn);
  if (e != 0) return e;
  return on_chip ? launch_clusters(bart_sweep_tiled_on_chip_kernel<kRegrow>,
                                   a, C, K, dyn, stream)
                 : launch_clusters(bart_sweep_tiled_stream_kernel<kRegrow>,
                                   a, C, K, dyn, stream);
}

// Writes the shared memory per block (static, dynamic) of the kernel that
// runs at N, T and K (with the regrow step when ``regrow``), the device's
// opt-in limit per block, the number of clusters of K blocks that can be
// resident at once, and whether the residual stays on chip; returns the
// CUDA error code.
extern "C" int bart_sweep_tiled_info(int N, int T, int K, int regrow,
                                     long long* static_b,
                                     long long* dynamic_b, int* optin,
                                     int* clusters, int* resid_on_chip) {
  return regrow ? info<true>(N, T, K, static_b, dynamic_b, optin, clusters,
                             resid_on_chip)
                : info<false>(N, T, K, static_b, dynamic_b, optin, clusters,
                              resid_on_chip);
}

// Launches one sweep over C chains in clusters of K blocks on ``stream``;
// returns the CUDA error code of the launch (0 on success).  resid_out
// holds the final residual when the kernel ends (and, where the residual
// does not fit on chip, serves as the running residual throughout).
extern "C" int bart_sweep_tiled_launch(
    const int32_t* feature_in, const int32_t* cut_in, const int32_t* lidx_in,
    const float* tfit_in, const float* resid0, const float* sigma2,
    const float* tau2, const float* u, const float* zn,
    const int32_t* ranks_t, const float* spcum, const float* psplit,
    const float* weights, int32_t* feature_out, int32_t* cut_out,
    float* lv_out, int32_t* lidx_out, float* tfit_out, float* resid_out,
    int C, int T, int N, int P, int M, int max_depth, int n_cuts,
    float p_grow, float p_prune, float trans_grow0, float trans_prune0,
    float p_regrow, const float* rg, int K, void* stream) {
  SweepArgs a{feature_in, cut_in, lidx_in, tfit_in, resid0, sigma2, tau2,
              u, zn, ranks_t, spcum, psplit, weights, feature_out, cut_out,
              lv_out, lidx_out, tfit_out, resid_out, T, N, P, M, max_depth,
              n_cuts, p_grow, p_prune, trans_grow0, trans_prune0};
  a.p_regrow = p_regrow;
  a.rg = rg;
  return with_regrow(a) ? launch<true>(a, C, K, stream)
                        : launch<false>(a, C, K, stream);
}
