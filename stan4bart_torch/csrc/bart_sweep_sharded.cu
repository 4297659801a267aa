// Observation-sharded chain-batched BART Gibbs sweep for Hopper (sm_90a):
// one rank's part of a sweep whose observations are split over the ranks
// of a data group, with one all-reduce per tree update between launches.
//
// Counterpart of the JAX package's XLA path
// stan4bart_tpu/ops/bart.py:bart_sweep(axis_name=) (_tree_move's one psum
// per tree update), which no Pallas kernel implements: one kernel launch
// cannot host a collective across cards.  So the sweep is a host loop over
// the T trees (ops/bart_sweep_kernel.py:sweep_sharded_cuda), each tree
//
//   1. a stats launch (sharded_stats_kernel): one cluster of K blocks per
//      chain over the rank's observations, block rank r owning one range
//      (sweep_cluster.cuh).  Pass A takes the last tree's new fit off the
//      residual (writing that fit out) and forms this tree's partial
//      residual, keeping the largest |w r| and w; pass B sums, per node of
//      the CURRENT partition, the weight and the weighted residual, and
//      the same pair over the observations that would go to the proposed
//      left child.  The block's (2, M + 1) sums go to device memory;
//   2. an all-reduce of the (C, 2, M + 1) block over the data group (the
//      caller's ``reduce`` hook, outside the kernels);
//   3. an apply launch (sharded_apply_kernel): per chain, the
//      Metropolis-Hastings decision from the reduced block with decide's
//      arithmetic (mh_decide), the conjugate leaf draws with draw_leaves's
//      formulas from the accepted partition's per-node sums (the current
//      ones with eta and its children set from the move's totals), the
//      tree rows written, and the rank's leaf indices rewritten.
//
// and a last stats launch (the flush) applies the last tree's fit and
// writes the final residual.  The residual lives in device memory (the
// resid output buffer) between launches.
//
// The in-cluster reductions of the one-launch kernels stay inside the
// stats launch: the maxima meet in distributed shared memory
// (chain_stats), and the blocks' fixed-point histograms are added in rank
// order there (gather_hist, leaf_sums).  The cross-rank reduction is a
// kernel boundary.  The fixed-point scales are the rank's own, so the
// integers never leave the rank: each rank turns its exact sums into
// float32 once, and the ranks' floats are summed by the all-reduce.  A
// sharded sweep therefore equals the unsharded one up to rounding, which
// is the JAX package's own contract for its sharded sweep; on one rank it
// gives the forests of bart_sweep_tiled.cu but where a sum's rounding
// flips a decision.  Weight-0 pad rows (parallel/mesh.py) take the
// weighted path and add nothing to any sum.
//
// What bounds it: bytes.  Per observation and tree pass A moves 20 B
// (residual in and out, the previous leaf index, the old fit in and the
// previous fit out), pass B 12 B (leaf index, residual, cut rank) and the
// apply pass 12 B (leaf index and cut rank in, new leaf index out), 44 B
// against the 16 B that must move; and per tree two launches and a
// collective, which at small n per rank bound it instead.

#include "sweep_cluster.cuh"

namespace {

using namespace s4b;

// Stats launch of tree t (or, at t == T, the flush).  blk (C, 2, M + 1):
// row 0 the per-node weight sums and, last, the proposed-left weight sum;
// row 1 the same of the weighted residual.
__global__ void __launch_bounds__(kThreads)
sharded_stats_kernel(SweepArgs a, int K, int t, float* blk) {
  __shared__ TreeShared s;

  const int N = a.N, T = a.T, M = a.M;
  const int tid = threadIdx.x;
  const int rank = block_rank(K);
  const int c = blockIdx.x / K;
  int start, n;
  obs_range(N, K, rank, start, n);
  const bool flush = t == T;
  const size_t ct = (size_t)c * T + t;
  const float* __restrict__ R0 = a.resid0 + (size_t)c * N + start;
  float* __restrict__ R = a.resid_out + (size_t)c * N + start;
  const float* __restrict__ wts = a.weights ? a.weights + start : nullptr;

  // the last tree's leaf values, drawn by its apply launch
  if (t > 0)
    for (int m = tid; m < M; m += kThreads)
      s.lv[m] = a.lv_out[(ct - 1) * M + m];
  Move mv{};
  if (!flush) {
    mv = begin_tree(a, s, global_rows(a, ct));   // ends on a barrier
  } else {
    __syncthreads();
  }
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

  // pass A: apply tree t-1's fit, roll the residual, the maxima
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = tid; i < n; i += kThreads) {
    float r = t == 0 ? R0[i] : R[i];
    if (t > 0) {
      const float nf = s.lv[li_prev[i]];
      tf_prev[i] = nf;
      r = r - nf;
    }
    if (!flush) {
      r = r + tf_in[i];
      const float w = wts ? wts[i] : 1.0f;
      const float wr = wts ? w * r : r;
      acc[6] = fmaxf(acc[6], fabsf(wr));
      acc[7] = fmaxf(acc[7], w);
    }
    R[i] = r;
  }
  // the flush touches no shared memory of another block
  if (flush) return;
  // the fixed-point scales from the chain's maxima over this rank
  chain_stats(s, acc, N, K);

  // pass B: the current partition's per-node sums and, in slot M, the
  // proposed-left pair; each thread reads back what it wrote in pass A
  for (int base = 0; base < n; base += kTile) {
    bool in[kPer], in_l[kPer];
    int li[kPer], li_l[kPer];
    float w[kPer], wr[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + k * kThreads + tid;
      in[k] = i < n;
      in_l[k] = false;
      li[k] = -1;
      w[k] = 0.0f;
      wr[k] = 0.0f;
      if (in[k]) {
        li[k] = li_in[i];
        const bool gl = rank_row[i] <= mv.cn;
        const bool mem = mv.grow ? (li[k] == mv.eta)
                                 : (li[k] == mv.lft || li[k] == mv.rgt);
        in_l[k] = mem && gl;
        const float r = R[i];
        w[k] = wts ? wts[i] : 1.0f;
        wr[k] = wts ? w[k] * r : r;
      }
      li_l[k] = in_l[k] ? M : -1;
    }
    hist_add<kPer>(s, in, li, w, wr, wts != nullptr);
    hist_add<kPer>(s, in_l, li_l, w, wr, wts != nullptr);
  }
  __syncthreads();
  gather_hist(s, M + 1, K);
  if (rank == 0) {
    float* out = blk + (size_t)c * 2 * (M + 1);
    for (int m = tid; m <= M; m += kThreads) {
      float cnt, sm;
      leaf_sums(s, m, K, cnt, sm);
      out[m] = cnt;
      out[M + 1 + m] = sm;
    }
  }
  // no block leaves while another may still read its shared memory
  if (K > 1) cluster_sync();
}

// Apply launch of tree t over nb blocks per chain: the decision and the
// leaf draw from the reduced block (every block makes the same decision;
// block 0 writes the tree's rows), and the new leaf indices of the block's
// observations.
__global__ void __launch_bounds__(kThreads)
sharded_apply_kernel(SweepArgs a, int nb, int t, const float* blk) {
  __shared__ TreeShared s;

  const int N = a.N, T = a.T, M = a.M;
  const int c = blockIdx.x / nb, b = blockIdx.x - c * nb;
  const size_t ct = (size_t)c * T + t;
  const TreeRows rows = global_rows(a, ct);
  const Move mv = begin_tree(a, s, rows);
  const float* cnt = blk + (size_t)c * 2 * (M + 1);
  const float* sm = cnt + (M + 1);
  const float s2 = a.sigma2[c], t2 = a.tau2[c];
  const bool prune = mv.move == 1;
  if (threadIdx.x == 0) {
    float st[6];
    st[0] = mv.grow ? cnt[mv.eta] : cnt[mv.lft] + cnt[mv.rgt];
    st[1] = mv.grow ? sm[mv.eta] : sm[mv.lft] + sm[mv.rgt];
    st[2] = cnt[M];
    st[3] = sm[M];
    st[4] = cnt[mv.lft];
    st[5] = sm[mv.lft];
    mh_decide(a, s, mv, st, rows, s2, t2);
    // the accepted partition's sums at eta, lft and rgt
    s.tot[0] = prune ? st[0] : 0.0f;
    s.tot[1] = prune ? st[1] : 0.0f;
    s.tot[2] = prune ? 0.0f : st[2];
    s.tot[3] = prune ? 0.0f : st[3];
    s.tot[4] = prune ? 0.0f : st[0] - st[2];
    s.tot[5] = prune ? 0.0f : st[1] - st[3];
  }
  __syncthreads();
  const bool accept = s.sc[4] != 0;

  if (b == 0) {
    for (int m = threadIdx.x; m < M; m += kThreads) {
      float n_m = cnt[m], s_m = sm[m];
      if (accept) {
        if (m == mv.eta) {
          n_m = s.tot[0];
          s_m = s.tot[1];
        } else if (m == mv.lft) {
          n_m = s.tot[2];
          s_m = s.tot[3];
        } else if (m == mv.rgt) {
          n_m = s.tot[4];
          s_m = s.tot[5];
        }
      }
      const float pv = 1.0f / (n_m / s2 + 1.0f / t2);
      const float pm = pv * s_m / s2;
      const float mu = pm + sqrtf(pv) * rows.zn[m];
      a.lv_out[ct * M + m] = s.feat[m] == kLeaf ? mu : 0.0f;
      a.feature_out[ct * M + m] = s.feat[m];
      a.cut_out[ct * M + m] = s.cut[m];
    }
  }

  int start, n;
  obs_range(N, nb, b, start, n);
  const int32_t* __restrict__ li_in = a.lidx_in + ct * N + start;
  const int32_t* __restrict__ rank_row = mv.rank_row + start;
  int32_t* __restrict__ li_out = a.lidx_out + ct * N + start;
  for (int i = threadIdx.x; i < n; i += kThreads)
    li_out[i] = moved_leaf(mv, accept, li_in[i], rank_row[i] <= mv.cn);
}

SweepArgs make_args(
    const int32_t* feature_in, const int32_t* cut_in, const int32_t* lidx_in,
    const float* tfit_in, const float* resid0, const float* sigma2,
    const float* tau2, const float* u, const float* zn,
    const int32_t* ranks_t, const float* spcum, const float* psplit,
    const float* weights, int32_t* feature_out, int32_t* cut_out,
    float* lv_out, int32_t* lidx_out, float* tfit_out, float* resid_out,
    int T, int N, int P, int M, int max_depth, int n_cuts, float p_grow,
    float p_prune, float trans_grow0, float trans_prune0) {
  return SweepArgs{feature_in, cut_in, lidx_in, tfit_in, resid0, sigma2,
                   tau2, u, zn, ranks_t, spcum, psplit, weights, feature_out,
                   cut_out, lv_out, lidx_out, tfit_out, resid_out, T, N, P,
                   M, max_depth, n_cuts, p_grow, p_prune, trans_grow0,
                   trans_prune0};
}

}  // namespace

// The stats kernel's shared memory per block (static; no dynamic), the
// device's opt-in limit per block and the number of clusters of K blocks
// that can be resident at once; returns the CUDA error code.
extern "C" int bart_sweep_sharded_info(int N, int T, int K,
                                       long long* static_b,
                                       long long* dynamic_b, int* optin,
                                       int* clusters) {
  (void)N;
  (void)T;
  *dynamic_b = 0;
  return cluster_info(sharded_stats_kernel, K, 0, static_b, optin, clusters);
}

// Launches the stats pass of tree t (t == T: the flush) over C chains in
// clusters of K blocks on ``stream``, writing blk (C, 2, M + 1); returns the
// CUDA error code of the launch (0 on success).
extern "C" int bart_sweep_sharded_stats(
    const int32_t* feature_in, const int32_t* cut_in, const int32_t* lidx_in,
    const float* tfit_in, const float* resid0, const float* sigma2,
    const float* tau2, const float* u, const float* zn,
    const int32_t* ranks_t, const float* spcum, const float* psplit,
    const float* weights, int32_t* feature_out, int32_t* cut_out,
    float* lv_out, int32_t* lidx_out, float* tfit_out, float* resid_out,
    int C, int T, int N, int P, int M, int max_depth, int n_cuts,
    float p_grow, float p_prune, float trans_grow0, float trans_prune0,
    int t, float* blk, int K, void* stream) {
  const SweepArgs a = make_args(
      feature_in, cut_in, lidx_in, tfit_in, resid0, sigma2, tau2, u, zn,
      ranks_t, spcum, psplit, weights, feature_out, cut_out, lv_out,
      lidx_out, tfit_out, resid_out, T, N, P, M, max_depth, n_cuts, p_grow,
      p_prune, trans_grow0, trans_prune0);
  if (t < 0 || t > T) return (int)cudaErrorInvalidValue;
  return launch_clusters(sharded_stats_kernel, a, C, K, 0, stream, t, blk);
}

// Launches the apply pass of tree t over C chains, nb blocks each, on
// ``stream``, reading the reduced blk; returns the CUDA error code.
extern "C" int bart_sweep_sharded_apply(
    const int32_t* feature_in, const int32_t* cut_in, const int32_t* lidx_in,
    const float* tfit_in, const float* resid0, const float* sigma2,
    const float* tau2, const float* u, const float* zn,
    const int32_t* ranks_t, const float* spcum, const float* psplit,
    const float* weights, int32_t* feature_out, int32_t* cut_out,
    float* lv_out, int32_t* lidx_out, float* tfit_out, float* resid_out,
    int C, int T, int N, int P, int M, int max_depth, int n_cuts,
    float p_grow, float p_prune, float trans_grow0, float trans_prune0,
    int t, const float* blk, int nb, void* stream) {
  const SweepArgs a = make_args(
      feature_in, cut_in, lidx_in, tfit_in, resid0, sigma2, tau2, u, zn,
      ranks_t, spcum, psplit, weights, feature_out, cut_out, lv_out,
      lidx_out, tfit_out, resid_out, T, N, P, M, max_depth, n_cuts, p_grow,
      p_prune, trans_grow0, trans_prune0);
  if (t < 0 || t >= T || nb < 1) return (int)cudaErrorInvalidValue;
  sharded_apply_kernel<<<C * nb, kThreads, 0, (cudaStream_t)stream>>>(
      a, nb, t, blk);
  return (int)cudaGetLastError();
}
