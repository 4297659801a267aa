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
//      left child and over those that would go to the right one.  The
//      block's (2, M + 2) sums go to device memory;
//   2. an all-reduce of the (C, 2, M + 2) block over the data group (the
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
// The in-sweep subtree regrow (p_regrow) adds, per tree whose regrow
// gate opens in some chain (the host knows which from the variates):
//
//   4. a regrow stats launch (sharded_regrow_stats_kernel): per chain
//      whose gate opens, the proposal (regrow_propose) on the post-move
//      tree, and a pass that walks the rank's observations under eta down
//      the proposed subtree, summing the proposed partition's per-node
//      sums into a (C, 2, M + 1) block at the tree's fixed-point scales;
//   5. the caller's all-reduce of that block;
//   6. a regrow apply launch (sharded_regrow_apply_kernel): the decision
//      (regrow_mh) from the post-move partition's reduced sums, which the
//      apply launch kept with the post-move rows in a scratch block, and
//      the proposal's; if accepted, the rows and leaf values rewritten
//      and the leaf indices of the observations under eta.
//
// The old partition's sums need no second reduction: they are the
// accepted move's, reduced already.
//
// The in-cluster reductions of the one-launch kernels stay inside the
// stats launch: the maxima meet in distributed shared memory
// (chain_stats), and the blocks' fixed-point histograms are added in rank
// order there (gather_hist, leaf_sums).  The cross-rank reduction is a
// kernel boundary.  The fixed-point scales are the rank's own, so the
// integers never leave the rank: each rank turns its exact sums into the
// build's real type (float, or double in the S4B_F64 build) once, and the
// ranks' values are summed by the all-reduce, whose blocks are in that
// type.  A
// sharded sweep therefore equals the unsharded one up to rounding, which
// is the JAX package's own contract for its sharded sweep; on one rank it
// gives the forests of bart_sweep_tiled.cu but where a sum's rounding
// flips a decision.  Weight-0 pad rows (parallel/mesh.py) take the
// weighted path and add nothing to any sum.
//
// Every kernel is built for heaps of 128 slots (max_depth <= 6), 512
// (max_depth 7 and 8) and 1024 (max_depth 9); at 512 the blocks are (C,
// 2, 513) and (C, 2, 512), and the static shared memory 22 976 B (stats)
// and 35 520 B (the regrow launches); at 1024 the per-tree state is
// dynamic shared memory (45 552 B, 70 656 B with the regrow step).
// Deeper trees run one heap build (kPadSharded, any pad), whose per-tree
// state is a slab of device memory per block of each launch (heap_bytes
// with the regrow step's: C * max(K, nb) blocks); the blocks stay (C, 2,
// M + 2) and (C, 2, M + 1).
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

// Stats launch of tree t (or, at t == T, the flush).  blk (C, 2, M + 2):
// row 0 the per-node weight sums and, last, the proposed-left and
// proposed-right weight sums; row 1 the same of the weighted residual.
// The right pair is summed (into rn), not taken as the move's total less
// the left pair: with weights that difference can leave a rounding
// residue where no observation goes right.
template <typename Real, int kPad>
__global__ void __launch_bounds__(kThreads)
sharded_stats_kernel(SweepArgs<Real> a, int K, int t, Real* blk, int* scl) {
  extern __shared__ float4 smem4[];
  TreeShared<kPad, Real>& s =
      tree_state<kPad, Real>(reinterpret_cast<unsigned char*>(smem4));
  bind_state(a, s, static_cast<RegrowShared<kPad>*>(nullptr), K);
  // the proposed-right pair's fixed-point sums
  __shared__ unsigned long long rn[2];

  const int N = a.N, T = a.T, M = a.M;
  const int tid = threadIdx.x;
  const int rank = block_rank(K);
  const int c = blockIdx.x / K;
  int start, n;
  obs_range(N, K, rank, start, n);
  const bool flush = t == T;
  const size_t ct = (size_t)c * T + t;
  const Real* __restrict__ R0 = a.resid0 + (size_t)c * N + start;
  Real* __restrict__ R = a.resid_out + (size_t)c * N + start;
  const Real* __restrict__ wts = a.weights ? a.weights + start : nullptr;

  if (tid < 2) rn[tid] = 0;
  // the last tree's leaf values, drawn by its apply launch
  if (t > 0)
    for (int m = tid; m < M; m += kThreads)
      s.lv[m] = a.lv_out[(ct - 1) * M + m];
  Move mv{};
  if (!flush) {
    mv = begin_tree(a, s, global_rows<kPad>(a, ct));   // ends on a barrier
  } else {
    __syncthreads();
  }
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

  // pass A: apply tree t-1's fit, roll the residual, the maxima
  Real acc[8] = {Real(0), Real(0), Real(0), Real(0),
                 Real(0), Real(0), Real(0), Real(0)};
  for (int i = tid; i < n; i += kThreads) {
    Real r = t == 0 ? R0[i] : R[i];
    if (t > 0) {
      const Real nf = s.lv[li_prev[i]];
      tf_prev[i] = nf;
      r = r - nf;
    }
    if (!flush) {
      r = r + tf_in[i];
      const Real w = wts ? wts[i] : Real(1);
      const Real wr = wts ? w * r : r;
      acc[6] = fmax(acc[6], fabs(wr));
      acc[7] = fmax(acc[7], w);
    }
    R[i] = r;
  }
  // the flush touches no shared memory of another block
  if (flush) return;
  // the fixed-point scales from the chain's maxima over this rank, kept
  // for the tree's regrow stats launch
  chain_stats(s, acc, N, K);
  if (scl != nullptr && rank == 0 && tid == 0) {
    scl[2 * c] = s.sc[9];
    scl[2 * c + 1] = s.sc[10];
  }

  // pass B: the current partition's per-node sums, in slot M the
  // proposed-left pair and in rn the proposed-right pair (one fixed-point
  // sum per thread, added up once); each thread reads back what it wrote
  // in pass A
  long long rn_w = 0, rn_r = 0;
  for (int base = 0; base < n; base += kTile) {
    bool in[kPer], in_l[kPer];
    int li[kPer], li_l[kPer];
    Real w[kPer], wr[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = base + k * kThreads + tid;
      in[k] = i < n;
      in_l[k] = false;
      li[k] = -1;
      w[k] = Real(0);
      wr[k] = Real(0);
      if (in[k]) {
        li[k] = li_in[i];
        const bool gl = rank_row[i] <= mv.cn;
        const bool mem = mv.grow ? (li[k] == mv.eta)
                                 : (li[k] == mv.lft || li[k] == mv.rgt);
        in_l[k] = mem && gl;
        const Real r = R[i];
        w[k] = wts ? wts[i] : Real(1);
        wr[k] = wts ? w[k] * r : r;
        if (mem && !gl) {
          rn_w += to_fixed(w[k], s.sc[9]);
          rn_r += to_fixed(wr[k], s.sc[10]);
        }
      }
      li_l[k] = in_l[k] ? M : -1;
    }
    hist_add<kPer>(s, in, li, w, wr, wts != nullptr);
    hist_add<kPer>(s, in_l, li_l, w, wr, wts != nullptr);
  }
  rn_w = group_sum(kFull, rn_w);
  rn_r = group_sum(kFull, rn_r);
  if ((tid & 31) == 0) {
    atomicAdd(&rn[0], (unsigned long long)rn_w);
    atomicAdd(&rn[1], (unsigned long long)rn_r);
  }
  __syncthreads();
  // the cluster barrier shows every block's rn too
  gather_hist(s, M + 1, K);
  if (rank == 0) {
    Real* out = blk + (size_t)c * 2 * (M + 2);
    for (int m = tid; m <= M + 1; m += kThreads) {
      Real cnt, sm;
      if (m <= M) {
        leaf_sums(s, m, K, cnt, sm);
      } else {
        unsigned long long c_w = 0, c_r = 0;
        for (int k = 0; k < K; ++k) {
          const unsigned long long* p = K == 1 ? rn : in_rank(rn, k);
          c_w += p[0];
          c_r += p[1];
        }
        cnt = from_fixed<Real>(c_w, s.sc[9]);
        sm = from_fixed<Real>(c_r, s.sc[10]);
      }
      out[m] = cnt;
      out[M + 2 + m] = sm;
    }
  }
  // no block leaves while another may still read its shared memory
  if (K > 1) cluster_sync();
}

// Apply launch of tree t over nb blocks per chain: the decision and the
// leaf draw from the reduced block (every block makes the same decision;
// block 0 writes the tree's rows and, where a regrow follows, the
// post-move partition's sums and rows into post (C, 4, M): weight sums,
// weighted residual sums, feature, cut), and the new leaf indices of the
// block's observations.
template <typename Real, int kPad>
__global__ void __launch_bounds__(kThreads)
sharded_apply_kernel(SweepArgs<Real> a, int nb, int t, const Real* blk,
                     Real* post) {
  extern __shared__ float4 smem4[];
  TreeShared<kPad, Real>& s =
      tree_state<kPad, Real>(reinterpret_cast<unsigned char*>(smem4));
  bind_state(a, s, static_cast<RegrowShared<kPad>*>(nullptr), 1);

  const int N = a.N, T = a.T, M = a.M;
  const int c = blockIdx.x / nb, b = blockIdx.x - c * nb;
  const size_t ct = (size_t)c * T + t;
  const TreeRows<Real> rows = global_rows<kPad>(a, ct);
  const Move mv = begin_tree(a, s, rows);
  const Real* cnt = blk + (size_t)c * 2 * (M + 2);
  const Real* sm = cnt + (M + 2);
  const Real s2 = a.sigma2[c], t2 = a.tau2[c];
  const bool prune = mv.move == 1;
  if (threadIdx.x == 0) {
    Real st[6];
    st[0] = mv.grow ? cnt[mv.eta] : cnt[mv.lft] + cnt[mv.rgt];
    st[1] = mv.grow ? sm[mv.eta] : sm[mv.lft] + sm[mv.rgt];
    st[2] = cnt[M];
    st[3] = sm[M];
    st[4] = cnt[mv.lft];
    st[5] = sm[mv.lft];
    const Real rn[2] = {cnt[M + 1], sm[M + 1]};
    mh_decide(a, s, mv, st, rows, s2, t2, rn);
    // the accepted partition's sums at eta, lft and rgt
    s.tot[0] = prune ? st[0] : Real(0);
    s.tot[1] = prune ? st[1] : Real(0);
    s.tot[2] = prune ? Real(0) : st[2];
    s.tot[3] = prune ? Real(0) : st[3];
    s.tot[4] = prune ? Real(0) : rn[0];
    s.tot[5] = prune ? Real(0) : rn[1];
  }
  __syncthreads();
  const bool accept = s.sc[4] != 0;

  if (b == 0) {
    for (int m = threadIdx.x; m < M; m += kThreads) {
      Real n_m = cnt[m], s_m = sm[m];
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
      const Real pv = Real(1) / (n_m / s2 + Real(1) / t2);
      const Real pm = pv * s_m / s2;
      const Real mu = pm + sqrt(pv) * rows.zn[m];
      a.lv_out[ct * M + m] = s.feat[m] == kLeaf ? mu : Real(0);
      a.feature_out[ct * M + m] = s.feat[m];
      a.cut_out[ct * M + m] = s.cut[m];
      if (post != nullptr) {
        Real* p = post + (size_t)c * 4 * M;
        p[m] = n_m;
        p[M + m] = s_m;
        p[2 * M + m] = (Real)s.feat[m];
        p[3 * M + m] = (Real)s.cut[m];
      }
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

// The post-move rows of chain c's tree from post (C, 4, M) into s.feat
// and s.cut.  Called by every thread; ends on a block barrier.
template <int kPad, typename Real>
__device__ inline void load_post_tree(TreeShared<kPad, Real>& s,
                                      const Real* post, int c, int M) {
  const Real* p = post + (size_t)c * 4 * M;
  for (int m = threadIdx.x; m < pad_of(s); m += kThreads) {
    s.feat[m] = m < M ? (int)p[2 * M + m] : kInactive;
    s.cut[m] = m < M ? (int)p[3 * M + m] : 0;
  }
  __syncthreads();
}

// Regrow stats launch of tree t over C chains in clusters of K blocks:
// for each chain whose gate opens, the proposal on the post-move tree and
// the proposed partition's per-node sums over the rank's observations
// under eta, at the tree's fixed-point scales scl (C, 2), into rblk (C, 2,
// M + 1): row 0 the weight sums, row 1 the weighted residual sums, 0
// outside eta's subtree and in slot M; a chain whose gate stays shut
// writes zeros.
template <typename Real, int kPad>
__global__ void __launch_bounds__(kThreads)
sharded_regrow_stats_kernel(SweepArgs<Real> a, int K, int t, Real* rblk,
                            const int* scl, const Real* post) {
  extern __shared__ float4 smem4[];
  unsigned char* dyn = reinterpret_cast<unsigned char*>(smem4);
  TreeShared<kPad, Real>& s = tree_state<kPad, Real>(dyn);
  RegrowShared<kPad>& r = regrow_state<kPad, Real>(dyn);
  bind_state(a, s, &r, K);

  const int N = a.N, T = a.T, M = a.M;
  const int tid = threadIdx.x;
  const int rank = block_rank(K);
  const int c = blockIdx.x / K;
  const size_t ct = (size_t)c * T + t;
  Real* out = rblk + (size_t)c * 2 * (M + 1);
  if (!regrow_gate(a, ct)) {
    // the whole cluster returns: it is one chain
    if (rank == 0)
      for (int m = tid; m < 2 * (M + 1); m += kThreads) out[m] = Real(0);
    return;
  }
  if (tid == 0) {
    s.sc[9] = scl[2 * c];
    s.sc[10] = scl[2 * c + 1];
  }
  load_post_tree(s, post, c, M);
  const Real* row = regrow_row(a, ct);
  regrow_propose(a, s, r, row);
  int start, n;
  obs_range(N, K, rank, start, n);
  const int32_t* __restrict__ li_t = a.lidx_out + ct * N + start;
  const Real* __restrict__ R = a.resid_out + (size_t)c * N + start;
  regrow_pass(a, s, r, start, n, a.weights ? a.weights + start : nullptr,
              [&](int i) { return li_t[i]; }, [&](int i) { return R[i]; });
  __syncthreads();
  if (K > 1) state_sync<kPad>();
  if (rank == 0) {
    for (int m = tid; m <= M; m += kThreads) {
      Real cnt = Real(0), sm = Real(0);
      if (m < M && bit(r.sub_bits, m)) hist_sums(s, r.hist2, m, K, cnt, sm);
      out[m] = cnt;
      out[M + 1 + m] = sm;
    }
  }
  // no block leaves while another may still read its shared memory
  if (K > 1) cluster_sync();
}

// Regrow apply launch of tree t over nb blocks per chain: for each chain
// whose gate opens, the decision from the post-move partition's sums in
// post and the proposal's in the reduced rblk (every block makes the same
// decision); if accepted, block 0 writes the tree's rows and leaf values
// (the leaves of eta's subtree drawn from the proposal's sums, the others
// from the post-move ones, with the tree's normals) and every block
// rewrites the leaf indices of its observations under eta.
template <typename Real, int kPad>
__global__ void __launch_bounds__(kThreads)
sharded_regrow_apply_kernel(SweepArgs<Real> a, int nb, int t,
                            const Real* rblk, const Real* post) {
  extern __shared__ float4 smem4[];
  unsigned char* dyn = reinterpret_cast<unsigned char*>(smem4);
  TreeShared<kPad, Real>& s = tree_state<kPad, Real>(dyn);
  RegrowShared<kPad>& r = regrow_state<kPad, Real>(dyn);
  bind_state(a, s, &r, 1);

  const int N = a.N, T = a.T, M = a.M;
  const int c = blockIdx.x / nb, b = blockIdx.x - c * nb;
  const size_t ct = (size_t)c * T + t;
  if (!regrow_gate(a, ct)) return;
  load_post_tree(s, post, c, M);
  const Real* row = regrow_row(a, ct);
  regrow_propose(a, s, r, row);
  const Real* oc = post + (size_t)c * 4 * M;
  const Real* os = oc + M;
  const Real* nc = rblk + (size_t)c * 2 * (M + 1);
  const Real* ns = nc + M + 1;
  const Real s2 = a.sigma2[c], t2 = a.tau2[c];
  if (threadIdx.x < 32) {
    regrow_mh(s, r, row, M, s2, t2,
              [&](int m, Real& cnt, Real& sm) {
                cnt = oc[m];
                sm = os[m];
              },
              [&](int m, Real& cnt, Real& sm) {
                cnt = nc[m];
                sm = ns[m];
              });
  }
  __syncthreads();
  if (r.rsc[1] == 0) return;
  const int eta = r.rsc[0];
  int start, n;
  obs_range(N, nb, b, start, n);
  int32_t* __restrict__ li_out = a.lidx_out + ct * N + start;
  for (int i = threadIdx.x; i < n; i += kThreads)
    if (bit(r.sub_bits, li_out[i]))
      li_out[i] = regrow_leaf(a, r, eta, start + i);
  if (b != 0) return;
  regrow_accept(s, r);
  const Real* zn = a.zn + ct * row_pad<kPad>(a);
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const bool sub = bit(r.sub_bits, m);
    const Real n_m = sub ? nc[m] : oc[m], s_m = sub ? ns[m] : os[m];
    const Real pv = Real(1) / (n_m / s2 + Real(1) / t2);
    const Real pm = pv * s_m / s2;
    const Real mu = pm + sqrt(pv) * zn[m];
    a.lv_out[ct * M + m] = s.feat[m] == kLeaf ? mu : Real(0);
    a.feature_out[ct * M + m] = s.feat[m];
    a.cut_out[ct * M + m] = s.cut[m];
  }
}

// The launches of each build (the build's real type, heaps of kPad
// slots, the per-tree state's dynamic shared memory state_bytes, 0 up to
// 512 slots).
using Real = BuildReal;

template <int kPad>
int info(int K, long long* static_b, int* optin, int* clusters) {
  return cluster_info(sharded_stats_kernel<Real, kPad>, K,
                      state_bytes<kPad, Real>(false), static_b, optin,
                      clusters);
}

template <int kPad>
int stats(const SweepArgs<Real>& a, int C, int K, int t, Real* blk,
          int* scl, void* stream) {
  return launch_clusters(sharded_stats_kernel<Real, kPad>, a, C, K,
                         state_bytes<kPad, Real>(false), stream, t, blk,
                         scl);
}

template <int kPad>
int apply(const SweepArgs<Real>& a, int C, int nb, int t, const Real* blk,
          Real* post, void* stream) {
  const size_t dyn = state_bytes<kPad, Real>(false);
  sharded_apply_kernel<Real, kPad>
      <<<C * nb, kThreads, dyn, (cudaStream_t)stream>>>(a, nb, t, blk, post);
  return (int)cudaGetLastError();
}

template <int kPad>
int regrow_stats(const SweepArgs<Real>& a, int C, int K, int t, Real* rblk,
                 const int* scl, const Real* post, void* stream) {
  return launch_clusters(sharded_regrow_stats_kernel<Real, kPad>, a, C, K,
                         state_bytes<kPad, Real>(true), stream, t, rblk, scl,
                         post);
}

template <int kPad>
int regrow_apply(const SweepArgs<Real>& a, int C, int nb, int t,
                 const Real* rblk, const Real* post, void* stream) {
  const size_t dyn = state_bytes<kPad, Real>(true);
  cudaError_t err = cudaFuncSetAttribute(
      sharded_regrow_apply_kernel<Real, kPad>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return refused(err);
  sharded_regrow_apply_kernel<Real, kPad>
      <<<C * nb, kThreads, dyn, (cudaStream_t)stream>>>(a, nb, t, rblk, post);
  return (int)cudaGetLastError();
}

}  // namespace

// The build of the sharded kernels' heap builds: no copy of the leaf
// indices, so one build takes every pad
constexpr int kPadSharded = kPadHeapWide;

// The stats kernel's shared memory per block (static, and dynamic for the
// per-tree state at 1024 slots) in the build for heaps of ``pad`` slots
// (with ``heap`` the heap build, any power of two from 128, else the
// static build for 128, 512 or 1024), the device's opt-in limit per
// block, the number of clusters of K blocks that can be resident at once
// and the heap build's slab bytes per block, with the regrow launches'
// state (0 in a static build); returns the CUDA error code.
extern "C" int S4B_SYM(bart_sweep_sharded_info)(int N, int T, int K,
                                                int pad, int heap,
                                                long long* static_b,
                                                long long* dynamic_b,
                                                int* optin, int* clusters,
                                                long long* heap_b) {
  (void)N;
  (void)T;
  *heap_b = 0;
  if (heap) {
    if (!pad_ok(pad, 0, true)) return (int)cudaErrorInvalidValue;
    *heap_b = (long long)heap_bytes<Real>(pad, true);
    *dynamic_b = 0;
    return info<kPadSharded>(K, static_b, optin, clusters);
  }
  switch (pad) {
    case kPadShallow:
      *dynamic_b = (long long)state_bytes<kPadShallow, Real>(false);
      return info<kPadShallow>(K, static_b, optin, clusters);
    case kPadDeep:
      *dynamic_b = (long long)state_bytes<kPadDeep, Real>(false);
      return info<kPadDeep>(K, static_b, optin, clusters);
    case kPadDeepest:
      *dynamic_b = (long long)state_bytes<kPadDeepest, Real>(false);
      return info<kPadDeepest>(K, static_b, optin, clusters);
  }
  return (int)cudaErrorInvalidValue;
}

// Every launcher takes the operands in the build's real type (SWEEP_HEAD)
// and the build for heaps of ``pad`` slots (at least M + 1: the stats
// launch's histograms keep the proposed-left pair in slot M; zn rows of
// pad normals): with a ``heap`` slab (heap_bytes with the regrow step's
// state, per block: C * max(K, nb) of them) the heap build, any power of
// two from 128, else the static build for 128, 512 or 1024; its blocks
// blk, post and rblk are in the real type.

// Launches the stats pass of tree t (t == T: the flush) over C chains in
// clusters of K blocks on ``stream``, writing blk (C, 2, M + 2) and, when
// scl is not null, the tree's fixed-point scales scl (C, 2); returns the
// CUDA error code of the launch (0 on success).
extern "C" int S4B_SYM(bart_sweep_sharded_stats)(SWEEP_HEAD, int t,
                                                 Real* blk, int* scl, int K,
                                                 void* stream) {
  const SweepArgs<Real> a = SWEEP_ARGS;
  if (t < 0 || t > T || !pad_ok(pad, M, heap != nullptr))
    return (int)cudaErrorInvalidValue;
  if (heap != nullptr)
    return stats<kPadSharded>(a, C, K, t, blk, scl, stream);
  switch (pad) {
    case kPadShallow: return stats<kPadShallow>(a, C, K, t, blk, scl, stream);
    case kPadDeep: return stats<kPadDeep>(a, C, K, t, blk, scl, stream);
    case kPadDeepest: return stats<kPadDeepest>(a, C, K, t, blk, scl, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches the apply pass of tree t over C chains, nb blocks each, on
// ``stream``, reading the reduced blk and, when post is not null, keeping
// the post-move sums and rows in post (C, 4, M) for the tree's regrow;
// returns the CUDA error code.
extern "C" int S4B_SYM(bart_sweep_sharded_apply)(SWEEP_HEAD, int t,
                                                 const Real* blk, Real* post,
                                                 int nb, void* stream) {
  const SweepArgs<Real> a = SWEEP_ARGS;
  if (t < 0 || t >= T || nb < 1 || !pad_ok(pad, M, heap != nullptr))
    return (int)cudaErrorInvalidValue;
  if (heap != nullptr)
    return apply<kPadSharded>(a, C, nb, t, blk, post, stream);
  switch (pad) {
    case kPadShallow:
      return apply<kPadShallow>(a, C, nb, t, blk, post, stream);
    case kPadDeep:
      return apply<kPadDeep>(a, C, nb, t, blk, post, stream);
    case kPadDeepest:
      return apply<kPadDeepest>(a, C, nb, t, blk, post, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches the regrow stats pass of tree t over C chains in clusters of K
// blocks on ``stream``, writing rblk (C, 2, M + 1) from the scales scl and
// the post-move rows in post; returns the CUDA error code.
extern "C" int S4B_SYM(bart_sweep_sharded_regrow_stats)(
    SWEEP_HEAD, int t, Real* rblk, const int* scl, const Real* post, int K,
    void* stream) {
  const SweepArgs<Real> a = SWEEP_ARGS;
  if (t < 0 || t >= T || rg == nullptr || !pad_ok(pad, M, heap != nullptr))
    return (int)cudaErrorInvalidValue;
  if (heap != nullptr)
    return regrow_stats<kPadSharded>(a, C, K, t, rblk, scl, post, stream);
  switch (pad) {
    case kPadShallow:
      return regrow_stats<kPadShallow>(a, C, K, t, rblk, scl, post, stream);
    case kPadDeep:
      return regrow_stats<kPadDeep>(a, C, K, t, rblk, scl, post, stream);
    case kPadDeepest:
      return regrow_stats<kPadDeepest>(a, C, K, t, rblk, scl, post, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches the regrow apply pass of tree t over C chains, nb blocks each,
// on ``stream``, reading the reduced rblk and post; returns the CUDA error
// code.
extern "C" int S4B_SYM(bart_sweep_sharded_regrow_apply)(
    SWEEP_HEAD, int t, const Real* rblk, const Real* post, int nb,
    void* stream) {
  const SweepArgs<Real> a = SWEEP_ARGS;
  if (t < 0 || t >= T || nb < 1 || rg == nullptr
      || !pad_ok(pad, M, heap != nullptr))
    return (int)cudaErrorInvalidValue;
  if (heap != nullptr)
    return regrow_apply<kPadSharded>(a, C, nb, t, rblk, post, stream);
  switch (pad) {
    case kPadShallow:
      return regrow_apply<kPadShallow>(a, C, nb, t, rblk, post, stream);
    case kPadDeep:
      return regrow_apply<kPadDeep>(a, C, nb, t, rblk, post, stream);
    case kPadDeepest:
      return regrow_apply<kPadDeepest>(a, C, nb, t, rblk, post, stream);
  }
  return (int)cudaErrorInvalidValue;
}
