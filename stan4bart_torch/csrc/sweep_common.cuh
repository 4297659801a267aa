// Per-tree arithmetic shared by the port's BART sweep kernels.
//
// The kernels (bart_sweep_batch.cu and bart_sweep_tiled.cu, through the
// cluster layer sweep_cluster.cuh, and bart_sweep_chain.cu) give each
// chain one thread block, or one cluster of K blocks that split its
// observations into K fixed ranges, and run per tree the same steps: load
// the tree's heap rows and pick the move (begin_tree), sum the six move
// statistics over the observations (add_move_stats, then decide's
// fixed-order sum and the Metropolis-Hastings decision), rewrite the leaf
// indices (moved_leaf) while summing the per-node leaf statistics
// (hist_add), optionally try a subtree regrow of the post-move tree
// (regrow_propose, a pass over the observations under its node eta that
// walks them down the proposed subtree into a second histogram, and
// regrow_mh), and draw the leaf values (draw_leaves).  Only the
// observation passes differ between the kernels, so the decision
// arithmetic exists once and the kernels give the same forest on the same
// inputs.
//
// Every sum is deterministic.  The six move statistics are per-thread
// sums over a block's observations tid, tid + kThreads, ..., then a warp
// butterfly, then the warps in order, then (in a cluster) the blocks in
// rank order.  The per-node leaf statistics are sums of integers: each
// observation's weight and weighted residual become 64-bit fixed-point
// numbers, scaled per tree by a power of two from the chain's largest
// magnitude so that no sum can overflow (fix_scale); within a warp, lanes
// holding the same node are grouped with __match_any_sync and their
// values summed by integer warp reductions, and the group's leader adds
// the sum into the block's histogram with a shared-memory atomic.
// Integer addition does not depend on order, so these sums are the same
// in every kernel, at every cluster size and on every run, and they are
// exact but for the rounding of each value to 2^-scale and of the total
// back to float.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s4b {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNodePad = 128;   // heap slots; max_nodes <= 127
constexpr int kLeaf = -1;
constexpr int kInactive = -2;
constexpr unsigned kFull = 0xffffffffu;

struct SweepArgs {
  const int32_t* feature_in;   // (C, T, M)
  const int32_t* cut_in;       // (C, T, M)
  const int32_t* lidx_in;      // (C, T, N)
  const float* tfit_in;        // (C, T, N)
  const float* resid0;         // (C, N) y_target - allfit
  const float* sigma2;         // (C,)
  const float* tau2;           // (C,)
  const float* u;              // (C, T, 8) proposal uniforms
  const float* zn;             // (C, T, 128) leaf normals
  const int32_t* ranks_t;      // (P, N) cut ranks
  const float* spcum;          // (P,) split-probability cumsum
  const float* psplit;         // (max_depth + 2,) p_split by depth
  const float* weights;        // (N,) or nullptr
  int32_t* feature_out;
  int32_t* cut_out;
  float* lv_out;               // (C, T, M)
  int32_t* lidx_out;
  float* tfit_out;
  float* resid_out;            // (C, N)
  int T, N, P, M, max_depth, n_cuts;
  float p_grow, p_prune;
  float trans_grow0;           // log(p_prune) - log(p_grow)
  float trans_prune0;          // log(p_grow) - log(p_prune)
  // the ablation stubs' extra operands (bart_sweep_ablate.cu), else null
  const float* lv_in;          // (C, T, M) leaf values to look up
  float* stats_out;            // (C, T, 2, M) per-node leaf statistics
  // the in-sweep subtree regrow (ops/bart.py:_subtree_regrow): its
  // probability and, per (chain, tree), a row of 3 + 3 M uniforms: gate,
  // node pick, accept, then each node's split, variable and cut; rg is
  // null when p_regrow is 0
  float p_regrow;
  const float* rg;             // (C, T, 3 + 3 M)
};

// The block's per-tree state, in shared memory.
struct TreeShared {
  int feat[kNodePad];
  int cut[kNodePad];
  float lv[kNodePad];          // leaf values of the last drawn tree
  // per-node sums of the fixed-point weights and weighted residuals
  unsigned long long hist[2][kNodePad];
  float red[kWarps][8];
  // the chain's move statistics (0-5) and largest |w r| and w (6, 7)
  float tot[8];
  // the block's sums, read by the other blocks of its cluster (K > 1)
  float part[8];
  unsigned long long hsum[2][kNodePad];
  unsigned nog_bits[4];
  // eta, lft, rgt, move (0 grow, 1 prune, 2 change), accept, v, c,
  // n_leaf, n_nog, the fixed-point scales of w and of w r
  int sc[11];
};

// The block's state of a tree's regrow step (regrow_propose), in shared
// memory beside TreeShared only in the kernels that run the move: the
// proposed subtree's rows (valid on eta's subtree), the proposed
// partition's fixed-point sums over the observations under eta, the
// masks of eta's subtree, of the post-move tree's active nodes, of the
// proposal's active nodes and of the nodes whose split uniform falls
// under p_split; eta, the decision, n_active.
struct RegrowShared {
  int rfeat[kNodePad];
  int rcut[kNodePad];
  unsigned long long hist2[2][kNodePad];
  unsigned sub_bits[4], act_bits[4], new_bits[4], want_bits[4];
  int rsc[3];
};

// What the regrow step of a tree did: not run (its gate shut or the move
// off), run and refused, run and accepted.
enum class Regrow { kNone, kRefused, kAccepted };

// bit m of a 128-bit mask
__device__ inline bool bit(const unsigned* bits, int m) {
  return (bits[m >> 5] >> (m & 31)) & 1u;
}

// Where a tree's input rows are read from: device memory, or copies in
// shared memory that arrived ahead of the tree (sweep_cluster.cuh).
struct TreeRows {
  const int32_t* feat;         // (M,)
  const int32_t* cut;          // (M,)
  const float* u;              // (8,) proposal uniforms
  const float* zn;             // (128,) leaf normals
};

__device__ inline TreeRows global_rows(const SweepArgs& a, size_t ct) {
  return {a.feature_in + ct * a.M, a.cut_in + ct * a.M, a.u + ct * 8,
          a.zn + ct * kNodePad};
}

// The proposed move of the current tree, as every thread reads it.
struct Move {
  int eta, lft, rgt, move, cn;
  bool grow;
  const int32_t* rank_row;     // cut ranks of the proposed variable
};

// index of the target-th set bit (0-based, from node 0 up) of a 128-bit
// mask; 0 when there is none
__device__ inline int pick_marked(const unsigned* bits, int count, float u) {
  int target = (int)floorf(u * (float)count);
  target = min(target, count - 1);
  if (target < 0) return 0;
  for (int k = 0; k < 4; ++k) {
    int pc = __popc(bits[k]);
    if (target < pc) {
      unsigned b = bits[k];
      for (int j = 0; j < target; ++j) b &= b - 1;
      return 32 * k + (__ffs(b) - 1);
    }
    target -= pc;
  }
  return 0;
}

// the split variable of a tree whose proposal uniform u[3] is u3: the
// inverse CDF of the split probabilities
__device__ inline int pick_var(const SweepArgs& a, float u3) {
  int v = 0;
  for (int j = 0; j < a.P; ++j) v += a.spcum[j] <= u3 ? 1 : 0;
  return min(v, a.P - 1);
}

// a pointer to the same shared-memory object in block ``rank`` of this
// block's cluster
template <typename X>
__device__ inline X* in_rank(X* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

__device__ inline void cluster_sync() {
  cooperative_groups::this_cluster().sync();
}

__device__ inline float leaf_marginal(float n, float s, float s2, float t2) {
  float denom = s2 + n * t2;
  return 0.5f * logf(s2 / denom) + t2 * s * s / (2.0f * s2 * denom);
}

// Loads the tree's heap rows, clears the leaf histograms and picks the
// move: node picks by warp ballots over the leaf and NOG masks, the
// variable by inverse CDF, the cut uniformly.  Ends on a block barrier.
__device__ inline Move begin_tree(const SweepArgs& a, TreeShared& s,
                                  const TreeRows& rows) {
  const int M = a.M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* u = rows.u;
  for (int m = tid; m < kNodePad; m += kThreads) {
    s.feat[m] = m < M ? rows.feat[m] : kInactive;
    s.cut[m] = m < M ? rows.cut[m] : 0;
  }
  for (int j = tid; j < 2 * kNodePad; j += kThreads) (&s.hist[0][0])[j] = 0;
  __syncthreads();

  if (warp == 0) {
    unsigned leaf_bits[4], nog_bits[4];
    for (int k = 0; k < 4; ++k) {
      int node = 32 * k + lane;
      int f = s.feat[node];
      int lc = 2 * node + 1, rc = 2 * node + 2;
      int fl = lc < M ? s.feat[lc] : kInactive;
      int fr = rc < M ? s.feat[rc] : kInactive;
      leaf_bits[k] = __ballot_sync(kFull, f == kLeaf);
      nog_bits[k] = __ballot_sync(kFull, f >= 0 && fl == kLeaf &&
                                             fr == kLeaf);
    }
    if (lane == 0) {
      int n_leaf = 0, n_nog = 0;
      for (int k = 0; k < 4; ++k) {
        n_leaf += __popc(leaf_bits[k]);
        n_nog += __popc(nog_bits[k]);
        s.nog_bits[k] = nog_bits[k];
      }
      float u_move = u[0];
      bool grow = u_move < a.p_grow;
      bool prune = !grow && u_move < a.p_grow + a.p_prune;
      int v = pick_var(a, u[3]);
      int cn = min((int)floorf(u[4] * (float)a.n_cuts), a.n_cuts - 1);
      int eta = grow ? pick_marked(leaf_bits, n_leaf, u[1])
                     : pick_marked(nog_bits, max(n_nog, 1), u[2]);
      s.sc[0] = eta;
      s.sc[1] = min(2 * eta + 1, M - 1);
      s.sc[2] = min(2 * eta + 2, M - 1);
      s.sc[3] = grow ? 0 : (prune ? 1 : 2);
      s.sc[5] = v;
      s.sc[6] = cn;
      s.sc[7] = n_leaf;
      s.sc[8] = n_nog;
    }
  }
  __syncthreads();

  Move mv;
  mv.eta = s.sc[0];
  mv.lft = s.sc[1];
  mv.rgt = s.sc[2];
  mv.move = s.sc[3];
  mv.cn = s.sc[6];
  mv.grow = mv.move == 0;
  mv.rank_row = a.ranks_t + (size_t)s.sc[5] * a.N;
  return mv;
}

// Adds one observation (leaf li, goes left of the proposed split gl,
// weight w, weighted partial residual wr) to a thread's six move
// statistics: (n, s) over the move's nodes, over those going left, and
// over the current left child; acc[6] and acc[7] keep the largest |wr|
// and w, which scale the leaf histograms.
__device__ inline void add_move_stats(float acc[8], const Move& mv, int li,
                                      bool gl, float w, float wr) {
  acc[6] = fmaxf(acc[6], fabsf(wr));
  acc[7] = fmaxf(acc[7], w);
  bool ml = li == mv.lft;
  bool mem = mv.grow ? (li == mv.eta) : (ml || li == mv.rgt);
  if (mem) {
    acc[0] += w;
    acc[1] += wr;
    if (gl) {
      acc[2] += w;
      acc[3] += wr;
    }
  }
  if (ml) {
    acc[4] += w;
    acc[5] += wr;
  }
}

// The power of two S that turns values of magnitude at most amax into
// 64-bit integers whose sum over N values cannot overflow:
// N * amax * 2^S < 2^62.  Kept within a float's exponent range.
__device__ inline int fix_scale(float amax, int N) {
  if (!(amax > 0.0f)) return 0;
  int e;
  frexpf(amax, &e);                       // amax < 2^e
  const int en = 32 - __clz(max(N, 1));   // N < 2^en
  return min(62 - en - e, 127);
}

// x as a fixed-point integer of scale S (|S| <= 127; x * 2^S is exact)
__device__ inline long long to_fixed(float x, int S) {
  const float f = S >= -126 ? __int_as_float((S + 127) << 23)
                            : ldexpf(1.0f, S);
  return __float2ll_rn(x * f);
}

// a fixed-point sum of scale S back to float
__device__ inline float from_fixed(unsigned long long v, int S) {
  return (float)ldexp((double)(long long)v, -S);
}

// Sums the threads' move statistics (acc[0..5], in fixed order) and
// takes the largest |w r| and w (acc[6], acc[7]) over the chain, leaving
// the totals in s.tot and the leaf histograms' fixed-point scales in
// s.sc[9] (w) and s.sc[10] (w r).  Called by every thread; contains block
// barriers and, in a cluster of K > 1 blocks, one cluster barrier, after
// which every block adds the blocks' sums in rank order.
__device__ inline void chain_stats(TreeShared& s, const float acc[8], int N,
                                   int K) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = 0; k < 8; ++k) {
    float x = acc[k];
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(kFull, x, off);
      x = k < 6 ? x + y : fmaxf(x, y);
    }
    if (lane == 0) s.red[warp][k] = x;
  }
  __syncthreads();
  if (K > 1) {
    if (tid < 8) {
      float x = 0.0f;
      for (int wp = 0; wp < kWarps; ++wp)
        x = tid < 6 ? x + s.red[wp][tid] : fmaxf(x, s.red[wp][tid]);
      s.part[tid] = x;
    }
    cluster_sync();
  }
  if (tid < 8) {
    float x = 0.0f;
    if (K == 1) {
      for (int wp = 0; wp < kWarps; ++wp)
        x = tid < 6 ? x + s.red[wp][tid] : fmaxf(x, s.red[wp][tid]);
    } else {
      x = in_rank(s.part, 0)[tid];
      for (int r = 1; r < K; ++r) {
        const float y = in_rank(s.part, r)[tid];
        x = tid < 6 ? x + y : fmaxf(x, y);
      }
    }
    s.tot[tid] = x;
    if (tid >= 6) s.sc[9 + (7 - tid)] = fix_scale(x, N);
  }
  __syncthreads();
}

// The Metropolis-Hastings decision of the move from the chain's six move
// statistics st (n, s over the move's nodes, over those going left, over
// the current left child) and, when given, the pair rn over those going
// right (else the move's total less the left pair); on acceptance
// rewrites the tree rows in shared memory and sets s.sc[4].  Run by one
// thread.
__device__ inline void mh_decide(const SweepArgs& a, TreeShared& s,
                                 const Move& mv, const float* st,
                                 const TreeRows& rows, float s2, float t2,
                                 const float* rn = nullptr) {
  const float* u = rows.u;
  const int eta = mv.eta, lft = mv.lft, rgt = mv.rgt, move = mv.move;
  float n_all = st[0], s_all = st[1], n_ln = st[2], s_ln = st[3];
  float n_lo = st[4], s_lo = st[5];
  float n_rn = rn ? rn[0] : n_all - n_ln, s_rn = rn ? rn[1] : s_all - s_ln;
  float n_ro = n_all - n_lo, s_ro = s_all - s_lo;
  float m_all = leaf_marginal(n_all, s_all, s2, t2);
  float m_ln = leaf_marginal(n_ln, s_ln, s2, t2);
  float m_rn = leaf_marginal(n_rn, s_rn, s2, t2);
  float m_lo = leaf_marginal(n_lo, s_lo, s2, t2);
  float m_ro = leaf_marginal(n_ro, s_ro, s2, t2);
  int n_leaf = s.sc[7], n_nog = s.sc[8];
  int d = 31 - __clz(eta + 1);
  float ps_d = a.psplit[d];
  float split_term = logf(ps_d)
      + 2.0f * log1pf(-a.psplit[min(d + 1, a.max_depth + 1)])
      - log1pf(-ps_d);
  bool valid;
  float log_accept;
  if (mv.grow) {
    int parent = eta > 0 ? (eta - 1) / 2 : 0;
    bool parent_was_nog =
        eta > 0 && ((s.nog_bits[parent >> 5] >> (parent & 31)) & 1u);
    int n_nog_grow = n_nog + 1 - (parent_was_nog ? 1 : 0);
    float trans = a.trans_grow0 + logf((float)n_leaf)
        - logf((float)n_nog_grow);
    log_accept = split_term + trans + (m_ln + m_rn - m_all);
    valid = d < a.max_depth && n_ln > 0.0f && n_rn > 0.0f;
  } else if (move == 1) {
    float trans = a.trans_prune0 + logf((float)n_nog)
        - logf((float)max(n_leaf - 1, 1));
    log_accept = -split_term + trans + (m_all - m_lo - m_ro);
    valid = n_nog > 0;
  } else {
    log_accept = m_ln + m_rn - m_lo - m_ro;
    valid = n_nog > 0 && n_ln > 0.0f && n_rn > 0.0f;
  }
  bool accept = valid && (logf(u[5]) < log_accept);
  if (accept) {
    if (move == 1) {
      s.feat[eta] = kLeaf;
      s.feat[lft] = kInactive;
      s.feat[rgt] = kInactive;
    } else {
      s.feat[eta] = s.sc[5];
      s.feat[lft] = kLeaf;
      s.feat[rgt] = kLeaf;
      s.cut[eta] = mv.cn;
    }
  }
  s.sc[4] = accept ? 1 : 0;
}

// Sums the threads' move statistics (chain_stats) and makes the
// Metropolis-Hastings decision (mh_decide).  Returns whether the move was
// accepted.  Called by every thread; every block of a cluster makes the
// same decision from the same numbers.
__device__ inline bool decide(const SweepArgs& a, TreeShared& s,
                              const Move& mv, const float acc[8],
                              const TreeRows& rows, float s2, float t2,
                              int K = 1) {
  chain_stats(s, acc, a.N, K);
  if (threadIdx.x == 0) mh_decide(a, s, mv, s.tot, rows, s2, t2);
  __syncthreads();
  return s.sc[4] != 0;
}

// The leaf an observation in leaf li (going left of the proposed split
// when gl) lands in after the decision.
__device__ inline int moved_leaf(const Move& mv, bool accept, int li,
                                 bool gl) {
  if (accept) {
    bool mem = mv.grow ? (li == mv.eta) : (li == mv.lft || li == mv.rgt);
    if (mem) li = mv.move == 1 ? mv.eta : (gl ? mv.lft : mv.rgt);
  }
  return li;
}

// The sum of v over the lanes of group grp (every lane of the warp calls
// it together, each with its own group), exact: v (|v| < 2^62) is cut
// into three 21-bit limbs, each summed by an integer warp reduction.
__device__ inline long long group_sum(unsigned grp, long long v) {
  const unsigned l0 = (unsigned)(v & 0x1fffff);
  const unsigned l1 = (unsigned)((v >> 21) & 0x1fffff);
  const int l2 = (int)(v >> 42);
  const long long s0 = (long long)__reduce_add_sync(grp, l0);
  const long long s1 = (long long)__reduce_add_sync(grp, l1);
  const long long s2 = (long long)__reduce_add_sync(grp, l2);
  return s0 + (s1 << 21) + (s2 * (1ll << 42));
}

// Adds W observations per lane (weight w[k] and weighted residual wr[k]
// in leaf li[k], ignored unless in[k]) to the histogram pair h (of the
// block's shared memory), in the fixed-point scales chain_stats set.
// Every lane of the warp calls it together.  The W observations are
// independent, so their warp reductions overlap.  Unweighted (every w 1),
// the weights' sum is the group's size times 2^scale, exactly.
template <int W>
__device__ inline void hist_add(unsigned long long (&h)[2][kNodePad],
                                const TreeShared& s, const bool (&in)[W],
                                const int (&li)[W], const float (&w)[W],
                                const float (&wr)[W], bool weighted) {
  const int lane = threadIdx.x & 31;
  const int sw_scale = s.sc[9], swr_scale = s.sc[10];
  unsigned grp[W];
  long long tr[W], tw[W];
#pragma unroll
  for (int k = 0; k < W; ++k) grp[k] = __match_any_sync(kFull, li[k]);
#pragma unroll
  for (int k = 0; k < W; ++k)
    tr[k] = group_sum(grp[k], in[k] ? to_fixed(wr[k], swr_scale) : 0);
#pragma unroll
  for (int k = 0; k < W; ++k)
    tw[k] = weighted ? group_sum(grp[k], in[k] ? to_fixed(w[k], sw_scale) : 0)
                     : (long long)__popc(grp[k]) * to_fixed(1.0f, sw_scale);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (in[k] && lane == __ffs(grp[k]) - 1) {
      atomicAdd(&h[0][li[k]], (unsigned long long)tw[k]);
      atomicAdd(&h[1][li[k]], (unsigned long long)tr[k]);
    }
  }
}

// hist_add into the block's leaf histograms
template <int W>
__device__ inline void hist_add(TreeShared& s, const bool (&in)[W],
                                const int (&li)[W], const float (&w)[W],
                                const float (&wr)[W], bool weighted) {
  hist_add<W>(s.hist, s, in, li, w, wr, weighted);
}

// In a cluster of K > 1 blocks, publishes the block's leaf histograms and
// waits on a cluster barrier.  Called by every thread after a block
// barrier.
__device__ inline void gather_hist(TreeShared& s, int M, int K) {
  if (K == 1) return;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    s.hsum[0][m] = s.hist[0][m];
    s.hsum[1][m] = s.hist[1][m];
  }
  cluster_sync();
}

// Node m's sums (weight and weighted residual) in the histogram pair h
// over the chain: this block's (K = 1) or, in a cluster, every block's in
// rank order, in the fixed-point scales of chain_stats.
__device__ inline void hist_sums(TreeShared& s,
                                 unsigned long long (&h)[2][kNodePad], int m,
                                 int K, float& cnt, float& sm) {
  unsigned long long c = 0, r = 0;
  if (K == 1) {
    c = h[0][m];
    r = h[1][m];
  } else {
    for (int k = 0; k < K; ++k) {
      c += in_rank(&h[0][0], k)[m];
      r += in_rank(&h[1][0], k)[m];
    }
  }
  cnt = from_fixed(c, s.sc[9]);
  sm = from_fixed(r, s.sc[10]);
}

// Node m's leaf statistics (weight and weighted residual sums) over the
// chain, after gather_hist; after an accepted regrow (r not null), those
// of the proposed partition on eta's subtree.
__device__ inline void leaf_sums(TreeShared& s, int m, int K, float& cnt,
                                 float& sm, RegrowShared* r = nullptr) {
  if (r != nullptr && bit(r->sub_bits, m))
    hist_sums(s, r->hist2, m, K, cnt, sm);
  else if (K == 1)
    hist_sums(s, s.hist, m, K, cnt, sm);
  else
    hist_sums(s, s.hsum, m, K, cnt, sm);
}

// Conjugate leaf draws from the summed histograms; keeps the tree's leaf
// values in s.lv and, when ``write`` (one block per chain writes), writes
// the tree's rows out.  Every block of a cluster draws the same values
// from the same sums.  ``rg``: what the tree's regrow step did (which
// gathered the histograms already when it ran), with its state r.
// Called by every thread after a block barrier; ends on one.
__device__ inline void draw_leaves(const SweepArgs& a, TreeShared& s,
                                   size_t ct, const TreeRows& rows, float s2,
                                   float t2, int K = 1, bool write = true,
                                   Regrow rg = Regrow::kNone,
                                   RegrowShared* r = nullptr) {
  const int M = a.M;
  if (rg == Regrow::kNone) gather_hist(s, M, K);
  RegrowShared* accepted = rg == Regrow::kAccepted ? r : nullptr;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    float cnt, sm;
    leaf_sums(s, m, K, cnt, sm, accepted);
    float pv = 1.0f / (cnt / s2 + 1.0f / t2);
    float pm = pv * sm / s2;
    float mu = pm + sqrtf(pv) * rows.zn[m];
    float lv = s.feat[m] == kLeaf ? mu : 0.0f;
    s.lv[m] = lv;
    if (write) {
      a.lv_out[ct * M + m] = lv;
      a.feature_out[ct * M + m] = s.feat[m];
      a.cut_out[ct * M + m] = s.cut[m];
    }
  }
  __syncthreads();
}

// The operands a regrow step reads, for a step that is not inlined into
// the sweep's loop (sweep_cluster.cuh:regrow_on_chip): passed by value
// in a few registers, where the whole SweepArgs would take many.
struct RegrowArgs {
  const float* rg;
  const int32_t* ranks_t;
  const float* spcum;
  const float* psplit;
  const float* weights;
  int32_t* lidx_out;
  int N, P, M, n_cuts;
  float p_regrow;

  explicit __device__ RegrowArgs(const SweepArgs& a)
      : rg(a.rg), ranks_t(a.ranks_t), spcum(a.spcum), psplit(a.psplit),
        weights(a.weights), lidx_out(a.lidx_out), N(a.N), P(a.P), M(a.M),
        n_cuts(a.n_cuts), p_regrow(a.p_regrow) {}

  // the SweepArgs the regrow's functions read (its other fields null)
  __device__ SweepArgs args() const {
    SweepArgs a{};
    a.rg = rg;
    a.ranks_t = ranks_t;
    a.spcum = spcum;
    a.psplit = psplit;
    a.weights = weights;
    a.lidx_out = lidx_out;
    a.N = N;
    a.P = P;
    a.M = M;
    a.n_cuts = n_cuts;
    a.p_regrow = p_regrow;
    return a;
  }
};

// This (chain, tree)'s row of regrow uniforms.
__device__ inline const float* regrow_row(const SweepArgs& a, size_t ct) {
  return a.rg + ct * (size_t)(3 + 3 * a.M);
}

// Whether the tree's regrow gate opens: the move is on and the gate
// uniform falls under p_regrow.  The same for every thread of a chain.
__device__ inline bool regrow_gate(const SweepArgs& a, size_t ct) {
  return a.rg != nullptr && regrow_row(a, ct)[0] < a.p_regrow;
}

// Proposes the regrow of the post-move tree in s.feat / s.cut from its
// uniforms ``row``: eta picked among the active nodes by pick_marked, and
// over eta's subtree a draw from the CGM prior (split where the split
// uniform falls under p_split at the node's absolute depth, the variable
// by pick_var, the cut uniformly), active where every node from eta down
// to its parent splits.  Leaves the proposal in r.rfeat / r.rcut, the
// masks in r.sub_bits, r.act_bits and r.new_bits, eta in r.rsc[0] and
// n_active in r.rsc[2], and r.hist2 zeroed.  Called by every thread;
// ends on a block barrier.
__device__ inline void regrow_propose(const SweepArgs& a,
                                      const TreeShared& s, RegrowShared& r,
                                      const float* row) {
  const int M = a.M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* u3 = row + 3;
  for (int j = tid; j < 2 * kNodePad; j += kThreads) (&r.hist2[0][0])[j] = 0;
  if (warp == 0) {
    int n = 0;
    for (int k = 0; k < 4; ++k) {
      const unsigned b = __ballot_sync(kFull, s.feat[32 * k + lane] !=
                                                  kInactive);
      n += __popc(b);
      if (lane == 0) r.act_bits[k] = b;
    }
    if (lane == 0) {
      r.rsc[0] = pick_marked(r.act_bits, n, row[1]);
      r.rsc[2] = n;
    }
  }
  __syncthreads();
  const int eta = r.rsc[0];
  bool in = false, want = false;
  int v = 0, cn = 0;
  if (tid < kNodePad) {
    const int m = tid;
    if (m < M) {
      for (int x = m;; x = (x - 1) >> 1) {
        if (x == eta) {
          in = true;
          break;
        }
        if (x == 0) break;
      }
      want = u3[m] < a.psplit[31 - __clz(m + 1)];
      v = pick_var(a, u3[M + m]);
      cn = min((int)floorf(u3[2 * M + m] * (float)a.n_cuts), a.n_cuts - 1);
    }
    const unsigned wb = __ballot_sync(kFull, want);
    const unsigned sb = __ballot_sync(kFull, in);
    if (lane == 0) {
      r.want_bits[warp] = wb;
      r.sub_bits[warp] = sb;
    }
  }
  __syncthreads();
  if (tid < kNodePad) {
    const int m = tid;
    bool act = in;
    for (int x = m; act && x != eta;) {
      x = (x - 1) >> 1;
      act = bit(r.want_bits, x);
    }
    const int f = act ? (want ? v : kLeaf) : kInactive;
    r.rfeat[m] = f;
    r.rcut[m] = f >= 0 ? cn : 0;
    const unsigned nb = __ballot_sync(kFull, act);
    if (lane == 0) r.new_bits[warp] = nb;
  }
  __syncthreads();
}

// The leaf of the proposed subtree that observation ``obs`` (of the N),
// whose post-move leaf lies under eta, lands in: the walk down from eta.
__device__ inline int regrow_leaf(const SweepArgs& a, const RegrowShared& r,
                                  int eta, int obs) {
  int node = eta;
  for (int f = r.rfeat[node]; f >= 0; f = r.rfeat[node])
    node = 2 * node + (a.ranks_t[(size_t)f * a.N + obs] <= r.rcut[node]
                       ? 1 : 2);
  return node;
}

// The proposed partition's sums of a block's observations [0, n) (of
// the N, from ``start``) into r.hist2: those whose post-move leaf
// leaf(i) lies under eta, at the leaf of the proposed subtree they land
// in, with their weights wts[i] (null: unweighted) and partial residuals
// resid(i).  One observation per thread at a time, so that the step adds
// few registers to the sweep it runs in; the sums are integers, so their
// order does not matter.  Every thread calls it; no barrier.
template <typename Leaf, typename Resid>
__device__ inline void regrow_pass(const SweepArgs& a, const TreeShared& s,
                                   RegrowShared& r, int start, int n,
                                   const float* wts, Leaf leaf,
                                   Resid resid) {
  const int eta = r.rsc[0];
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    bool in[1] = {i < n && bit(r.sub_bits, leaf(i))};
    int li[1] = {-1};
    float w[1] = {0.0f}, wr[1] = {0.0f};
    if (in[0]) {
      li[0] = regrow_leaf(a, r, eta, start + i);
      w[0] = wts ? wts[i] : 1.0f;
      wr[0] = wts ? w[0] * resid(i) : resid(i);
    }
    hist_add<1>(r.hist2, s, in, li, w, wr, wts != nullptr);
  }
}

// The regrow's Metropolis-Hastings decision from each node's sums in the
// post-move partition (old(m, cnt, sm)) and in the proposed one
// (prop(m, cnt, sm)): log accept = m(T') - m(T) + log n_active(T) -
// log n_active(T'), each marginal summed over the leaves of eta's
// subtree in node order; a proposal with an empty leaf (weights
// included) is refused.  The gate has opened.  Run by warp 0; leaves the
// decision in r.rsc[1].
template <typename Old, typename Prop>
__device__ inline void regrow_mh(const TreeShared& s, RegrowShared& r,
                                 const float* row, int M, float s2, float t2,
                                 Old old, Prop prop) {
  const int lane = threadIdx.x & 31;
  float m_old = 0.0f, m_new = 0.0f;
  bool empty = false;
  for (int k = 0; k < 4; ++k) {
    const int m = 32 * k + lane;
    float to = 0.0f, tn = 0.0f;
    if (m < M && bit(r.sub_bits, m)) {
      float cnt, sm;
      if (s.feat[m] == kLeaf) {
        old(m, cnt, sm);
        to = leaf_marginal(cnt, sm, s2, t2);
      }
      if (r.rfeat[m] == kLeaf) {
        prop(m, cnt, sm);
        tn = leaf_marginal(cnt, sm, s2, t2);
        empty = empty || cnt <= 0.0f;
      }
    }
    for (int j = 0; j < 32; ++j) {
      m_old += __shfl_sync(kFull, to, j);
      m_new += __shfl_sync(kFull, tn, j);
    }
  }
  empty = __any_sync(kFull, empty);
  if (lane == 0) {
    int n_sub = 0, n_new = 0;
    for (int k = 0; k < 4; ++k) {
      n_sub += __popc(r.act_bits[k] & r.sub_bits[k]);
      n_new += __popc(r.new_bits[k]);
    }
    const int n_act = r.rsc[2], n_act_new = n_act - n_sub + n_new;
    const float log_accept = m_new - m_old + logf((float)n_act)
        - logf((float)n_act_new);
    r.rsc[1] = !empty && logf(row[2]) < log_accept ? 1 : 0;
  }
}

// regrow_mh from the block's histograms: the post-move partition's in
// s.hist (s.hsum in a cluster, after gather_hist), the proposed one's in
// r.hist2.  Called by every thread after a block barrier that follows
// the proposed partition's pass; in a cluster of K > 1 blocks it waits on
// a cluster barrier first.  Returns the decision, the same in every
// block.
__device__ inline bool regrow_decide(const SweepArgs& a, TreeShared& s,
                                     RegrowShared& r, const float* row,
                                     float s2, float t2, int K) {
  if (K > 1) cluster_sync();
  if (threadIdx.x < 32) {
    regrow_mh(s, r, row, a.M, s2, t2,
              [&](int m, float& cnt, float& sm) {
                leaf_sums(s, m, K, cnt, sm);
              },
              [&](int m, float& cnt, float& sm) {
                hist_sums(s, r.hist2, m, K, cnt, sm);
              });
  }
  __syncthreads();
  return r.rsc[1] != 0;
}

// An accepted regrow's rows: eta's subtree set from the proposal.  Called
// by every thread; ends on a block barrier.
__device__ inline void regrow_accept(TreeShared& s, const RegrowShared& r) {
  for (int m = threadIdx.x; m < kNodePad; m += kThreads) {
    if (bit(r.sub_bits, m)) {
      s.feat[m] = r.rfeat[m];
      s.cut[m] = r.rcut[m];
    }
  }
  __syncthreads();
}

}  // namespace s4b
