// Per-tree arithmetic shared by the port's BART sweep kernels.
//
// Both kernels (bart_sweep_batch.cu, residual in shared memory, and
// bart_sweep_tiled.cu, residual in device memory) run one thread block
// per chain and, per tree, the same steps: load the tree's heap rows and
// pick the move (begin_tree), sum the six move statistics over the
// observations (add_move_stats, then decide's fixed-order block sum and
// the Metropolis-Hastings decision), rewrite the leaf indices
// (moved_leaf) while summing the per-node leaf statistics (hist_add),
// and draw the leaf values (draw_leaves).  Only the observation passes
// differ between the kernels, so the decision arithmetic exists once and
// the two kernels give the same forest on the same inputs.
//
// Every sum is taken in a fixed order.  The six move statistics are
// per-thread sums over the observations tid, tid + kThreads, ..., then a
// warp butterfly, then the warps in order.  The per-node leaf statistics
// go to one 128-bin histogram per warp, filled kThreads observations at a
// time: within a warp, lanes holding the same node are grouped with
// __match_any_sync and their leader adds the group in lane order, so no
// two lanes ever add to one bin at once; the warp histograms are summed
// in warp order.

#pragma once

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
};

// The block's per-tree state, in shared memory.
struct TreeShared {
  int feat[kNodePad];
  int cut[kNodePad];
  float lv[kNodePad];          // leaf values of the last drawn tree
  float hist[kWarps][2][kNodePad];
  float red[kWarps][6];
  float stage_w[kWarps][32];
  float stage_wr[kWarps][32];
  unsigned nog_bits[4];
  // eta, lft, rgt, move (0 grow, 1 prune, 2 change), accept, v, c,
  // n_leaf, n_nog
  int sc[9];
};

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

__device__ inline float leaf_marginal(float n, float s, float s2, float t2) {
  float denom = s2 + n * t2;
  return 0.5f * logf(s2 / denom) + t2 * s * s / (2.0f * s2 * denom);
}

// Loads tree ct's heap rows, clears the leaf histograms and picks the
// move: node picks by warp ballots over the leaf and NOG masks, the
// variable by inverse CDF, the cut uniformly.  Ends on a block barrier.
__device__ inline Move begin_tree(const SweepArgs& a, TreeShared& s,
                                  size_t ct) {
  const int M = a.M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* u = a.u + ct * 8;
  for (int m = tid; m < kNodePad; m += kThreads) {
    s.feat[m] = m < M ? a.feature_in[ct * M + m] : kInactive;
    s.cut[m] = m < M ? a.cut_in[ct * M + m] : 0;
  }
  for (int j = tid; j < kWarps * 2 * kNodePad; j += kThreads)
    (&s.hist[0][0][0])[j] = 0.0f;
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
      int v = 0;
      for (int j = 0; j < a.P; ++j) v += a.spcum[j] <= u[3] ? 1 : 0;
      v = min(v, a.P - 1);
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
// over the current left child.
__device__ inline void add_move_stats(float acc[6], const Move& mv, int li,
                                      bool gl, float w, float wr) {
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

// Sums the threads' move statistics in fixed order and makes the
// Metropolis-Hastings decision; on acceptance rewrites the tree rows in
// shared memory.  Returns whether the move was accepted.  Called by every
// thread; contains block barriers.
__device__ inline bool decide(const SweepArgs& a, TreeShared& s,
                              const Move& mv, const float acc[6], size_t ct,
                              float s2, float t2) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = 0; k < 6; ++k) {
    float x = acc[k];
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_xor_sync(kFull, x, off);
    if (lane == 0) s.red[warp][k] = x;
  }
  __syncthreads();

  if (tid == 0) {
    const float* u = a.u + ct * 8;
    const int eta = mv.eta, lft = mv.lft, rgt = mv.rgt, move = mv.move;
    float st[6];
    for (int k = 0; k < 6; ++k) {
      float x = 0.0f;
      for (int wp = 0; wp < kWarps; ++wp) x += s.red[wp][k];
      st[k] = x;
    }
    float n_all = st[0], s_all = st[1], n_ln = st[2], s_ln = st[3];
    float n_lo = st[4], s_lo = st[5];
    float n_rn = n_all - n_ln, s_rn = s_all - s_ln;
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

// Adds one observation per lane (weight w and weighted residual wr in
// leaf li, ignored unless ``in``) to the warp's leaf histogram.  Every
// lane of the warp calls it together.
__device__ inline void hist_add(TreeShared& s, bool in, int li, float w,
                                float wr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s.stage_w[warp][lane] = w;
  s.stage_wr[warp][lane] = wr;
  unsigned grp = __match_any_sync(kFull, li);
  __syncwarp();
  if (in && lane == __ffs(grp) - 1) {
    float sw = 0.0f, swr = 0.0f;
    for (unsigned g = grp; g; g &= g - 1) {
      int l = __ffs(g) - 1;
      sw += s.stage_w[warp][l];
      swr += s.stage_wr[warp][l];
    }
    s.hist[warp][0][li] += sw;
    s.hist[warp][1][li] += swr;
  }
  __syncwarp();
}

// Conjugate leaf draws from the summed histograms; writes the tree's rows
// out and keeps its leaf values in s.lv.  Called by every thread after a
// block barrier; ends on one.
__device__ inline void draw_leaves(const SweepArgs& a, TreeShared& s,
                                   size_t ct, float s2, float t2) {
  const int M = a.M;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    float cnt = 0.0f, sm = 0.0f;
    for (int wp = 0; wp < kWarps; ++wp) {
      cnt += s.hist[wp][0][m];
      sm += s.hist[wp][1][m];
    }
    float pv = 1.0f / (cnt / s2 + 1.0f / t2);
    float pm = pv * sm / s2;
    float mu = pm + sqrtf(pv) * a.zn[ct * kNodePad + m];
    float lv = s.feat[m] == kLeaf ? mu : 0.0f;
    s.lv[m] = lv;
    a.lv_out[ct * M + m] = lv;
    a.feature_out[ct * M + m] = s.feat[m];
    a.cut_out[ct * M + m] = s.cut[m];
  }
  __syncthreads();
}

}  // namespace s4b
