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
// back to the real type.
//
// Every per-tree structure and step is also a template on the real type
// Real of the state (the residual, tree fits, leaf values, variates and
// every sum and decision): float, or double in the builds of each source
// compiled with S4B_F64 (ops/cuda_build.py builds both; BuildReal, and
// S4B_SYM gives the double build's C symbols an _f64 suffix).  The
// fixed-point histograms stay 64-bit integers in both, but the rounding
// of each value to 2^-scale does not cost the same.  In float only values
// below about 2^-26 of the chain's largest magnitude lose bits, which a
// float sum cannot resolve anyway.  In double every value rounds to
// 2^-scale, about 2^-48 of the largest magnitude at n = 10 000 (N * amax
// * 2^scale < 2^62), coarser than a double's own 2^-53: each per-node
// sum is then exact to about n * 2^-49 of the largest |w r|, some 1e-10
// of it at n = 10 000, far inside the 1e-9 the double builds are held to
// against their plain version.
//
// The tree heap's size is a template parameter kPad of every per-tree
// structure and step: each kernel is built for kPadShallow = 128 slots
// (max_depth <= 6, the build the sweep had before deeper trees),
// kPadDeep = 512 slots (max_depth 7 and 8) and kPadDeepest = 1024
// (max_depth 9).  Node masks are kPad / 32 words, and the
// one-thread-per-node steps take kPad / kThreads nodes a thread.  A
// 512-slot heap's TreeShared and RegrowShared take 35 520 B of static
// shared memory (9 168 B at 128), within the 48 KB a kernel may declare
// statically; a 1024-slot heap's take 70 656 B, so that build keeps them
// at the head of the block's dynamic shared memory (static_state,
// state_bytes).
//
// A 2048-slot heap's would leave no room for a tile of observations in a
// block's 227 KB, so every kernel has heap builds (heap_build: kPad
// kPadHeap or kPadHeapWide, the largest heap each takes) whose heap size
// is the run-time SweepArgs::pad, any power of two from 128 up (launched
// for pads past 1024, max_depth 10 and deeper), and whose per-tree state
// lives in a slab of device memory, one per block (heap_bytes, SweepArgs::
// heap; bind_state points the block at its own).  Their TreeShared and
// RegrowShared in shared memory are views of the slab (the arrays) and the
// few scalars and warp sums; a histogram pair is a HeapHist, indexed as
// the static builds' arrays are.  Every step runs the static builds'
// arithmetic in the same order, so at equal K a heap build gives their
// forests to the bit: the node masks are built by every warp and counted
// by integer atomics, pick_marked_warp finds the same set bit, and the
// fixed-point histograms take global integer atomics, whose sums do not
// depend on order.  The blocks of a cluster still gather each other's
// histograms (gather_hist, hist_sums), from device memory past an L1
// that other SMs' writes do not reach (__ldcg), after a fenced cluster
// barrier (state_sync).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace s4b {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// heap slots of the three builds; a heap of kPad slots holds max_nodes + 1
// <= kPad (the sharded stats launch keeps a pair in slot M)
constexpr int kPadShallow = 128;
constexpr int kPadDeep = 512;
constexpr int kPadDeepest = 1024;
// the heap builds, the largest heap each takes: two-byte copies of the
// leaf indices (sweep_cluster.cuh:LeafCopy) hold nodes below 32 768 slots
// (max_depth 14), four-byte ones any
constexpr int kPadHeap = 1 << 15;
constexpr int kPadHeapWide = 1 << 30;
constexpr int kLeaf = -1;
constexpr int kInactive = -2;
constexpr unsigned kFull = 0xffffffffu;

// The real type of a build: double where the source is compiled with
// S4B_F64, else float; S4B_SYM(name) is a C launcher's symbol in it.
#ifdef S4B_F64
using BuildReal = double;
#define S4B_SYM(name) name##_f64
#else
using BuildReal = float;
#define S4B_SYM(name) name
#endif

template <typename Real>
struct SweepArgs {
  const int32_t* feature_in;   // (C, T, M)
  const int32_t* cut_in;       // (C, T, M)
  const int32_t* lidx_in;      // (C, T, N)
  const Real* tfit_in;         // (C, T, N)
  const Real* resid0;          // (C, N) y_target - allfit
  const Real* sigma2;          // (C,)
  const Real* tau2;            // (C,)
  const Real* u;               // (C, T, 8) proposal uniforms
  const Real* zn;              // (C, T, kPad) leaf normals
  const int32_t* ranks_t;      // (P, N) cut ranks
  const Real* spcum;           // (P,) split-probability cumsum
  const Real* psplit;          // (max_depth + 2,) p_split by depth
  const Real* weights;         // (N,) or nullptr
  int32_t* feature_out;
  int32_t* cut_out;
  Real* lv_out;                // (C, T, M)
  int32_t* lidx_out;
  Real* tfit_out;
  Real* resid_out;             // (C, N)
  int T, N, P, M, max_depth, n_cuts;
  Real p_grow, p_prune;
  Real trans_grow0;            // log(p_prune) - log(p_grow)
  Real trans_prune0;           // log(p_grow) - log(p_prune)
  // the ablation stubs' extra operands (bart_sweep_ablate.cu), else null
  const Real* lv_in;           // (C, T, M) leaf values to look up
  Real* stats_out;             // (C, T, 2, M) per-node leaf statistics
  // the in-sweep subtree regrow (ops/bart.py:_subtree_regrow): its
  // probability and, per (chain, tree), a row of 3 + 3 M uniforms: gate,
  // node pick, accept, then each node's split, variable and cut; rg is
  // null when p_regrow is 0
  Real p_regrow;
  const Real* rg;              // (C, T, 3 + 3 M)
  // the heap builds' per-block state slabs (heap_bytes each) and heap
  // slots; null and unread in the static builds, whose slots are kPad
  unsigned char* heap;
  int pad;
};

// Whether kernels built for kPad keep the per-tree state in device memory
// with the heap size at run time.
__host__ __device__ constexpr bool heap_build(int kPad) {
  return kPad > kPadDeepest;
}

// The heap slots of a launch of the build for kPad.
template <int kPad, typename Real>
__device__ inline int row_pad(const SweepArgs<Real>& a) {
  if constexpr (heap_build(kPad)) {
    return a.pad;
  } else {
    return kPad;
  }
}

// The block's per-tree state, in shared memory.
template <int kPad, typename Real>
struct TreeShared {
  int feat[kPad];
  int cut[kPad];
  Real lv[kPad];               // leaf values of the last drawn tree
  // per-node sums of the fixed-point weights and weighted residuals
  unsigned long long hist[2][kPad];
  Real red[kWarps][8];
  // the chain's move statistics (0-5) and largest |w r| and w (6, 7)
  Real tot[8];
  // the block's sums, read by the other blocks of its cluster (K > 1)
  Real part[8];
  unsigned long long hsum[2][kPad];
  unsigned nog_bits[kPad / 32];
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
template <int kPad>
struct RegrowShared {
  int rfeat[kPad];
  int rcut[kPad];
  unsigned long long hist2[2][kPad];
  unsigned sub_bits[kPad / 32], act_bits[kPad / 32], new_bits[kPad / 32],
      want_bits[kPad / 32];
  int rsc[3];
};

// A histogram pair of a heap build's state in device memory: h[j][m] as
// in the static builds' arrays (row j of pad words from p); row j of rank
// k's pair (block k of the cluster) at row(j, k).
struct HeapHist {
  unsigned long long* p;
  unsigned long long* rank0;   // rank 0's pair
  long long step;              // words from one block's slab to the next
  int pad;

  __device__ unsigned long long* operator[](int j) const {
    return p + (size_t)j * pad;
  }
  __device__ const unsigned long long* row(int j, int k) const {
    return rank0 + k * step + (size_t)j * pad;
  }
};

// TreeShared of the heap builds: views of the block's slab (the rows, the
// leaf values, the histograms, the NOG and leaf masks) beside the warp
// sums and scalars, in shared memory.
template <typename Real>
struct TreeHeap {
  int* feat;
  int* cut;
  Real* lv;
  HeapHist hist;
  HeapHist hsum;
  unsigned* nog_bits;
  unsigned* leaf_bits;
  int pad;
  Real red[kWarps][8];
  Real tot[8];
  Real part[8];
  int sc[11];
};

template <typename Real>
struct TreeShared<kPadHeap, Real> : TreeHeap<Real> {};
template <typename Real>
struct TreeShared<kPadHeapWide, Real> : TreeHeap<Real> {};

// RegrowShared of the heap builds: views of the block's slab.
struct RegrowHeap {
  int* rfeat;
  int* rcut;
  HeapHist hist2;
  unsigned *sub_bits, *act_bits, *new_bits, *want_bits;
  int rsc[3];
};

template <>
struct RegrowShared<kPadHeap> : RegrowHeap {};
template <>
struct RegrowShared<kPadHeapWide> : RegrowHeap {};

// Bytes of a heap build's slab per block at ``pad`` slots (a power of two,
// at least 128), with the regrow step's state when ``regrow``: the
// histogram pairs hist and hsum (and hist2), the leaf values, the rows
// feat and cut (and rfeat and rcut), the NOG and leaf masks (and the
// regrow's four), in that order; 256-aligned.
template <typename Real>
__host__ __device__ constexpr size_t heap_bytes(int pad, bool regrow) {
  const size_t p = (size_t)pad;
  const size_t b = p * (32 + sizeof(Real) + 8) + p / 4
      + (regrow ? p * 24 + p / 2 : 0);
  return (b + 255) & ~(size_t)255;
}

// Whether a build keeps its per-tree state (TreeShared and, with the
// regrow step, RegrowShared) in static shared memory: up to kPadDeep
// slots, and the heap builds' views; a 1024-slot heap's state is past the
// 48 KB a kernel may declare statically and lives at the head of the
// block's dynamic shared memory.
template <int kPad>
__host__ __device__ constexpr bool static_state() {
  return kPad != kPadDeepest;
}

// The dynamic shared memory a build's per-tree state takes (0 when
// static), with the regrow step's when ``regrow``.
template <int kPad, typename Real>
__host__ __device__ constexpr size_t state_bytes(bool regrow) {
  return static_state<kPad>()
      ? 0
      : sizeof(TreeShared<kPad, Real>)
            + (regrow ? sizeof(RegrowShared<kPad>) : 0);
}

static_assert(sizeof(TreeShared<kPadDeepest, float>) % 16 == 0 &&
                  sizeof(TreeShared<kPadDeepest, double>) % 16 == 0 &&
                  sizeof(RegrowShared<kPadDeepest>) % 16 == 0,
              "the dynamic shared memory after the state stays 16-aligned");

// The block's per-tree state in a kernel whose dynamic shared memory
// ``dyn`` holds nothing else: a static shared block up to kPadDeep slots,
// else the head of ``dyn``.
template <int kPad, typename Real>
__device__ inline TreeShared<kPad, Real>& tree_state(unsigned char* dyn) {
  if constexpr (static_state<kPad>()) {
    __shared__ TreeShared<kPad, Real> s;
    return s;
  } else {
    return *reinterpret_cast<TreeShared<kPad, Real>*>(dyn);
  }
}

// The block's regrow state beside tree_state's.
template <int kPad, typename Real>
__device__ inline RegrowShared<kPad>& regrow_state(unsigned char* dyn) {
  if constexpr (static_state<kPad>()) {
    __shared__ RegrowShared<kPad> r;
    return r;
  } else {
    return *reinterpret_cast<RegrowShared<kPad>*>(
        dyn + sizeof(TreeShared<kPad, Real>));
  }
}

// A histogram view of ``pad``-word rows at byte ``off`` of each block's
// slab (``stride`` bytes from base), for block ``blk`` of a cluster whose
// rank 0 is block ``first``.
__device__ inline HeapHist heap_hist(unsigned char* base, size_t stride,
                                     size_t off, int blk, int first,
                                     int pad) {
  return {reinterpret_cast<unsigned long long*>(base + blk * stride + off),
          reinterpret_cast<unsigned long long*>(base + first * stride + off),
          (long long)(stride / 8), pad};
}

// Points a heap build's state views (s, and r when not null) at this
// block's slab of a.heap (heap_bytes with the regrow step's state when r
// is given: every block of a launch takes the same); the blocks of a
// cluster of K are consecutive.  Nothing in the static builds.  Called by
// every thread; ends on a block barrier in the heap builds.
template <int kPad, typename Real>
__device__ inline void bind_state(const SweepArgs<Real>& a,
                                  TreeShared<kPad, Real>& s,
                                  RegrowShared<kPad>* r, int K) {
  if constexpr (heap_build(kPad)) {
    if (threadIdx.x == 0) {
      const int pad = a.pad, blk = blockIdx.x, first = blk - blk % K;
      const size_t p = (size_t)pad;
      const size_t stride = heap_bytes<Real>(pad, r != nullptr);
      const size_t hists = 16 * p * (r ? 3 : 2);
      unsigned char* mine = a.heap + blk * stride;
      s.hist = heap_hist(a.heap, stride, 0, blk, first, pad);
      s.hsum = heap_hist(a.heap, stride, 16 * p, blk, first, pad);
      s.lv = reinterpret_cast<Real*>(mine + hists);
      s.feat = reinterpret_cast<int*>(mine + hists + sizeof(Real) * p);
      s.cut = s.feat + p;
      unsigned* bits = reinterpret_cast<unsigned*>(s.cut + p + (r ? 2 * p
                                                                  : 0));
      s.nog_bits = bits;
      s.leaf_bits = bits + p / 32;
      s.pad = pad;
      if (r != nullptr) {
        r->hist2 = heap_hist(a.heap, stride, 32 * p, blk, first, pad);
        r->rfeat = s.cut + p;
        r->rcut = s.cut + 2 * p;
        r->sub_bits = bits + 2 * (p / 32);
        r->act_bits = bits + 3 * (p / 32);
        r->new_bits = bits + 4 * (p / 32);
        r->want_bits = bits + 5 * (p / 32);
      }
    }
    __syncthreads();
  }
}

// The heap slots of a block's state.
template <int kPad, typename Real>
__device__ inline int pad_of(const TreeShared<kPad, Real>& s) {
  if constexpr (heap_build(kPad)) {
    return s.pad;
  } else {
    return kPad;
  }
}


// What the regrow step of a tree did: not run (its gate shut or the move
// off), run and refused, run and accepted.
enum class Regrow { kNone, kRefused, kAccepted };

// bit m of a node mask
__device__ inline bool bit(const unsigned* bits, int m) {
  return (bits[m >> 5] >> (m & 31)) & 1u;
}

// Where a tree's input rows are read from: device memory, or copies in
// shared memory that arrived ahead of the tree (sweep_cluster.cuh).
template <typename Real>
struct TreeRows {
  const int32_t* feat;         // (M,)
  const int32_t* cut;          // (M,)
  const Real* u;               // (8,) proposal uniforms
  const Real* zn;              // (kPad,) leaf normals
};

template <int kPad, typename Real>
__device__ inline TreeRows<Real> global_rows(const SweepArgs<Real>& a,
                                             size_t ct) {
  return {a.feature_in + ct * a.M, a.cut_in + ct * a.M, a.u + ct * 8,
          a.zn + ct * row_pad<kPad>(a)};
}

// The proposed move of the current tree, as every thread reads it.
struct Move {
  int eta, lft, rgt, move, cn;
  bool grow;
  const int32_t* rank_row;     // cut ranks of the proposed variable
};

// index of the target-th set bit (0-based, from node 0 up) of a node mask
// of kWords words; 0 when there is none
template <int kWords, typename Real>
__device__ inline int pick_marked(const unsigned* bits, int count, Real u) {
  int target = (int)floor(u * (Real)count);
  target = min(target, count - 1);
  if (target < 0) return 0;
  for (int k = 0; k < kWords; ++k) {
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

// pick_marked over a mask of ``words`` words in memory, by the 32 lanes of
// a warp together, 32 words at a time: the same node, for every lane.
template <typename Real>
__device__ inline int pick_marked_warp(const unsigned* bits, int words,
                                       int count, Real u) {
  const int lane = threadIdx.x & 31;
  int target = (int)floor(u * (Real)count);
  target = min(target, count - 1);
  if (target < 0) return 0;
  for (int k0 = 0; k0 < words; k0 += 32) {
    const unsigned b = k0 + lane < words ? bits[k0 + lane] : 0u;
    const int pc = __popc(b);
    int incl = pc;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (target < total) {
      const int src = __ffs(__ballot_sync(kFull, target < incl)) - 1;
      const int before = __shfl_sync(kFull, incl - pc, src);
      unsigned w = __shfl_sync(kFull, b, src);
      for (int j = 0; j < target - before; ++j) w &= w - 1;
      return 32 * (k0 + src) + (__ffs(w) - 1);
    }
    target -= total;
  }
  return 0;
}

// the split variable of a tree whose proposal uniform u[3] is u3: the
// inverse CDF of the split probabilities
template <typename Real>
__device__ inline int pick_var(const SweepArgs<Real>& a, Real u3) {
  int v = 0;
  for (int j = 0; j < a.P; ++j) v += a.spcum[j] <= u3 ? 1 : 0;
  return min(v, a.P - 1);
}

// the cut of a cut uniform u: uniform over the n_cuts cuts
template <typename Real>
__device__ inline int pick_cut(Real u, int n_cuts) {
  return min((int)floor(u * (Real)n_cuts), n_cuts - 1);
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

// A cluster barrier after which the blocks read each other's state: a
// heap build's is device memory, whose writes are fenced first.
template <int kPad>
__device__ inline void state_sync() {
  if constexpr (heap_build(kPad)) __threadfence();
  cluster_sync();
}

template <typename Real>
__device__ inline Real leaf_marginal(Real n, Real s, Real s2, Real t2) {
  Real denom = s2 + n * t2;
  return Real(0.5) * log(s2 / denom) + t2 * s * s / (Real(2) * s2 * denom);
}

// Loads the tree's heap rows, clears the leaf histograms and picks the
// move: node picks by warp ballots over the leaf and NOG masks, the
// variable by inverse CDF, the cut uniformly.  Ends on a block barrier.
// A heap build's masks go to its slab, built by every warp and counted by
// shared integer atomics; warp 0 picks from them (pick_marked_warp).
template <int kPad, typename Real>
__device__ inline Move begin_tree(const SweepArgs<Real>& a,
                                  TreeShared<kPad, Real>& s,
                                  const TreeRows<Real>& rows) {
  const int M = a.M, pad = pad_of(s);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Real* u = rows.u;
  for (int m = tid; m < pad; m += kThreads) {
    s.feat[m] = m < M ? rows.feat[m] : kInactive;
    s.cut[m] = m < M ? rows.cut[m] : 0;
  }
  for (int j = tid; j < 2 * pad; j += kThreads) (&s.hist[0][0])[j] = 0;
  if (heap_build(kPad) && tid == 0) {
    s.sc[7] = 0;
    s.sc[8] = 0;
  }
  __syncthreads();

  if constexpr (heap_build(kPad)) {
    for (int k = warp; k < pad / 32; k += kWarps) {
      const int node = 32 * k + lane;
      const int f = s.feat[node];
      const int lc = 2 * node + 1, rc = 2 * node + 2;
      const int fl = lc < M ? s.feat[lc] : kInactive;
      const int fr = rc < M ? s.feat[rc] : kInactive;
      const unsigned lb = __ballot_sync(kFull, f == kLeaf);
      const unsigned nb = __ballot_sync(kFull, f >= 0 && fl == kLeaf &&
                                                   fr == kLeaf);
      if (lane == 0) {
        s.leaf_bits[k] = lb;
        s.nog_bits[k] = nb;
        atomicAdd(&s.sc[7], __popc(lb));
        atomicAdd(&s.sc[8], __popc(nb));
      }
    }
    __syncthreads();
    if (warp == 0) {
      const int n_leaf = s.sc[7], n_nog = s.sc[8];
      const bool grow = u[0] < a.p_grow;
      const bool prune = !grow && u[0] < a.p_grow + a.p_prune;
      const int eta =
          grow ? pick_marked_warp(s.leaf_bits, pad / 32, n_leaf, u[1])
               : pick_marked_warp(s.nog_bits, pad / 32, max(n_nog, 1),
                                  u[2]);
      if (lane == 0) {
        s.sc[0] = eta;
        s.sc[1] = min(2 * eta + 1, M - 1);
        s.sc[2] = min(2 * eta + 2, M - 1);
        s.sc[3] = grow ? 0 : (prune ? 1 : 2);
        s.sc[5] = pick_var(a, u[3]);
        s.sc[6] = pick_cut(u[4], a.n_cuts);
      }
    }
  } else if (warp == 0) {
    constexpr int kWords = kPad / 32;
    unsigned leaf_bits[kWords], nog_bits[kWords];
    for (int k = 0; k < kWords; ++k) {
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
      for (int k = 0; k < kWords; ++k) {
        n_leaf += __popc(leaf_bits[k]);
        n_nog += __popc(nog_bits[k]);
        s.nog_bits[k] = nog_bits[k];
      }
      Real u_move = u[0];
      bool grow = u_move < a.p_grow;
      bool prune = !grow && u_move < a.p_grow + a.p_prune;
      int v = pick_var(a, u[3]);
      int cn = pick_cut(u[4], a.n_cuts);
      int eta = grow ? pick_marked<kWords>(leaf_bits, n_leaf, u[1])
                     : pick_marked<kWords>(nog_bits, max(n_nog, 1), u[2]);
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
template <typename Real>
__device__ inline void add_move_stats(Real acc[8], const Move& mv, int li,
                                      bool gl, Real w, Real wr) {
  acc[6] = fmax(acc[6], fabs(wr));
  acc[7] = fmax(acc[7], w);
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
// N * amax * 2^S < 2^62.  Kept within the real type's exponent range
// (2^S a normal number: S <= 127 in float, 1023 in double).
template <typename Real>
__device__ inline int fix_scale(Real amax, int N) {
  constexpr int kMaxScale = sizeof(Real) == 4 ? 127 : 1023;
  if (!(amax > Real(0))) return 0;
  int e;
  frexp(amax, &e);                        // amax < 2^e
  const int en = 32 - __clz(max(N, 1));   // N < 2^en
  return min(62 - en - e, kMaxScale);
}

// x as a fixed-point integer of scale S (|S| <= 127; x * 2^S is exact)
__device__ inline long long to_fixed(float x, int S) {
  const float f = S >= -126 ? __int_as_float((S + 127) << 23)
                            : ldexpf(1.0f, S);
  return __float2ll_rn(x * f);
}

// x as a fixed-point integer of scale S (|S| <= 1023; x * 2^S is exact)
__device__ inline long long to_fixed(double x, int S) {
  const double f =
      S >= -1022 ? __longlong_as_double((long long)(S + 1023) << 52)
                 : ldexp(1.0, S);
  return __double2ll_rn(x * f);
}

// a fixed-point sum of scale S back to the real type
template <typename Real>
__device__ inline Real from_fixed(unsigned long long v, int S) {
  return (Real)ldexp((double)(long long)v, -S);
}

// Sums the threads' move statistics (acc[0..5], in fixed order) and
// takes the largest |w r| and w (acc[6], acc[7]) over the chain, leaving
// the totals in s.tot and the leaf histograms' fixed-point scales in
// s.sc[9] (w) and s.sc[10] (w r).  Called by every thread; contains block
// barriers and, in a cluster of K > 1 blocks, one cluster barrier, after
// which every block adds the blocks' sums in rank order.
template <int kPad, typename Real>
__device__ inline void chain_stats(TreeShared<kPad, Real>& s,
                                   const Real acc[8], int N, int K) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = 0; k < 8; ++k) {
    Real x = acc[k];
    for (int off = 16; off > 0; off >>= 1) {
      const Real y = __shfl_xor_sync(kFull, x, off);
      x = k < 6 ? x + y : fmax(x, y);
    }
    if (lane == 0) s.red[warp][k] = x;
  }
  __syncthreads();
  if (K > 1) {
    if (tid < 8) {
      Real x = Real(0);
      for (int wp = 0; wp < kWarps; ++wp)
        x = tid < 6 ? x + s.red[wp][tid] : fmax(x, s.red[wp][tid]);
      s.part[tid] = x;
    }
    cluster_sync();
  }
  if (tid < 8) {
    Real x = Real(0);
    if (K == 1) {
      for (int wp = 0; wp < kWarps; ++wp)
        x = tid < 6 ? x + s.red[wp][tid] : fmax(x, s.red[wp][tid]);
    } else {
      x = in_rank(s.part, 0)[tid];
      for (int r = 1; r < K; ++r) {
        const Real y = in_rank(s.part, r)[tid];
        x = tid < 6 ? x + y : fmax(x, y);
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
template <int kPad, typename Real>
__device__ inline void mh_decide(const SweepArgs<Real>& a,
                                 TreeShared<kPad, Real>& s, const Move& mv,
                                 const Real* st, const TreeRows<Real>& rows,
                                 Real s2, Real t2,
                                 const Real* rn = nullptr) {
  const Real* u = rows.u;
  const int eta = mv.eta, lft = mv.lft, rgt = mv.rgt, move = mv.move;
  Real n_all = st[0], s_all = st[1], n_ln = st[2], s_ln = st[3];
  Real n_lo = st[4], s_lo = st[5];
  Real n_rn = rn ? rn[0] : n_all - n_ln, s_rn = rn ? rn[1] : s_all - s_ln;
  Real n_ro = n_all - n_lo, s_ro = s_all - s_lo;
  Real m_all = leaf_marginal(n_all, s_all, s2, t2);
  Real m_ln = leaf_marginal(n_ln, s_ln, s2, t2);
  Real m_rn = leaf_marginal(n_rn, s_rn, s2, t2);
  Real m_lo = leaf_marginal(n_lo, s_lo, s2, t2);
  Real m_ro = leaf_marginal(n_ro, s_ro, s2, t2);
  int n_leaf = s.sc[7], n_nog = s.sc[8];
  int d = 31 - __clz(eta + 1);
  Real ps_d = a.psplit[d];
  Real split_term = log(ps_d)
      + Real(2) * log1p(-a.psplit[min(d + 1, a.max_depth + 1)])
      - log1p(-ps_d);
  bool valid;
  Real log_accept;
  if (mv.grow) {
    int parent = eta > 0 ? (eta - 1) / 2 : 0;
    bool parent_was_nog =
        eta > 0 && ((s.nog_bits[parent >> 5] >> (parent & 31)) & 1u);
    int n_nog_grow = n_nog + 1 - (parent_was_nog ? 1 : 0);
    Real trans = a.trans_grow0 + log((Real)n_leaf)
        - log((Real)n_nog_grow);
    log_accept = split_term + trans + (m_ln + m_rn - m_all);
    valid = d < a.max_depth && n_ln > Real(0) && n_rn > Real(0);
  } else if (move == 1) {
    Real trans = a.trans_prune0 + log((Real)n_nog)
        - log((Real)max(n_leaf - 1, 1));
    log_accept = -split_term + trans + (m_all - m_lo - m_ro);
    valid = n_nog > 0;
  } else {
    log_accept = m_ln + m_rn - m_lo - m_ro;
    valid = n_nog > 0 && n_ln > Real(0) && n_rn > Real(0);
  }
  bool accept = valid && (log(u[5]) < log_accept);
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
template <int kPad, typename Real>
__device__ inline bool decide(const SweepArgs<Real>& a,
                              TreeShared<kPad, Real>& s, const Move& mv,
                              const Real acc[8], const TreeRows<Real>& rows,
                              Real s2, Real t2, int K = 1) {
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
// block's shared memory, or a heap build's HeapHist in device memory), in
// the fixed-point scales chain_stats set.
// Every lane of the warp calls it together.  The W observations are
// independent, so their warp reductions overlap.  Unweighted (every w 1),
// the weights' sum is the group's size times 2^scale, exactly.
template <int W, typename H, int kPad, typename Real>
__device__ inline void hist_add(H& h, const TreeShared<kPad, Real>& s,
                                const bool (&in)[W],
                                const int (&li)[W], const Real (&w)[W],
                                const Real (&wr)[W], bool weighted) {
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
                     : (long long)__popc(grp[k]) * to_fixed(Real(1),
                                                            sw_scale);
#pragma unroll
  for (int k = 0; k < W; ++k) {
    if (in[k] && lane == __ffs(grp[k]) - 1) {
      atomicAdd(&h[0][li[k]], (unsigned long long)tw[k]);
      atomicAdd(&h[1][li[k]], (unsigned long long)tr[k]);
    }
  }
}

// hist_add into the block's leaf histograms
template <int W, int kPad, typename Real>
__device__ inline void hist_add(TreeShared<kPad, Real>& s,
                                const bool (&in)[W], const int (&li)[W],
                                const Real (&w)[W], const Real (&wr)[W],
                                bool weighted) {
  hist_add<W>(s.hist, s, in, li, w, wr, weighted);
}

// Word m of row j of a histogram pair of this block: a heap build's, the
// sum of global atomics, read from L2, past an L1 that atomics bypass.
template <int kPad, typename H>
__device__ inline unsigned long long hist_at(H& h, int j, int m) {
  if constexpr (heap_build(kPad)) {
    return __ldcg(h[j] + m);
  } else {
    return h[j][m];
  }
}

// In a cluster of K > 1 blocks, publishes the block's leaf histograms and
// waits on a cluster barrier.  Called by every thread after a block
// barrier.
template <int kPad, typename Real>
__device__ inline void gather_hist(TreeShared<kPad, Real>& s, int M, int K) {
  if (K == 1) return;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    s.hsum[0][m] = hist_at<kPad>(s.hist, 0, m);
    s.hsum[1][m] = hist_at<kPad>(s.hist, 1, m);
  }
  state_sync<kPad>();
}

// Node m's sums (weight and weighted residual) in the histogram pair h
// over the chain: this block's (K = 1) or, in a cluster, every block's in
// rank order (a heap build's read past L1), in the fixed-point scales of
// chain_stats.
template <int kPad, typename Real, typename H>
__device__ inline void hist_sums(TreeShared<kPad, Real>& s, H& h, int m,
                                 int K, Real& cnt, Real& sm) {
  unsigned long long c = 0, r = 0;
  if (K == 1) {
    c = hist_at<kPad>(h, 0, m);
    r = hist_at<kPad>(h, 1, m);
  } else {
    for (int k = 0; k < K; ++k) {
      if constexpr (heap_build(kPad)) {
        c += __ldcg(h.row(0, k) + m);
        r += __ldcg(h.row(1, k) + m);
      } else {
        c += in_rank(&h[0][0], k)[m];
        r += in_rank(&h[1][0], k)[m];
      }
    }
  }
  cnt = from_fixed<Real>(c, s.sc[9]);
  sm = from_fixed<Real>(r, s.sc[10]);
}

// Node m's leaf statistics (weight and weighted residual sums) over the
// chain, after gather_hist; after an accepted regrow (r not null), those
// of the proposed partition on eta's subtree.
template <int kPad, typename Real>
__device__ inline void leaf_sums(TreeShared<kPad, Real>& s, int m, int K,
                                 Real& cnt, Real& sm,
                                 RegrowShared<kPad>* r = nullptr) {
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
template <int kPad, typename Real>
__device__ inline void draw_leaves(const SweepArgs<Real>& a,
                                   TreeShared<kPad, Real>& s, size_t ct,
                                   const TreeRows<Real>& rows, Real s2,
                                   Real t2, int K = 1, bool write = true,
                                   Regrow rg = Regrow::kNone,
                                   RegrowShared<kPad>* r = nullptr) {
  const int M = a.M;
  if (rg == Regrow::kNone) gather_hist(s, M, K);
  RegrowShared<kPad>* accepted = rg == Regrow::kAccepted ? r : nullptr;
  for (int m = threadIdx.x; m < M; m += kThreads) {
    Real cnt, sm;
    leaf_sums(s, m, K, cnt, sm, accepted);
    Real pv = Real(1) / (cnt / s2 + Real(1) / t2);
    Real pm = pv * sm / s2;
    Real mu = pm + sqrt(pv) * rows.zn[m];
    Real lv = s.feat[m] == kLeaf ? mu : Real(0);
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
template <typename Real>
struct RegrowArgs {
  const Real* rg;
  const int32_t* ranks_t;
  const Real* spcum;
  const Real* psplit;
  const Real* weights;
  int32_t* lidx_out;
  int N, P, M, n_cuts;
  Real p_regrow;

  explicit __device__ RegrowArgs(const SweepArgs<Real>& a)
      : rg(a.rg), ranks_t(a.ranks_t), spcum(a.spcum), psplit(a.psplit),
        weights(a.weights), lidx_out(a.lidx_out), N(a.N), P(a.P), M(a.M),
        n_cuts(a.n_cuts), p_regrow(a.p_regrow) {}

  // the SweepArgs the regrow's functions read (its other fields null)
  __device__ SweepArgs<Real> args() const {
    SweepArgs<Real> a{};
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
template <typename Real>
__device__ inline const Real* regrow_row(const SweepArgs<Real>& a,
                                         size_t ct) {
  return a.rg + ct * (size_t)(3 + 3 * a.M);
}

// Whether the tree's regrow gate opens: the move is on and the gate
// uniform falls under p_regrow.  The same for every thread of a chain.
template <typename Real>
__device__ inline bool regrow_gate(const SweepArgs<Real>& a, size_t ct) {
  return a.rg != nullptr && regrow_row(a, ct)[0] < a.p_regrow;
}

// regrow_propose of a heap build, whose nodes are too many to keep a
// thread's in registers: the masks are built by every warp (the active
// nodes counted by a shared integer atomic) and warp 0 picks eta from them
// (pick_marked_warp); then one pass over the nodes sets the subtree and
// split masks, and a second reads them back and writes the proposal, its
// variables and cuts drawn from the same uniforms as the static builds'.
template <int kPad, typename Real>
__device__ inline void regrow_propose_heap(const SweepArgs<Real>& a,
                                           const TreeShared<kPad, Real>& s,
                                           RegrowShared<kPad>& r,
                                           const Real* row) {
  const int M = a.M, pad = pad_of(s), words = pad / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Real* u3 = row + 3;
  for (int j = tid; j < 2 * pad; j += kThreads) (&r.hist2[0][0])[j] = 0;
  if (tid == 0) r.rsc[2] = 0;
  __syncthreads();
  for (int k = warp; k < words; k += kWarps) {
    const unsigned b = __ballot_sync(kFull, s.feat[32 * k + lane] !=
                                                kInactive);
    if (lane == 0) {
      r.act_bits[k] = b;
      atomicAdd(&r.rsc[2], __popc(b));
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int eta = pick_marked_warp(r.act_bits, words, r.rsc[2], row[1]);
    if (lane == 0) r.rsc[0] = eta;
  }
  __syncthreads();
  const int eta = r.rsc[0];
  // a warp's 32 nodes of one pass are one mask word
  for (int m = tid; m < pad; m += kThreads) {
    bool in = false, want = false;
    if (m < M) {
      for (int x = m;; x = (x - 1) >> 1) {
        if (x == eta) {
          in = true;
          break;
        }
        if (x == 0) break;
      }
      want = u3[m] < a.psplit[31 - __clz(m + 1)];
    }
    const unsigned wb = __ballot_sync(kFull, want);
    const unsigned sb = __ballot_sync(kFull, in);
    if (lane == 0) {
      r.want_bits[m >> 5] = wb;
      r.sub_bits[m >> 5] = sb;
    }
  }
  __syncthreads();
  for (int m = tid; m < pad; m += kThreads) {
    bool act = bit(r.sub_bits, m);
    for (int x = m; act && x != eta;) {
      x = (x - 1) >> 1;
      act = bit(r.want_bits, x);
    }
    const int f = act ? (bit(r.want_bits, m) ? pick_var(a, u3[M + m])
                                             : kLeaf)
                      : kInactive;
    r.rfeat[m] = f;
    r.rcut[m] = f >= 0 ? pick_cut(u3[2 * M + m], a.n_cuts) : 0;
    const unsigned nb = __ballot_sync(kFull, act);
    if (lane == 0) r.new_bits[m >> 5] = nb;
  }
  __syncthreads();
}

// Proposes the regrow of the post-move tree in s.feat / s.cut from its
// uniforms ``row``: eta picked among the active nodes by pick_marked, and
// over eta's subtree a draw from the CGM prior (split where the split
// uniform falls under p_split at the node's absolute depth, the variable
// by pick_var, the cut uniformly), active where every node from eta down
// to its parent splits.  Leaves the proposal in r.rfeat / r.rcut, the
// masks in r.sub_bits, r.act_bits and r.new_bits, eta in r.rsc[0] and
// n_active in r.rsc[2], and r.hist2 zeroed.  One thread per node, kNodes
// nodes a thread (node j * kThreads + tid), a warp's 32 nodes one mask
// word.  Called by every thread; ends on a block barrier.
template <int kPad, typename Real>
__device__ inline void regrow_propose_static(
    const SweepArgs<Real>& a, const TreeShared<kPad, Real>& s,
    RegrowShared<kPad>& r, const Real* row) {
  constexpr int kWords = kPad / 32;
  constexpr int kNodes = (kPad + kThreads - 1) / kThreads;
  const int M = a.M;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Real* u3 = row + 3;
  for (int j = tid; j < 2 * kPad; j += kThreads) (&r.hist2[0][0])[j] = 0;
  if (warp == 0) {
    int n = 0;
    for (int k = 0; k < kWords; ++k) {
      const unsigned b = __ballot_sync(kFull, s.feat[32 * k + lane] !=
                                                  kInactive);
      n += __popc(b);
      if (lane == 0) r.act_bits[k] = b;
    }
    if (lane == 0) {
      r.rsc[0] = pick_marked<kWords>(r.act_bits, n, row[1]);
      r.rsc[2] = n;
    }
  }
  __syncthreads();
  const int eta = r.rsc[0];
  bool in[kNodes], want[kNodes];
  int v[kNodes], cn[kNodes];
#pragma unroll
  for (int j = 0; j < kNodes; ++j) {
    const int m = j * kThreads + tid;
    in[j] = false;
    want[j] = false;
    v[j] = 0;
    cn[j] = 0;
    if (m < kPad) {
      if (m < M) {
        for (int x = m;; x = (x - 1) >> 1) {
          if (x == eta) {
            in[j] = true;
            break;
          }
          if (x == 0) break;
        }
        want[j] = u3[m] < a.psplit[31 - __clz(m + 1)];
        v[j] = pick_var(a, u3[M + m]);
        cn[j] = pick_cut(u3[2 * M + m], a.n_cuts);
      }
      const unsigned wb = __ballot_sync(kFull, want[j]);
      const unsigned sb = __ballot_sync(kFull, in[j]);
      if (lane == 0) {
        r.want_bits[m >> 5] = wb;
        r.sub_bits[m >> 5] = sb;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kNodes; ++j) {
    const int m = j * kThreads + tid;
    if (m < kPad) {
      bool act = in[j];
      for (int x = m; act && x != eta;) {
        x = (x - 1) >> 1;
        act = bit(r.want_bits, x);
      }
      const int f = act ? (want[j] ? v[j] : kLeaf) : kInactive;
      r.rfeat[m] = f;
      r.rcut[m] = f >= 0 ? cn[j] : 0;
      const unsigned nb = __ballot_sync(kFull, act);
      if (lane == 0) r.new_bits[m >> 5] = nb;
    }
  }
  __syncthreads();
}

// The regrow proposal of a static build (regrow_propose_static) or of a
// heap build (regrow_propose_heap).
template <int kPad, typename Real>
__device__ inline void regrow_propose(const SweepArgs<Real>& a,
                                      const TreeShared<kPad, Real>& s,
                                      RegrowShared<kPad>& r,
                                      const Real* row) {
  if constexpr (heap_build(kPad)) {
    regrow_propose_heap(a, s, r, row);
  } else {
    regrow_propose_static(a, s, r, row);
  }
}

// The leaf of the proposed subtree that observation ``obs`` (of the N),
// whose post-move leaf lies under eta, lands in: the walk down from eta.
template <int kPad, typename Real>
__device__ inline int regrow_leaf(const SweepArgs<Real>& a,
                                  const RegrowShared<kPad>& r, int eta,
                                  int obs) {
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
template <int kPad, typename Real, typename Leaf, typename Resid>
__device__ inline void regrow_pass(const SweepArgs<Real>& a,
                                   const TreeShared<kPad, Real>& s,
                                   RegrowShared<kPad>& r, int start, int n,
                                   const Real* wts, Leaf leaf,
                                   Resid resid) {
  const int eta = r.rsc[0];
  for (int base = 0; base < n; base += kThreads) {
    const int i = base + threadIdx.x;
    bool in[1] = {i < n && bit(r.sub_bits, leaf(i))};
    int li[1] = {-1};
    Real w[1] = {Real(0)}, wr[1] = {Real(0)};
    if (in[0]) {
      li[0] = regrow_leaf(a, r, eta, start + i);
      w[0] = wts ? wts[i] : Real(1);
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
template <int kPad, typename Real, typename Old, typename Prop>
__device__ inline void regrow_mh(const TreeShared<kPad, Real>& s,
                                 RegrowShared<kPad>& r, const Real* row,
                                 int M, Real s2, Real t2, Old old,
                                 Prop prop) {
  const int words = pad_of(s) / 32;
  const int lane = threadIdx.x & 31;
  Real m_old = Real(0), m_new = Real(0);
  bool empty = false;
  for (int k = 0; k < words; ++k) {
    // a heap build skips the words outside eta's subtree, whose terms
    // are zeros that leave both sums as they are
    if (heap_build(kPad) && r.sub_bits[k] == 0u) continue;
    const int m = 32 * k + lane;
    Real to = Real(0), tn = Real(0);
    if (m < M && bit(r.sub_bits, m)) {
      Real cnt, sm;
      if (s.feat[m] == kLeaf) {
        old(m, cnt, sm);
        to = leaf_marginal(cnt, sm, s2, t2);
      }
      if (r.rfeat[m] == kLeaf) {
        prop(m, cnt, sm);
        tn = leaf_marginal(cnt, sm, s2, t2);
        empty = empty || cnt <= Real(0);
      }
    }
    for (int j = 0; j < 32; ++j) {
      m_old += __shfl_sync(kFull, to, j);
      m_new += __shfl_sync(kFull, tn, j);
    }
  }
  empty = __any_sync(kFull, empty);
  int n_sub = 0, n_new = 0;
  if constexpr (heap_build(kPad)) {
    for (int k = lane; k < words; k += 32) {
      n_sub += __popc(r.act_bits[k] & r.sub_bits[k]);
      n_new += __popc(r.new_bits[k]);
    }
    n_sub = __reduce_add_sync(kFull, n_sub);
    n_new = __reduce_add_sync(kFull, n_new);
  }
  if (lane == 0) {
    if constexpr (!heap_build(kPad)) {
      for (int k = 0; k < words; ++k) {
        n_sub += __popc(r.act_bits[k] & r.sub_bits[k]);
        n_new += __popc(r.new_bits[k]);
      }
    }
    const int n_act = r.rsc[2], n_act_new = n_act - n_sub + n_new;
    const Real log_accept = m_new - m_old + log((Real)n_act)
        - log((Real)n_act_new);
    r.rsc[1] = !empty && log(row[2]) < log_accept ? 1 : 0;
  }
}

// regrow_mh from the block's histograms: the post-move partition's in
// s.hist (s.hsum in a cluster, after gather_hist), the proposed one's in
// r.hist2.  Called by every thread after a block barrier that follows
// the proposed partition's pass; in a cluster of K > 1 blocks it waits on
// a cluster barrier first.  Returns the decision, the same in every
// block.
template <int kPad, typename Real>
__device__ inline bool regrow_decide(const SweepArgs<Real>& a,
                                     TreeShared<kPad, Real>& s,
                                     RegrowShared<kPad>& r, const Real* row,
                                     Real s2, Real t2, int K) {
  if (K > 1) state_sync<kPad>();
  if (threadIdx.x < 32) {
    regrow_mh(s, r, row, a.M, s2, t2,
              [&](int m, Real& cnt, Real& sm) {
                leaf_sums(s, m, K, cnt, sm);
              },
              [&](int m, Real& cnt, Real& sm) {
                hist_sums(s, r.hist2, m, K, cnt, sm);
              });
  }
  __syncthreads();
  return r.rsc[1] != 0;
}

// An accepted regrow's rows: eta's subtree set from the proposal.  Called
// by every thread; ends on a block barrier.
template <int kPad, typename Real>
__device__ inline void regrow_accept(TreeShared<kPad, Real>& s,
                                     const RegrowShared<kPad>& r) {
  for (int m = threadIdx.x; m < pad_of(s); m += kThreads) {
    if (bit(r.sub_bits, m)) {
      s.feat[m] = r.rfeat[m];
      s.cut[m] = r.rcut[m];
    }
  }
  __syncthreads();
}

}  // namespace s4b
