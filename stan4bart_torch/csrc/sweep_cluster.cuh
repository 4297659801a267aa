// The cluster-and-stream layer of the port's BART sweep kernels.
//
// One chain is one cluster of K thread blocks (K in 1..8, grid
// C * K, blocks c * K .. c * K + K - 1 for chain c).  Block rank r owns the
// observations [start_r, start_r + n_r) of obs_range, and reduces them as
// one block per chain reduces all of them (sweep_common.cuh); the blocks'
// sums meet in distributed shared memory, added in rank order, so K = 1
// sums as one block per chain does and every K is deterministic.
//
// The observation passes read three arrays per (chain, tree) from device
// memory: the leaf indices, the tree's old fit and the cut-rank row of the
// proposed variable.  They arrive through a ring of kStages tiles in
// shared memory, filled by element-wise cp.async copies (4 bytes, 8 for
// the tree fits of a double build).  Each thread copies
// exactly the elements it will read itself (tile element k * kThreads +
// tid), so a tile needs no block barrier, any row offset and any n are
// fine (no 16-byte alignment), and the per-thread observation order is the
// one-block kernel's.  The tiles of all trees form one stream: a thread
// keeps kStages - 1 tiles in flight, so the first tiles of tree t + 1
// (whose rank row is known from its pre-drawn uniform) load while tree t
// is decided and its leaves drawn.  Only the residual depends on earlier
// trees; it stays in shared memory (sweep_on_chip).
//
// sweep_on_chip is the sweep with a block's residual slice (4 bytes an
// observation, 8 in a double build) and a copy of its leaf indices in
// shared memory (one byte an observation at 128 heap slots, two above:
// LeafCopy): bart_sweep_batch.cu and
// bart_sweep_chain.cu at any K, and bart_sweep_tiled.cu wherever the slice
// fits, so the three are bit-identical at equal K.  Its ``kBody`` selects
// the ablation stubs of bart_sweep_ablate.cu, which keep the grid,
// cluster, shared memory and streaming and drop the node math (kObs) or
// all arithmetic (kCopy).

#pragma once

#include <type_traits>

#include "sweep_common.cuh"

namespace s4b {

constexpr int kPer = 4;                   // observations per thread per tile
constexpr int kTile = kThreads * kPer;    // observations per tile
constexpr int kStages = 3;                // tiles in the ring

// the ring: the pass-1 operands of kStages tiles
template <typename Real>
struct Ring {
  int32_t li[kStages][kTile];
  Real tf[kStages][kTile];
  int32_t rk[kStages][kTile];
};

// the input rows of the kStages trees that can be in flight at once
template <int kPad, typename Real>
struct Heads {
  int32_t feat[kStages][kPad];
  int32_t cut[kStages][kPad];
  Real zn[kStages][kPad];
  Real u[kStages][8];
};

// The byte copy of a block's leaf indices in sweep_on_chip: per
// observation its leaf and, between pass 1 and pass 2, whether it goes
// left of the proposed split (the top bit, kLeft).  One byte at 128 heap
// slots (7 bits of node), two up to 32 768 (15 bits: the builds for 512
// and 1024 slots and the heap build kPadHeap), four in the heap build
// kPadHeapWide (31 bits).
template <int kPad>
struct LeafCopy {
  using T = typename std::conditional<
      (kPad <= 128), uint8_t,
      typename std::conditional<(kPad <= kPadHeap), uint16_t,
                                uint32_t>::type>::type;
  // the top bit, as an int below four bytes (the code the builds had
  // before the heap builds) and unsigned at four
  using Bit = typename std::conditional<(sizeof(T) < 4), int,
                                        unsigned>::type;
  static constexpr Bit kLeft = Bit(1) << (8 * sizeof(T) - 1);
};

// Bytes of the tree rows in flight (Heads) of the build for kPad: none in
// a heap build, whose sweeps read the rows from device memory.
template <int kPad, typename Real>
__host__ __device__ constexpr size_t heads_bytes() {
  if constexpr (heap_build(kPad)) {
    return 0;
  } else {
    return sizeof(Heads<kPad, Real>);
  }
}

// Observations per block of a K-block cluster: ceil(N / K), rounded up to
// 32 so that every range starts on a 128-byte boundary of a row.
__host__ __device__ inline int obs_chunk(int N, int K) {
  return ((N + K - 1) / K + 31) & ~31;
}

// this block's rank in its cluster of K blocks
__device__ inline int block_rank(int K) {
  return K > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
}

__device__ inline void obs_range(int N, int K, int rank, int& start,
                                 int& n) {
  const int chunk = obs_chunk(N, K);
  start = min(N, rank * chunk);
  n = min(N, start + chunk) - start;
}

// Dynamic shared memory of sweep_on_chip at N, T and K with heaps of
// kPad slots and state in Real: the ring, the tree rows in flight (none in
// a heap build), the residual slice, its copy of the leaf indices, the
// trees' variables.
template <int kPad, typename Real>
__host__ __device__ inline size_t on_chip_bytes(int N, int T, int K) {
  const size_t chunk = (size_t)obs_chunk(N, K);
  return sizeof(Ring<Real>) + heads_bytes<kPad, Real>()
      + chunk * sizeof(Real)
      + ((chunk * sizeof(typename LeafCopy<kPad>::T) + 15) & ~(size_t)15)
      + (((size_t)T * 4 + 15) & ~(size_t)15);
}

// an asynchronous copy of one element (4 or 8 bytes) to shared memory
template <typename X>
__device__ __forceinline__ void cp_async(X* smem, const X* gmem) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(sa), "l"(gmem), "n"(sizeof(X)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// One thread's view of the stream of pass-1 tiles of its block: tile q is
// tile q % nt of tree q / nt (nt >= 1, so that a block without
// observations still streams the tree rows).  Tile 0 of a tree also
// brings the tree's input rows (heap rows, uniforms, leaf normals) into
// heads[t % kStages], each thread the elements it reads itself (unless
// heads is null: the ablation stubs read no tree rows, and a heap build
// reads them from device memory).
template <int kPad, typename Real>
struct TileStream {
  const SweepArgs<Real>* a;
  Ring<Real>* ring;
  Heads<kPad, Real>* heads;
  const int* vsel;       // (T,) each tree's split variable
  size_t row0;           // c * T: the chain's first (chain, tree) row
  int start, n, nt, total;

  // Issues this thread's copies of tile q (nothing past the last) as one
  // commit group.
  __device__ inline void issue(int q) {
    if (q < total) {
      const int t = q / nt, j = q - t * nt, st = q % kStages;
      const size_t row = (row0 + t) * a->N + start;
      const int32_t* rk = a->ranks_t + (size_t)vsel[t] * a->N + start;
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = k * kThreads + threadIdx.x, i = j * kTile + e;
        if (i < n) {
          cp_async(&ring->li[st][e], a->lidx_in + row + i);
          cp_async(&ring->tf[st][e], a->tfit_in + row + i);
          cp_async(&ring->rk[st][e], rk + i);
        }
      }
      if constexpr (!heap_build(kPad)) {
        if (heads != nullptr && j == 0) {
          const int h = t % kStages;
          const size_t ct = row0 + t;
#pragma unroll
          for (int k = 0; k < (kPad + kThreads - 1) / kThreads; ++k) {
            const int m = k * kThreads + threadIdx.x;
            if (m < a->M) {
              cp_async(&heads->feat[h][m], a->feature_in + ct * a->M + m);
              cp_async(&heads->cut[h][m], a->cut_in + ct * a->M + m);
              cp_async(&heads->zn[h][m], a->zn + ct * kPad + m);
            }
          }
          if (threadIdx.x < 8)
            cp_async(&heads->u[h][threadIdx.x],
                     a->u + ct * 8 + threadIdx.x);
        }
      }
    }
    cp_async_commit();
  }
};

enum class Body { kFull, kCopy, kObs };

// The regrow step of tree ct of a block of sweep_on_chip, whose
// observations [start, start + n) hold their post-move leaves in lidx_s
// (LeafCopy) and their partial residuals in R: the post-move sums
// gathered, the proposal, a pass that walks the observations under eta
// down the proposed subtree into r.hist2 (regrow_pass), the decision
// and, if accepted, the rows and the leaf indices rewritten (each
// observation under eta walked again: only accepted moves pay for the
// rewrite).
// Each thread reads the leaf indices it wrote.  Called by every thread
// after a block barrier; ends on one.  Not inlined, its operands a small
// RegrowArgs by value: the loop around it keeps its own registers (the
// step inlined made the loop spill).
template <int kPad, typename Real>
__device__ __noinline__ Regrow regrow_on_chip(
    RegrowArgs<Real> ra, TreeShared<kPad, Real>& s, RegrowShared<kPad>& r,
    size_t ct, int start, int n, typename LeafCopy<kPad>::T* lidx_s,
    const Real* R, Real s2, Real t2, int K) {
  const SweepArgs<Real> a = ra.args();
  const int tid = threadIdx.x;
  const Real* row = regrow_row(a, ct);
  gather_hist(s, a.M, K);
  regrow_propose(a, s, r, row);
  const int eta = r.rsc[0];
  regrow_pass(a, s, r, start, n, a.weights ? a.weights + start : nullptr,
              [&](int i) { return (int)lidx_s[i]; },
              [&](int i) { return R[i]; });
  __syncthreads();
  if (!regrow_decide(a, s, r, row, s2, t2, K)) return Regrow::kRefused;
  const size_t obs0 = ct * a.N + start;
  for (int i = tid; i < n; i += kThreads) {
    if (bit(r.sub_bits, lidx_s[i])) {
      const int li = regrow_leaf(a, r, eta, start + i);
      lidx_s[i] = (typename LeafCopy<kPad>::T)li;
      a.lidx_out[obs0 + i] = li;
    }
  }
  regrow_accept(s, r);
  return Regrow::kAccepted;
}

// One chain's sweep by one block of its cluster, residual slice on chip.
// Per tree: pass 1 streams the tree's operands through the ring, takes
// the last tree's new fit off the residual (writing that fit out), forms
// the partial residual and the six move statistics; the decision; pass 2
// rewrites the leaf indices and fills the leaf histograms; where the
// tree's regrow gate opens, the regrow (regrow_on_chip); the leaf draw.
// A flush after the last tree applies its fit.  Each thread rounds the
// residual as a separate fit pass would (r - fit, then + old fit), so each
// residual value is the plain sweep's (ops/bart.py:sweep_trees).  smem is
// the dynamic shared memory of on_chip_bytes.  kRegrow: the sweep with the
// regrow step (its state in rs); the kernels instantiate both and launch
// this one only where p_regrow > 0, so the sweep without the move is the
// code it was before the move existed, registers and shared memory alike.
// kPad: the heap slots of the build (LeafCopy, Heads); Real its type.
template <Body kBody, bool kRegrow = false, int kPad = kPadShallow,
          typename Real>
__device__ inline void sweep_on_chip(const SweepArgs<Real>& a,
                                     TreeShared<kPad, Real>& s,
                                     unsigned char* smem, int K,
                                     RegrowShared<kPad>* rs = nullptr) {
  using LeafT = typename LeafCopy<kPad>::T;
  constexpr auto kLeft = LeafCopy<kPad>::kLeft;
  const int N = a.N, T = a.T, M = a.M;
  const int tid = threadIdx.x;
  const int rank = block_rank(K);
  const int c = blockIdx.x / K;
  int start, n;
  obs_range(N, K, rank, start, n);
  const int chunk = obs_chunk(N, K);
  Ring<Real>* ring = reinterpret_cast<Ring<Real>*>(smem);
  Heads<kPad, Real>* heads =
      heap_build(kPad) ? nullptr
                       : reinterpret_cast<Heads<kPad, Real>*>(
                             smem + sizeof(Ring<Real>));
  Real* R = reinterpret_cast<Real*>(smem + sizeof(Ring<Real>)
                                    + heads_bytes<kPad, Real>()); // (chunk,)
  LeafT* lidx_s = reinterpret_cast<LeafT*>(R + chunk);            // (chunk,)
  int* vsel = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(lidx_s)
      + ((chunk * sizeof(LeafT) + 15) & ~15));
  const bool full = kBody == Body::kFull;
  const Real s2 = full ? a.sigma2[c] : Real(0);
  const Real t2 = full ? a.tau2[c] : Real(0);
  const Real* __restrict__ wts = a.weights;
  const bool writer = rank == 0;

  for (int t = tid; t < T; t += kThreads)
    vsel[t] = pick_var(a, a.u[((size_t)c * T + t) * 8 + 3]);
  for (int i = tid; i < n; i += kThreads)
    R[i] = a.resid0[(size_t)c * N + start + i];
  __syncthreads();

  const int nt = max((n + kTile - 1) / kTile, 1);
  TileStream<kPad, Real> ts{&a, ring, full ? heads : nullptr, vsel,
                            (size_t)c * T, start, n, nt, nt * T};
  for (int q = 0; q < kStages - 1; ++q) ts.issue(q);

  for (int t = 0; t < T; ++t) {
    const size_t ct = (size_t)c * T + t;
    // this thread's copies of the tree's rows (the oldest group in
    // flight) have landed; begin_tree's barrier shows them to the block
    cp_async_wait<kStages - 2>();
    TreeRows<Real> rows;
    if constexpr (heap_build(kPad)) {
      rows = global_rows<kPad>(a, ct);
    } else {
      const int h = t % kStages;
      rows = {heads->feat[h], heads->cut[h], heads->u[h], heads->zn[h]};
    }
    // the chain's regrow gate, loaded now and read after pass 2
    const bool regrow = kRegrow && regrow_gate(a, ct);
    Move mv{};
    if constexpr (kBody == Body::kFull) {
      mv = begin_tree(a, s, rows);
    } else {
      // the stubs: the tree's rows copied out
      for (int m = tid; m < M; m += kThreads) {
        if (writer) {
          a.feature_out[ct * M + m] = a.feature_in[ct * M + m];
          a.cut_out[ct * M + m] = a.cut_in[ct * M + m];
          a.lv_out[ct * M + m] = a.lv_in[ct * M + m];
        }
      }
      for (int j = tid; j < 2 * kPad; j += kThreads)
        (&s.hist[0][0])[j] = 0;
      __syncthreads();
    }
    const size_t row = ct * N + start;

    // pass 1: the last tree's new fit taken off the residual (its leaf
    // values in s.lv, its leaf indices in lidx_s), the partial residual
    // and the six move statistics
    Real acc[8] = {Real(0), Real(0), Real(0), Real(0),
                   Real(0), Real(0), Real(0), Real(0)};
    for (int j = 0; j < nt; ++j) {
      const int q = t * nt + j, st = q % kStages;
      ts.issue(q + kStages - 1);
      cp_async_wait<kStages - 1>();
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int e = k * kThreads + tid, i = j * kTile + e;
        if (i < n) {
          const int li = ring->li[st][e];
          const Real tf = ring->tf[st][e];
          if (kBody == Body::kCopy) {
            a.lidx_out[row + i] = li;
            a.tfit_out[row + i] = tf;
            continue;
          }
          Real r = R[i];
          if (t > 0) {
            const Real nf = s.lv[lidx_s[i]];
            a.tfit_out[row - N + i] = nf;
            r = r - nf;
          }
          r = r + tf;
          R[i] = r;
          Real w = wts ? wts[start + i] : Real(1);
          Real wr = wts ? w * r : r;
          if (kBody == Body::kObs) {
            lidx_s[i] = (LeafT)li;
            acc[6] = fmax(acc[6], fabs(wr));
            acc[7] = fmax(acc[7], w);
            continue;
          }
          bool gl = ring->rk[st][e] <= mv.cn;
          lidx_s[i] = (LeafT)(li | (gl ? kLeft : 0));
          add_move_stats(acc, mv, li, gl, w, wr);
        }
      }
    }
    if (kBody == Body::kCopy) continue;
    bool accept = false;
    if (kBody == Body::kFull) {
      accept = decide(a, s, mv, acc, rows, s2, t2, K);
    } else {
      // the obs stub: the histogram scales (and decide's cluster
      // barrier), then this tree's given leaf values
      chain_stats(s, acc, N, K);
      for (int m = tid; m < M; m += kThreads) s.lv[m] = a.lv_in[ct * M + m];
    }

    // pass 2: new leaf indices and per-node leaf statistics, kPer
    // observations per thread at a time
    for (int base = 0; base < n; base += kTile) {
      bool in[kPer];
      int li[kPer];
      Real w[kPer], wr[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = base + k * kThreads + tid;
        in[k] = i < n;
        li[k] = -1;
        w[k] = Real(0);
        wr[k] = Real(0);
        if (in[k]) {
          const int packed = lidx_s[i];
          if (kBody == Body::kFull) {
            li[k] = moved_leaf(mv, accept, packed & (kLeft - 1),
                               (packed & kLeft) != 0);
            lidx_s[i] = (LeafT)li[k];
          } else {
            li[k] = packed;
          }
          a.lidx_out[row + i] = li[k];
          w[k] = wts ? wts[start + i] : Real(1);
          wr[k] = wts ? w[k] * R[i] : R[i];
        }
      }
      hist_add<kPer>(s, in, li, w, wr, wts != nullptr);
    }
    __syncthreads();
    if (kBody == Body::kFull) {
      const Regrow rg = regrow ? regrow_on_chip<kPad>(RegrowArgs<Real>(a), s,
                                                      *rs, ct, start, n,
                                                      lidx_s, R, s2, t2, K)
                               : Regrow::kNone;
      draw_leaves(a, s, ct, rows, s2, t2, K, writer, rg, rs);
    } else {
      // the obs stub keeps the leaf statistics so that nothing is dropped
      gather_hist(s, M, K);
      for (int m = tid; m < M; m += kThreads) {
        Real cnt, sm;
        leaf_sums(s, m, K, cnt, sm);
        if (writer) {
          a.stats_out[(ct * 2) * M + m] = cnt;
          a.stats_out[(ct * 2 + 1) * M + m] = sm;
        }
      }
      __syncthreads();
    }
  }

  // the last tree's new fit, and the final residual
  cp_async_wait<0>();
  const size_t last = ((size_t)c * T + T - 1) * N + start;
  for (int i = tid; i < n; i += kThreads) {
    Real r = R[i];
    if (kBody != Body::kCopy && T > 0) {
      const Real nf = s.lv[lidx_s[i]];
      a.tfit_out[last + i] = nf;
      r = r - nf;
    }
    a.resid_out[(size_t)c * N + start + i] = r;
  }
  // no block leaves while another may still read its shared memory
  if (K > 1) cluster_sync();
}

// The body of an on-chip sweep kernel with heaps of kPad slots and state
// in Real: the sweep with the regrow step (kRegrow, its state in a second
// shared block) or without.  The per-tree state is static up to 512
// slots; at 1024, it takes the head of ``smem`` (state_bytes) and the
// sweep's buffers follow it; a heap build's is its slab of device memory,
// seen through static views (bind_state).
template <bool kRegrow, int kPad, typename Real>
__device__ inline void on_chip_kernel(const SweepArgs<Real>& a, int K,
                                      unsigned char* smem) {
  if constexpr (static_state<kPad>()) {
    __shared__ TreeShared<kPad, Real> s;
    if constexpr (kRegrow) {
      __shared__ RegrowShared<kPad> r;
      bind_state(a, s, &r, K);
      sweep_on_chip<Body::kFull, true, kPad>(a, s, smem, K, &r);
    } else {
      bind_state(a, s, static_cast<RegrowShared<kPad>*>(nullptr), K);
      sweep_on_chip<Body::kFull, false, kPad>(a, s, smem, K);
    }
  } else {
    auto* s = reinterpret_cast<TreeShared<kPad, Real>*>(smem);
    unsigned char* rest = smem + sizeof(TreeShared<kPad, Real>);
    if constexpr (kRegrow) {
      auto* r = reinterpret_cast<RegrowShared<kPad>*>(rest);
      sweep_on_chip<Body::kFull, true, kPad>(
          a, *s, rest + sizeof(RegrowShared<kPad>), K, r);
    } else {
      sweep_on_chip<Body::kFull, false, kPad>(a, *s, rest, K);
    }
  }
}

// Whether a launch runs the sweep with the regrow step.
template <typename Real>
inline bool with_regrow(const SweepArgs<Real>& a) {
  return a.rg != nullptr && a.p_regrow > Real(0);
}

// ``err`` as an int, with the runtime's last error reset: a refused launch
// must not surface again at the next good one.
inline int refused(cudaError_t err) {
  (void)cudaGetLastError();
  return (int)err;
}

// Launches ``kernel(a, K, extra...)`` on C * K blocks of kThreads in
// clusters of K with ``dyn`` bytes of dynamic shared memory; returns the
// CUDA error code, cudaErrorInvalidValue for a K outside 1..8 (the
// portable cluster sizes) or for more shared memory than a block may have,
// and cudaErrorInvalidConfiguration when no cluster of the kernel fits on
// the device.
template <typename Kernel, typename Args, typename... Extra>
inline int launch_clusters(Kernel kernel, const Args& a, int C, int K,
                           size_t dyn, void* stream, Extra... extra) {
  if (K < 1 || K > 8) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return refused(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * K);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return refused(err);
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, a, K, extra...);
  if (err != cudaSuccess) return refused(err);
  return (int)cudaGetLastError();
}

// The C launchers' common head (bart_sweep_batch.cu, bart_sweep_chain.cu,
// bart_sweep_tiled.cu, bart_sweep_sharded.cu): the sweep's operands,
// shapes and constants in the build's real type, the heap slots and the
// heap builds' state slabs (null: a static build), as
// ops/bart_sweep_kernel.py:_operands passes them.
#define SWEEP_HEAD                                                          \
    const int32_t *feature_in, const int32_t *cut_in,                       \
    const int32_t *lidx_in, const BuildReal *tfit_in,                       \
    const BuildReal *resid0, const BuildReal *sigma2,                       \
    const BuildReal *tau2, const BuildReal *u, const BuildReal *zn,         \
    const int32_t *ranks_t, const BuildReal *spcum,                         \
    const BuildReal *psplit, const BuildReal *weights,                      \
    int32_t *feature_out, int32_t *cut_out, BuildReal *lv_out,              \
    int32_t *lidx_out, BuildReal *tfit_out, BuildReal *resid_out, int C,    \
    int T, int N, int P, int M, int max_depth, int n_cuts,                  \
    BuildReal p_grow, BuildReal p_prune, BuildReal trans_grow0,             \
    BuildReal trans_prune0, BuildReal p_regrow, const BuildReal *rg,        \
    int pad, void *heap
// SWEEP_HEAD's operands as the kernels' SweepArgs
#define SWEEP_ARGS                                                          \
  SweepArgs<BuildReal> {                                                    \
    feature_in, cut_in, lidx_in, tfit_in, resid0, sigma2, tau2, u, zn,      \
        ranks_t, spcum, psplit, weights, feature_out, cut_out, lv_out,      \
        lidx_out, tfit_out, resid_out, T, N, P, M, max_depth, n_cuts,       \
        p_grow, p_prune, trans_grow0, trans_prune0, nullptr, nullptr,       \
        p_regrow, rg, static_cast<unsigned char *>(heap), pad               \
  }

// Whether a launcher takes ``pad`` heap slots for M nodes: a heap build
// any power of two from 128 holding M + 1 slots, a static one 128, 512 or
// 1024 holding M + 1.
inline bool pad_ok(int pad, int M, bool heap) {
  const bool pow2 = pad >= kPadShallow && (pad & (pad - 1)) == 0;
  return M + 1 <= pad && (heap ? pow2
                               : pad == kPadShallow || pad == kPadDeep
                                     || pad == kPadDeepest);
}

// A kernel's shared memory per block (static, and the dynamic ``dyn``), the
// device's opt-in limit per block, and how many clusters of K blocks can be
// resident at once; returns the CUDA error code.
template <typename Kernel>
inline int cluster_info(Kernel kernel, int K, size_t dyn,
                        long long* static_b, int* optin, int* clusters) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  *static_b = (long long)attr.sharedSizeBytes;
  *clusters = 0;
  if (attr.sharedSizeBytes + dyn > (size_t)*optin) return 0;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = K;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = dyn;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  return (int)err;
}

}  // namespace s4b
