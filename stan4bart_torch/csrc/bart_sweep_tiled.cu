// Obs-tiled chain-batched BART Gibbs sweep for Hopper (sm_90a): the sweep
// at any number of observations.
//
// Replaces the TPU kernel stan4bart_tpu/ops/bart_sweep_kernel.py:
// _sweep_call_tiled (body _make_tiled_kernel).  It computes what
// bart_sweep_batch.cu computes (the same forest, leaf values, leaf
// indices, tree fits and final residual from the same variates; plain
// version ops/bart.py:sweep_trees), with the running residual in device
// memory instead of shared memory, so n is bounded by device memory:
// one chain's residual at n = 200 000 is 800 KB, more than an SM's
// shared memory.  One thread block per chain loops over the trees; per
// tree it streams the observations in tiles of kTile twice:
//
//   pass A  applies the previous tree's new fit (its leaf values kept in
//           shared memory, its leaf indices read back from lidx_out),
//           writes that fit to tfit_out, rolls the residual to this
//           tree's partial residual and sums the six move statistics;
//           the Metropolis-Hastings decision follows (sweep_common.cuh);
//   pass B  rewrites the leaf indices and sums the per-node leaf
//           statistics; the leaf draw follows.
//
// A flush pass after the last tree applies its fit and leaves the final
// residual in resid_out, which serves as the running residual
// throughout.  Each thread owns the observations tid + j * kThreads in
// both passes, which is the order of bart_sweep_batch.cu's loops, so the
// two kernels take every sum in the same order and give bit-identical
// results where both run.
//
// What bounds it: bytes.  Per (chain, tree) the sweep must read leaf_idx
// and tree_fit and write both (16 B per observation).  This design moves
// 36 B: pass A reads the previous tree's leaf indices, the residual, the
// tree fit and the leaf indices and writes the previous fit and the
// residual; pass B reads the leaf indices and the residual again and
// writes the new leaf indices.  The cut-rank row and the weights are
// shared by every chain and stay in L2.  Within a tile each thread
// issues all kPer loads of a pass before it uses them, so a block keeps
// several loads in flight; with one block per chain a fit of few chains
// fills few SMs (more blocks per chain is later work).

#include "sweep_common.cuh"

namespace {

using namespace s4b;

constexpr int kPer = 8;                   // observations per thread per tile
constexpr int kTile = kThreads * kPer;    // observations per tile

__global__ void __launch_bounds__(kThreads)
bart_sweep_tiled_kernel(SweepArgs a) {
  __shared__ TreeShared s;

  const int N = a.N, T = a.T;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float s2 = a.sigma2[c], t2 = a.tau2[c];
  const float* __restrict__ R0 = a.resid0 + (size_t)c * N;
  float* __restrict__ R = a.resid_out + (size_t)c * N;
  const float* __restrict__ wts = a.weights;

  for (int t = 0; t <= T; ++t) {
    const bool flush = t == T;
    const size_t ct = (size_t)c * T + t;
    Move mv{};
    if (!flush) mv = begin_tree(a, s, ct);
    // the previous tree's new leaf indices and its fit (t > 0)
    const int32_t* __restrict__ li_prev =
        t > 0 ? a.lidx_out + (ct - 1) * N : nullptr;
    float* __restrict__ tf_prev = t > 0 ? a.tfit_out + (ct - 1) * N : nullptr;
    const int32_t* __restrict__ li_in = flush ? nullptr : a.lidx_in + ct * N;
    const float* __restrict__ tf_in = flush ? nullptr : a.tfit_in + ct * N;
    const int32_t* __restrict__ rank_row = mv.rank_row;

    // pass A: apply tree t-1's fit, roll the residual, move statistics
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int base = 0; base < N; base += kTile) {
      float rv[kPer], tfv[kPer];
      int lpv[kPer], liv[kPer], rkv[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = base + k * kThreads + tid;
        if (i < N) {
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
      for (int k = 0; k < kPer; ++k) {
        const int i = base + k * kThreads + tid;
        if (i < N) {
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
    const bool accept = decide(a, s, mv, acc, ct, s2, t2);

    // pass B: new leaf indices and per-node leaf statistics
    int32_t* __restrict__ li_out = a.lidx_out + ct * N;
    for (int base = 0; base < N; base += kTile) {
      float rv[kPer];
      int liv[kPer], rkv[kPer];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = base + k * kThreads + tid;
        if (i < N) {
          rv[k] = R[i];
          liv[k] = li_in[i];
          rkv[k] = rank_row[i];
        }
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int i = base + k * kThreads + tid;
        const bool in = i < N;
        int li = -1;
        float w = 0.0f, wr = 0.0f;
        if (in) {
          li = moved_leaf(mv, accept, liv[k], rkv[k] <= mv.cn);
          li_out[i] = li;
          w = wts ? wts[i] : 1.0f;
          wr = wts ? w * rv[k] : rv[k];
        }
        hist_add(s, in, li, w, wr);
      }
    }
    __syncthreads();
    draw_leaves(a, s, ct, s2, t2);
  }
}

}  // namespace

// Launches one sweep over C chains on ``stream``; returns the CUDA error
// code of the launch (0 on success).  resid_out doubles as the running
// residual and holds the final one when the kernel ends.
extern "C" int bart_sweep_tiled_launch(
    const int32_t* feature_in, const int32_t* cut_in, const int32_t* lidx_in,
    const float* tfit_in, const float* resid0, const float* sigma2,
    const float* tau2, const float* u, const float* zn,
    const int32_t* ranks_t, const float* spcum, const float* psplit,
    const float* weights, int32_t* feature_out, int32_t* cut_out,
    float* lv_out, int32_t* lidx_out, float* tfit_out, float* resid_out,
    int C, int T, int N, int P, int M, int max_depth, int n_cuts,
    float p_grow, float p_prune, float trans_grow0, float trans_prune0,
    void* stream) {
  SweepArgs a{feature_in, cut_in, lidx_in, tfit_in, resid0, sigma2, tau2,
              u, zn, ranks_t, spcum, psplit, weights, feature_out, cut_out,
              lv_out, lidx_out, tfit_out, resid_out, T, N, P, M, max_depth,
              n_cuts, p_grow, p_prune, trans_grow0, trans_prune0};
  bart_sweep_tiled_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
