// Ablation stubs of the single-pass BART sweep for Hopper (sm_90a).
//
// Replaces the TPU kernels in benchmarks/ablate_batch_kernel.py (the
// "copy" and "obs" bodies of its pallas_call), which split the
// chain-blocked sweep's time into a floor, the per-observation work and
// the per-tree node math.  Both stubs here are bart_sweep_batch.cu's
// kernel with its body cut (sweep_on_chip in sweep_cluster.cuh, kBody):
// the same grid of C * K blocks in clusters of K, the same shared memory
// (the ring, the residual slice and the byte copy of the leaf indices)
// and the same streaming of leaf indices, tree fits and cut-rank rows
// through the ring.
//
//   copy  copies the inputs to the outputs (tree rows, leaf values, leaf
//         indices, tree fits) and leaves the residual unchanged;
//   obs   adds the per-observation work without the move or node math:
//         the partial residual, the per-node leaf statistics of the input
//         leaf indices (hist_add and the cluster's fixed-order sum,
//         written to stats_out so that nothing is dropped), the fit lookup
//         lv[leaf_idx] and the residual roll.
//
// full - obs is then the node math (move choice, decision, leaf draw),
// obs - copy the per-observation work and copy the streaming floor.  What
// bounds them: bytes, as the sweep (16 B per observation and tree).

#include "sweep_cluster.cuh"

namespace {

using namespace s4b;

template <Body kBody>
__global__ void __launch_bounds__(kThreads)
bart_sweep_ablate_kernel(SweepArgs a, int K) {
  extern __shared__ float4 smem4[];
  __shared__ TreeShared s;
  sweep_on_chip<kBody>(a, s, reinterpret_cast<unsigned char*>(smem4), K);
}

}  // namespace

// Launches stub ``mode`` (0 copy, 1 obs) over C chains in clusters of K
// blocks on ``stream``; returns the CUDA error code of the launch (0 on
// success).  lv_in (C, T, M) are the leaf values the obs stub looks up,
// stats_out (C, T, 2, M) its per-node leaf statistics (unused by copy).
extern "C" int bart_sweep_ablate_launch(
    int mode, const int32_t* feature_in, const int32_t* cut_in,
    const float* lv_in, const int32_t* lidx_in, const float* tfit_in,
    const float* resid0, const float* u, const int32_t* ranks_t,
    const float* spcum, const float* weights, int32_t* feature_out,
    int32_t* cut_out, float* lv_out, int32_t* lidx_out, float* tfit_out,
    float* resid_out, float* stats_out, int C, int T, int N, int P, int M,
    int K, void* stream) {
  SweepArgs a{};
  a.feature_in = feature_in;
  a.cut_in = cut_in;
  a.lidx_in = lidx_in;
  a.tfit_in = tfit_in;
  a.resid0 = resid0;
  a.u = u;
  a.ranks_t = ranks_t;
  a.spcum = spcum;
  a.weights = weights;
  a.feature_out = feature_out;
  a.cut_out = cut_out;
  a.lv_out = lv_out;
  a.lidx_out = lidx_out;
  a.tfit_out = tfit_out;
  a.resid_out = resid_out;
  a.T = T;
  a.N = N;
  a.P = P;
  a.M = M;
  a.lv_in = lv_in;
  a.stats_out = stats_out;
  const size_t dyn = on_chip_bytes(N, T, K);
  if (mode == 0)
    return launch_clusters(bart_sweep_ablate_kernel<Body::kCopy>, a, C, K,
                           dyn, stream);
  if (mode == 1)
    return launch_clusters(bart_sweep_ablate_kernel<Body::kObs>, a, C, K,
                           dyn, stream);
  return (int)cudaErrorInvalidValue;
}
