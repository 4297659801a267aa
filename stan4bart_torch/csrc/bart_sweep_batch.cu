// Chain-batched BART Gibbs sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel stan4bart_tpu/ops/bart_sweep_kernel.py:
// _sweep_call_batch (body _make_batch_kernel, per-tree math
// _tree_step_math).  One thread block per chain loops over all T trees;
// per tree it makes one grow/prune/change Metropolis-Hastings step from
// six pre-drawn uniforms, draws the conjugate leaf values from pre-drawn
// normals, and updates the tree's leaf indices, its fitted values and
// the running residual.  The kernel draws no random numbers, so it and
// its plain PyTorch version (ops/bart.py:tree_step) consume identical
// variates.  The per-tree steps and their fixed-order sums are in
// sweep_common.cuh, shared with the obs-tiled kernel.
//
// What bounds it: per (chain, tree) it reads leaf_idx, tree_fit and one
// cut-rank row (shared by every chain, so it stays in L2) and writes
// leaf_idx and tree_fit: about 16 bytes of device memory per observation,
// a memory-bound stream.  The design keeps everything else on chip: the
// running residual (4 B per observation) and a byte copy of the tree's
// leaf indices live in shared memory for the whole sweep, so each
// observation's device-memory bytes are touched once per tree.  That
// caps n at what shared memory holds (the wrapper sends n > 10368 to the
// obs-tiled kernel, bart_sweep_tiled.cu).

#include "sweep_common.cuh"

namespace {

using namespace s4b;

__global__ void __launch_bounds__(kThreads)
bart_sweep_batch_kernel(SweepArgs a) {
  extern __shared__ float4 smem4[];
  float* R = reinterpret_cast<float*>(smem4);               // (N,)
  uint8_t* lidx_s = reinterpret_cast<uint8_t*>(R + a.N);    // (N,)
  __shared__ TreeShared s;

  const int N = a.N, T = a.T;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float s2 = a.sigma2[c], t2 = a.tau2[c];

  for (int i = tid; i < N; i += kThreads) R[i] = a.resid0[(size_t)c * N + i];

  for (int t = 0; t < T; ++t) {
    const size_t ct = (size_t)c * T + t;
    const Move mv = begin_tree(a, s, ct);
    const int32_t* li_in = a.lidx_in + ct * N;
    const float* tf_in = a.tfit_in + ct * N;

    // partial residual and the six move statistics
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < N; i += kThreads) {
      int li = li_in[i];
      float r = R[i] + tf_in[i];
      R[i] = r;
      float w = a.weights ? a.weights[i] : 1.0f;
      float wr = a.weights ? w * r : r;
      bool gl = mv.rank_row[i] <= mv.cn;
      lidx_s[i] = (uint8_t)(li | (gl ? 0x80 : 0));
      add_move_stats(acc, mv, li, gl, w, wr);
    }
    const bool accept = decide(a, s, mv, acc, ct, s2, t2);

    // new leaf indices and per-node leaf statistics
    int32_t* li_out = a.lidx_out + ct * N;
    for (int base = 0; base < N; base += kThreads) {
      int i = base + tid;
      bool in = i < N;
      int li = -1;
      float w = 0.0f, wr = 0.0f;
      if (in) {
        int packed = lidx_s[i];
        li = moved_leaf(mv, accept, packed & 0x7f, (packed & 0x80) != 0);
        li_out[i] = li;
        lidx_s[i] = (uint8_t)li;
        w = a.weights ? a.weights[i] : 1.0f;
        wr = a.weights ? w * R[i] : R[i];
      }
      hist_add(s, in, li, w, wr);
    }
    __syncthreads();
    draw_leaves(a, s, ct, s2, t2);

    // the tree's new fit and the residual without it
    float* tf_out = a.tfit_out + ct * N;
    for (int i = tid; i < N; i += kThreads) {
      float nf = s.lv[lidx_s[i]];
      tf_out[i] = nf;
      R[i] = R[i] - nf;
    }
    __syncthreads();
  }

  for (int i = tid; i < N; i += kThreads)
    a.resid_out[(size_t)c * N + i] = R[i];
}

}  // namespace

// Launches one sweep over C chains on ``stream``; returns the CUDA error
// code of the launch (0 on success).
extern "C" int bart_sweep_batch_launch(
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
  size_t dyn = (size_t)N * sizeof(float) + (((size_t)N + 15) & ~(size_t)15);
  cudaError_t err = cudaFuncSetAttribute(
      bart_sweep_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (err != cudaSuccess) return (int)err;
  bart_sweep_batch_kernel<<<C, kThreads, dyn, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
