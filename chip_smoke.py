"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 1,2,4  # build + the kernel phases only

Builds the port's five CUDA kernel sources from ``stan4bart_torch/csrc``
with nvcc, and the four sweep sources again as their float64 builds (one
process per library, nine started together, each build's seconds
printed), then:

1. holds every sweep kernel against their plain PyTorch version at small
   sizes (20 trees, 16 chains, 3 chained sweeps, unweighted, weighted and
   a probit-style target), at n = 2000 and at n = 9191, which is not a
   multiple of any tile: the single-pass, obs-tiled and per-chain
   kernels at every cluster size K = 1, 2, 4, 8 (blocks per chain);
   identical forests, leaf values and fits within float32 tolerance; the
   three equal to the bit at every K;
2. does the same at the bench shape (n = 10000, 75 trees, 9 BART
   variables, 256 chains, one sweep from a prior-drawn forest), prints
   each kernel's K and shared memory per block and times the kernels and
   the plain version with CUDA events; then holds the ablation stubs of
   the single-pass kernel (copy, obs) against their plain versions and
   times copy, obs and the full kernel at 256 and at 64 chains; and
   holds the single-pass and per-chain kernels at 128 chains, the shape
   of phases 6-9's fits, at the K they pick there;
3. runs the single-pass kernel's main path: ``stan4bart_torch.stan4bart``
   on the flagship Friedman model at n = 10000 with 256 chains on the card
   (150 iterations, 75 of them warmup), checks that every sweep went
   through that kernel, that the draws are finite and that the fit passes
   every gate of the reference's continuous e2e test but its held-out
   RMSE (``gaussian_gates``: cor(indiv.bart / fixef / ranef, truth),
   sigma, SATE, the ppd noise ratio, Sigma, the fixef names and values,
   the divergences), and prints the K it used;
4. holds the obs-tiled kernel, at its default K and at K = 1 (residual in
   device memory), against the plain version at the reference's large-n
   shapes (n = 50000 with 64 chains, n = 200000 with 16 chains; 75
   trees, 9 variables) and times them; at n = 50000 and at the per-chain
   kernel's limit, n = 51840 (64 chains), also the per-chain kernel at
   its K, against the plain version and to the bit against the obs-tiled
   one at the same K, with its K and shared memory per block, and at
   n = 50000 its time at every K = 2..8 (K = 1 does not fit on chip);
   and the obs-tiled kernel at n = 50000 with 32 chains, phase 5's shape,
   at the K it picks there;
5. runs the obs-tiled kernel's main path: the same fit at n = 50000 with
   32 chains, every sweep through the obs-tiled kernel, with the same
   checks.  It runs 225 iterations, 150 of them warmup, so the gates
   read the last 75 draws: at n = 50000 the chains' sigma needs about
   150-225 iterations to come down from its start (the 25-iteration
   blocks it prints show it), and at 150 / 75 the posterior-mean sigma
   misses the gate;
6. runs the per-chain path: the phase 3 fit (at 128 chains) with
   ``keep_fits=False`` and a callback returning every field of each
   draw (its stan row, both BART fits, varcount and k), so every
   iteration is ``GibbsProgram.step`` and every sweep the per-chain
   kernel; no raw draws may be stored, and the gaussian gates run on the
   fit the callback's outputs make; then a short per-chain fit on the card
   (n = 2000, 16 chains, 40 iterations) with the options that path
   serves: a callback beside the raw draws, pooled adaptation of stepsize
   and metric, and the chi(df, scale) hyperprior on k, with its forests
   stored (``keep_trees``): the last stored forest is the swept one,
   ``predict`` over them gives the stored BART fit, ``trees()`` and
   ``print_trees``, and a ``save`` / ``load(device="cuda")`` round trip
   whose ``continue_sampling(10)`` (per-chain kernel) is held against the
   original's; then one short fit per non-default ``offset_type`` with a
   user offset, each finite and with the level interweave off;
7. runs the stored-forest surfaces at full width: a probit fit of the
   phase 3 shape (n = 10000, 128 chains, 150 iterations, 75 warmup) with
   ``keep_trees``, every sweep through the single-pass kernel; the
   reference's binary gates; ``predict`` over the stored forests against
   the in-loop test and train fits (1e-5), with its seconds and the peak
   device memory; ``loo`` / ``waic`` of the probit fit over its last 15
   iterations; ``continue_sampling(10)`` whole and in chunks of 4, each
   with 10 launches of the single-pass kernel and equal to the bit;
8. runs the model and sampler options at full width: the phase 3 fit (at
   128 chains) with ``qr``, centered random effects,
   ``prior_covariance=lkj()``, ``sigma_gibbs``, ``leaf_gibbs = 1``,
   ``leaf_block = 25`` and one subtree regrow per sweep, every sweep
   through the single-pass kernel; the reference's gaussian gates, SATE
   within 1 of the truth, every posterior-mean Sigma positive definite, its
   per-phase seconds beside phase 3's and its peak device memory; then
   short fits at n = 2000 with 16 chains (12 iterations, 6 warmup): one
   per coefficient prior (hs, hs_plus, laplace, lasso, product_normal, and
   R2 with ``qr``; max_treedepth 4), finite; a probit fit with ``leaf_gibbs
   = 2``, ``leaf_block = 5`` and two regrows per sweep; a per-chain fit
   (callback, ``keep_trees``, ``sigma_gibbs``, centered random effects,
   ``leaf_block = 5``, one regrow per sweep) whose ``predict`` gives its
   stored fits and whose ``continue_sampling(10)`` whole equals one in
   chunks of 5 to the bit; and a ``qr`` fit saved, loaded on the card and
   resumed, its last stored betas R_inv times the final state's rotated
   ones before and after (un-rotated once);
9. runs the other algorithms at full width, on phase 3's data and seed (128
   chains), every sweep through the single-pass kernel: ``algorithm="vi"``
   (its "biased high" warning), ``"advi"`` meanfield and fullrank, each
   with the reference's VI gates (cor(indiv.bart, mu_bart) >= 0.95, the
   treatment's fixed effect within 1.5 of 5, sigma below 3), its
   milliseconds per VI update beside phase 3's NUTS milliseconds per
   iteration and its peak device memory; ``"vi"`` on phase 7's probit data
   with the binary gates and, when phase 7 ran, a BART-only probit fit on
   the same data (``y ~ bart(. - g.1 - g.2)``: an empty parametric
   vector) with the binary gates, and the reference's whole deviance
   ladder (phase 7's fit at most the probit IRLS fit's deviance, 1.35 x
   the BART-only fit's and 1.35 x the VI fit's);
   and, when phase 3 ran, ``adjudicate_parametric_smc`` of its fit at 1024
   particles with the reference's gates; then short VI fits at n = 2000
   with 16 chains: one with a callback (the per-chain kernel only), one
   whole against the first iterations of a longer one in chunks and against
   its own ``save`` / ``load`` + resume (to the bit), and one with
   ``sigma_gibbs``.
10. runs the multi-process paths with their ranks as processes on the
   one card (``parallel.mesh.spawn``), joined by gloo over CUDA tensors
   (NCCL refuses two ranks on one card; the backend is printed): a. the
   observation-sharded sweep kernel ``csrc/bart_sweep_sharded.cu`` over 2
   ranks at n = 50 000 (25 000 each) x 64 chains x 75 trees, one sweep
   from a prior-drawn forest on shared variates, against the plain
   sharded sweep (identical forests in every chain, leaf values within
   ``LV_TOL``) and against the obs-tiled kernel over the whole n
   (identical forests in at least 63 chains), the same at phase b's
   shape (n = 10 000 over 2 ranks x 128 chains) at the K and apply blocks
   the kernel picks there, and at world size 1 against the obs-tiled
   kernel; its stats + apply kernels timed with
   CUDA events (median of 7), the sweep with its all-reduces on the host
   clock, the obs-tiled kernel in the same call, and the bound at the
   local n; b. the phase 3 fit at full width on 4 ranks, 2 chain groups
   of 128 chains x ``obs_shards = 2``: every sweep through the sharded
   kernel (its count iterations x trees per rank, no other sweep
   kernel), the gathered draws identical on every rank, the gaussian
   gates and SATE, per-phase seconds and peak memory per rank; c. at
   n = 2 000 x 16 chains x 20 iterations: a 2-rank chain-sharded fit
   equal to the bit, rank by rank, to single-process fits of the same
   chains with the ranks' seeds, and 2-rank obs-sharded fits, in float32
   and in float64 (every tree update a launch of the sharded kernel's
   float64 build), whose first forests equal the unsharded fit's of
   their dtype in all but at most one chain.
11. runs the in-sweep subtree regrow (``bart_args p_regrow``): a. the
   single-pass, obs-tiled and per-chain kernels with p_regrow = 1 against
   the plain sweep on the same (u, zn, rg) variates at the bench shape,
   at phases 6-9's 10 000 x 128 and at phase 5's 50 000 x 32, there also
   the obs-tiled kernel at K = 1, whose residual stays in device memory,
   unweighted and weighted (identical forests and leaf indices in every
   chain), every kernel with every
   regrow gate shut equal to its p_regrow = 0 sweep to the bit, the
   chains whose forests the move changed, and at the bench shape the
   kernels' times at p_regrow 0, 0.25 and 1 with the plain sweep's and
   the bound; b. in phase 10a's two ranks, the sharded kernel with
   p_regrow = 1 against the plain sharded sweep (every chain), with its
   regrow updates and all-reduces per rank, timed; c. the phase 3 fit at
   128 chains with ``bart_args={"p_regrow": 0.25}``, every sweep through
   the single-pass kernel with the move: the gaussian gates and SATE;
   d. ``utils.profiling.profile_phases`` at the bench shape on phase 3's
   final states (n_iter 3, repeats 1), printing ``format_profile``'s
   lines.
12. runs trees deeper than 6 (``bart_args max_depth 8``), whose sweeps
   are the kernels' builds for 512-slot heaps: a. the single-pass,
   obs-tiled and per-chain builds at the bench shape (timed at p_regrow 0
   and 1 with the plain sweep, K, shared memory and the bound at
   M = 511, beside the depth-6 times), at 10 000 x 128 and at 50 000 x 32
   weighted (there also the obs-tiled build at K = 1, residual in device
   memory), each with p_regrow 0 and 1 against the plain sweep in every
   chain and with every regrow gate shut equal to p_regrow 0 to the bit,
   the builds at each shape equal to the bit at the largest K they pick,
   from prior forests (power 0.5) whose deepest node and nodes at depth
   >= 7 are printed; the builds for 1024-slot heaps (max_depth 9) the
   same at 10 000 x 128 and at 30 000 x 32 weighted; in phase 10a's two
   ranks the sharded build against the plain sharded sweep at p_regrow 0
   and 1, timed; b. the phase 3 fit at 128 chains with max_depth 8, every
   sweep a launch of the deep single-pass build: the gaussian gates, SATE
   within 0.1 of the truth, and cor, sigma, SATE, the test frame's RMSE
   against the truth, the share of final-forest nodes at depth >= 7 and
   the sweep seconds beside phase 11c's (the same fit at depth 6 with
   p_regrow 0.25).  12b's fit runs in a process of its own beside phase
   11c's: both are host-bound, so the pair takes the wall time of one,
   and the two compared fits run under the same load.
13. runs float64 state (``dtype=torch.float64``), whose sweeps are the
   kernels' double-precision builds (``<name>_f64``): a. each float64 build
   against the plain float64 sweep on the card on shared variates (drawn in
   float32 and widened, as the wrappers draw them), at p_regrow 0 and 1
   with every gate shut equal to p_regrow 0 to the bit: the single-pass,
   obs-tiled and per-chain builds at the bench shape (timed, with K, shared
   memory and the bound at 24 B an observation and tree, beside phases 2
   and 11a's float32 times), the single-pass and per-chain ones at
   10 000 x 128, the per-chain one at 2000 x 16 and the obs-tiled one at
   20 000 x 8 (20 trees: phase b's small fits), the obs-tiled and per-chain
   ones at 50 000 x 32 weighted with the obs-tiled one also at K = 1
   streamed, the 512-slot builds at max_depth 8 (10 000 x 128) and the
   1024-slot obs-tiled and per-chain builds at max_depth 9; in phase 10a's
   two ranks the sharded float64 build against the plain float64 sharded
   sweep, timed; identical forests and leaf indices in all chains but at
   most one (the plain sweep's sums on the card are atomics), values within
   1e-9, and the builds at each shape equal to the bit at the largest K
   they pick (a build that picks a smaller one runs again at it, as in
   phase 12a); b. the phase 3 fit at 128 chains with
   ``dtype=torch.float64``, every sweep a launch of the float64 single-pass
   build: the gaussian gates, SATE within 1, Sigma positive definite, and
   cor, sigma, SATE, the test-frame RMSE and the sweep seconds beside phase
   11c's float32 fit; then a float64 fit at n = 2000 x 16 chains on the
   per-chain path (a callback) saved, loaded on the card and resumed (the
   loaded fit's ``continue_sampling(10)``, whole and in chunks of 4, equal
   to the bit to the original's), and a short float64 fit at n = 20 000
   through the obs-tiled build.  13b runs in a process of its own beside
   11c's fit, as 12b does.
14. runs trees of max_depth 10 and deeper, whose sweeps are the kernels'
   heap builds (per-tree state in device memory, the heap size a run-time
   argument): a. each heap build against the plain sweep on the card at
   p_regrow 0 and 1 (``kernels_at_shape``: all chains but at most one
   identical, the builds at each shape equal to the bit at the largest K
   they pick, every gate shut equal to p_regrow 0 to the bit), from prior
   forests (base 0.99, power 0.25 at depth 10; power 0.1 at 12 and 15)
   that reach the depth: float32 at the bench shape at max_depth 10
   (timed with the bound at M = 2047) beside the 1024-slot static builds
   at max_depth 9 (timed, bound at M = 1023), float32 and float64 at
   max_depth 12 and float64 at 10 at 10 000 x 64 chains x 20 trees,
   weighted, the obs-tiled build at K = 1 with its residual in device
   memory at 40 000 x 16 in both types, the four-byte leaf copy at
   max_depth 15 (2000 x 4 x 10 trees), each heap build forced at max_depth
   9 equal to the bit to the 1024-slot static build, the single-pass heap
   build timed at 10 000 x 128 chains x 75 trees at max_depth 10, 12 and
   14 under b's prior, and in phase 10a's two ranks the sharded heap
   build at max_depth 10 in float32 (timed) and 12 in float64; b. the phase 3 fit at 128 chains with max_depth 12
   and base 0.99, power 0.25, every sweep a launch of the single-pass heap
   build: the gaussian gates, SATE within 1, Sigma positive definite,
   nodes at depth >= 10 in the final forests (the deepest and their share
   printed) and cor, sigma, SATE, RMSE and sweep seconds beside 11c's;
   then a max_depth 12 fit at 2000 x 16 on the per-chain path saved,
   loaded on the card and resumed (equal to the bit, whole and in chunks
   of 4) and a short max_depth 10 fit at 40 000 x 8 through the obs-tiled
   heap build.  14b runs in a process of its own beside 11c's fit, as 12b
   and 13b do.
15. runs simulation-based calibration of the composed sampler
   (``stan4bart_torch.utils.sbc``, the counterpart of benchmarks/sbc.py)
   at SBC_r05.json's size: 160 reps as one program of 160 chains, each
   chain fitting its own response simulated from the prior (n = 100, 8
   trees of max_depth 3), warmup 300 and 495 iterations thinned by 5
   (L = 99), seed 20260819; first each kernel the cells sweep through
   against the plain sweep at that shape, and the CUDA graph of the Gram
   log-density's value and gradient (``GramGraph``, which NUTS replays on
   the card in every fit) against its eager form at each cell's shape,
   equal to the bit (``graph_check`` holds it so at the first and final
   states of phases 3, 5, 7 and 13b's fits and of phase 8's prior fits);
   then every sweep of a cell a
   launch of its kernel, its ranks' chi-square p and counts per quantity
   printed (a p under 1e-3, the artifact's alpha, marked).  a. (in the
   default run, in two processes of their own beside phases 3 and 5 to
   9, after phase 4, which runs before phase 3)
   cells ``kernel_f32`` and ``kernel_f32_probit`` through the single-pass
   kernel, every p above 1e-4 (tests/test_sbc.py:28-41's gate); b. (not
   in the default run; ``--sbc-cells`` chooses; the cells run side by
   side, in up to two processes fewer than the host's cores)
   ``kernel_f32_tiled`` through the forced
   obs-tiled kernel, ``kernel_f32/chain`` through the per-chain driver
   and kernel, and the seven float64 cells through the single-pass
   kernel's double build, written to ``--sbc-out`` (SBC_r05.json's schema
   with the card's name and power limit, beside the cells
   SBC_torch_h100.json holds); a p at most 1e-4 fails it after writing.
16. runs the statistical-quality and causal-study harnesses at their
   budgets through the user entry point, every sweep of every fit a
   launch of the single-pass kernel: a. (in the default run, a process
   each beside phases 3 and 5 to 9) ``utils.quality``'s weighted
   gaussian gates (benchmarks/quality_chip.py's, n = 250, 50 trees, 3
   chains x 1000 iterations, noise sd 1 / sqrt(w), every launch the
   weighted path) and the held-out RMSE gate (tests/test_e2e_continuous.py
   :147-189: 220 rows to fit, 80 held out, BART's RMSE at most least
   squares'); b. (not in the default run; its jobs side by side in up to
   two processes fewer than the host's cores) the plain and interweave
   gaussian gates, the probit gates at n = 10 000 (8 chains, 400 / 900)
   and ``utils.ihdp_study``'s synthetic study at 50 replications of 1000
   iterations, written to ``--quality-out`` and ``--ihdp-out`` with the
   card's name and power limit, the study held to the JAX package's
   (IHDP_synthetic_jax_cpu.json: coverage, paired satt_est, PEHE); a
   failed gate fails either, b after writing; ``--jobs16b`` runs a part
   of b's jobs, written beside the records of earlier runs that the
   root's QUALITY_torch_h100.json and IHDP_synthetic_torch_h100.json hold.

Phase 4 runs before phase 3.  Phase 6's fit runs in a process of its
own beside phase 5's, phase 8's beside phase 7's and phase 15a's two
cells and phase 16a's fits beside phases 3 and 5 to 9; the
short option fits of phases 6, 8 and 9 run
after phase 10a, in this process beside phase 10b's ranks (processes of
their own), and phase 12b's, 13b's and 14b's fits run in processes of
their own beside phase 11c's: the fits are host-bound, so each group
takes about the wall time of the longest, and the per-phase seconds of
5-8, 10b, 11c, 12b, 13b and 14b are taken under that load.

``--phases 3,7,9`` runs the listed phases only (``--phases
1,2,4,10a,11a,11b,12a,13a,14a`` the kernel phases; the kernels line needs
those; ``10a`` to ``10c``, ``11a`` to ``11d``, ``12a``, ``12b``,
``13a``, ``13b``, ``14a``, ``14b``, ``15a``, ``15b``, ``16a`` and ``16b``
run one part of phase 10, 11, 12, 13, 14, 15 or 16; the default runs
every phase but 15b and 16b).
Prints the
card
(``nvidia-smi``), a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero.  Needs no network; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import replace
import sys
import threading
import time

import numpy as np
import torch

from stan4bart_torch.utils.device import card
from stan4bart_torch.utils.quality import centered_cor

# leaf values and fits of kernel vs plain: the same float32 arithmetic
# with the sums taken in another order (tolerances of the JAX package's
# own kernel-vs-XLA parity test)
LV_TOL = dict(rtol=2e-4, atol=2e-5)
FIT_TOL = dict(rtol=5e-4, atol=5e-4)
# the obs stub's per-node sums of up to 10^4 residuals of magnitude up to
# ~20, summed in another order: float32 rounding of up to ~n eps max|r|
STATS_TOL = dict(rtol=5e-4, atol=1e-2)
# float64 sweeps, kernel vs plain (phase 13): the same double arithmetic
# with the sums taken in another order (the kernels' fixed-point sums
# round each value to about 2^-48 of the chain's largest magnitude)
F64_TOL = dict(rtol=0.0, atol=1e-9)
# HBM rate of the H100 SXM (NVIDIA data sheet) for the memory bound
HBM_BYTES_PER_S = 3.35e12
P = 9
KERNELS = ("bart_sweep_batch", "bart_sweep_tiled", "bart_sweep_chain",
           "bart_sweep_ablate", "bart_sweep_sharded")
# the double-precision builds of the sweep sources (phase 13), built
# beside the float32 ones (ops/cuda_build.py)
F64_KERNELS = tuple(f"{k}_f64" for k in KERNELS if k != "bart_sweep_ablate")
# phase 10's ranks share the card; NCCL refuses two ranks on one card
RANK_BACKEND = "gloo"

FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")


def forest_setup(n, trees, chains, seed, device, dtype=torch.float32,
                 **cfg_kw):
    """Friedman-like data, its cut ranks, and a prior-drawn forest, in
    ``dtype`` (``cfg_kw``: BartConfig fields other than the trees, e.g.
    phase 12's ``DEEP``)."""
    from stan4bart_torch.ops import bart as ops
    from stan4bart_torch.ops.bart_sweep_kernel import make_sweep_consts

    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, P))
    y = (10 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 20 * (X[:, 2] - .5) ** 2
         + 5 * X[:, 4] + rng.normal(size=n))
    cfg = ops.BartConfig(num_trees=trees, **cfg_kw)
    ranks = ops.compute_ranks(X, ops.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = ops.sample_trees_from_prior(
        cfg, gen, torch.as_tensor(ranks, device=device), sp, chains,
        dtype=dtype)
    consts = make_sweep_consts(cfg, ranks, sp, device=device, dtype=dtype)
    yt = torch.as_tensor(y - y.mean(), dtype=dtype, device=device)
    return cfg, state, yt, consts, gen


def compare(name, sk, sp_, vk, vp):
    """Per-chain structural identity and value agreement of two sweeps
    (float64 ones within ``F64_TOL``)."""
    same = ((sk.feature == sp_.feature).flatten(1).all(1)
            & (sk.cut == sp_.cut).flatten(1).all(1)
            & (sk.leaf_idx == sp_.leaf_idx).flatten(1).all(1)
            & (vk == vp).all(1))
    ok = same.nonzero()[:, 0]
    err = 0.0
    f64 = sk.leaf_value.dtype == torch.float64
    lv_tol, fit_tol = (F64_TOL, F64_TOL) if f64 else (LV_TOL, FIT_TOL)
    if len(ok):
        err = max(float((sk.leaf_value[ok] - sp_.leaf_value[ok]).abs().max()),
                  float((sk.allfit[ok] - sp_.allfit[ok]).abs().max()),
                  float((sk.tree_fit[ok] - sp_.tree_fit[ok]).abs().max()))
        torch.testing.assert_close(sk.leaf_value[ok], sp_.leaf_value[ok],
                                   **lv_tol, msg=f"{name}: leaf values")
        torch.testing.assert_close(sk.allfit[ok], sp_.allfit[ok], **fit_tol,
                                   msg=f"{name}: allfit")
        torch.testing.assert_close(sk.tree_fit[ok], sp_.tree_fit[ok],
                                   **fit_tol, msg=f"{name}: tree_fit")
    return int(same.sum()), err


def as_state(state, out, target):
    """The BartState of a sweep's raw outputs (feature, cut, leaf_value,
    leaf_idx, tree_fit, resid)."""
    return state._replace(feature=out[0], cut=out[1], leaf_value=out[2],
                          leaf_idx=out[3], tree_fit=out[4],
                          allfit=target - out[5])


def bit_equal(a, b):
    """Whether two sweeps' states are equal to the bit."""
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("feature", "cut", "leaf_value", "leaf_idx",
                         "tree_fit", "allfit"))


def phase_small(device, n):
    """The three kernels (through their wrappers) vs plain at every
    cluster size K, 3 chained sweeps per case; to the bit: the three at
    equal K.  Returns the max |kernel - plain| of each kernel."""
    from stan4bart_torch.ops import bart as ops
    from stan4bart_torch.ops.bart_sweep_kernel import (
        CLUSTERS, bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled, sweep_plain)

    C = 16
    cfg, state, yt, consts, gen = forest_setup(n, 20, C, 1, device)
    wts = torch.as_tensor(np.random.default_rng(2).uniform(0.5, 2.0, n),
                          dtype=torch.float32, device=device)
    y_probit = ops.sample_probit_latents(
        torch.zeros((C, n), device=device), (yt > 0).float(), gen)
    cases = {"unweighted": (yt.expand(C, n), None),
             "weighted": (yt.expand(C, n), wts),
             "probit": (y_probit, None)}
    err = {"batch": 0.0, "tiled": 0.0, "chain": 0.0}
    for case, (target, w) in cases.items():
        sigma = torch.full((C,), 1.0 if case == "probit" else 0.9,
                           device=device)
        runs = {"plain": state}
        runs.update({(kind, K): state for kind in ("batch", "tiled", "chain")
                     for K in CLUSTERS})
        for sweep in range(3):
            var = ops.draw_variates(gen, C, cfg.num_trees, torch.float32,
                                    device)
            vc = {}
            for key, st in runs.items():
                kw = dict(weights=w, variates=var)
                if key == "plain":
                    # the plain version on the same card and inputs
                    out = sweep_plain(
                        cfg, st.feature, st.cut, st.leaf_idx, st.tree_fit,
                        (target - st.allfit).contiguous(), sigma * sigma,
                        st.sigma_mu * st.sigma_mu, var[0], var[1], consts,
                        weights=w)
                    runs[key] = as_state(st, out, target)
                    vc[key] = ops.count_variable_use(out[0], P)
                else:
                    fn = {"batch": bart_sweep_fused_batch,
                          "tiled": bart_sweep_fused_batch_tiled,
                          "chain": bart_sweep_fused}[key[0]]
                    runs[key], vc[key] = fn(cfg, st, target, consts, sigma,
                                            None, cluster=key[1], **kw)
            tag = f"phase 1 n={n} {case} sweep {sweep}"
            for key in runs:
                if key == "plain":
                    continue
                n_same, e = compare(f"{tag}: {key} vs plain", runs[key],
                                    runs["plain"], vc[key], vc["plain"])
                if n_same != C:
                    raise AssertionError(f"{tag}: {key} vs plain: "
                                         f"{C - n_same} of {C} chains differ")
                err[key[0]] = max(err[key[0]], e)
            pairs = [((kind, K), ("batch", K)) for K in CLUSTERS
                     for kind in ("tiled", "chain")]
            for a, b in pairs:
                if not bit_equal(runs[a], runs[b]):
                    raise AssertionError(f"{tag}: {a} and {b} not equal to "
                                         "the bit")
        print(f"phase 1 n={n} {case}: 3 sweeps, {C}/{C} chains identical "
              f"(batch, tiled and chain at K = {CLUSTERS} vs plain; tiled "
              "and chain equal to batch to the bit at every K), internal "
              f"nodes {int((runs[('tiled', 1)].feature >= 0).sum())}",
              flush=True)
    print(f"phase 1 n={n} ok: max |batch - plain| {err['batch']:.3g}, "
          f"|tiled - plain| {err['tiled']:.3g}, |chain - plain| "
          f"{err['chain']:.3g} (leaf values rtol {LV_TOL['rtol']} atol "
          f"{LV_TOL['atol']}, fits rtol {FIT_TOL['rtol']} atol "
          f"{FIT_TOL['atol']})", flush=True)
    return err["batch"], err["tiled"], err["chain"]


def _time(fn, reps):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), times


def copy_bandwidth(device, nbytes=2 ** 30, reps=5):
    """Bytes per second this card moves in a device-to-device copy of
    ``nbytes`` (each byte read once and written once)."""
    src = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    ms, _ = _time(lambda: dst.copy_(src), reps)
    return 2 * nbytes / (ms * 1e-3)


def sweep_bytes(C, T, N, M, pad=128, dtype=torch.float32):
    """Bytes one sweep must move: per (chain, tree) leaf_idx and tree_fit
    read and written (16 B per observation; 24 B with float64 tree
    fits), the ranks table, the residual in and out, the tree rows and
    the variates (``pad`` leaf normals a tree), every real in ``dtype``."""
    b = dtype.itemsize
    return (C * T * N * (8 + 2 * b) + P * N * 4 + C * N * 2 * b
            + C * T * (M * 4 * 2 + M * (8 + b) + 8 * b + pad * b))


def sweep_args(N, T, C, seed, device, dtype=torch.float32, **cfg_kw):
    """One sweep's kernel operands from a prior-drawn forest, in
    ``dtype`` (the variates drawn in float32 and widened, as the
    wrappers draw them)."""
    from stan4bart_torch.ops import bart as ops

    cfg, state, yt, consts, gen = forest_setup(N, T, C, seed, device, dtype,
                                               **cfg_kw)
    state = state._replace(sigma_mu=torch.full((C,), 0.5 / (2 * np.sqrt(T)),
                                               dtype=dtype, device=device))
    var = ops.draw_variates(gen, C, T, torch.float32, device,
                            consts.node_pad)
    args = (cfg, state.feature, state.cut, state.leaf_idx, state.tree_fit,
            (yt - state.allfit).contiguous(),
            torch.full((C,), 1.0, dtype=dtype, device=device),
            (state.sigma_mu ** 2).contiguous(),
            var[0].to(dtype).contiguous(), var[1].to(dtype).contiguous(),
            consts)
    return cfg, state, yt, args


def check_sweep(name, outs, state, yt, C, N, T, min_same):
    """Hold each of ``outs`` (label -> raw outputs) against ``plain``."""
    from stan4bart_torch.ops.bart import count_variable_use

    ref = as_state(state, outs["plain"], yt)
    vref = count_variable_use(ref.feature, P)
    res = {}
    for label, out in outs.items():
        if label == "plain":
            continue
        s = as_state(state, out, yt)
        n_same, err = compare(f"{name} {label}", s, ref,
                              count_variable_use(s.feature, P), vref)
        print(f"{name}: {label} {n_same}/{C} chains identical to the plain "
              f"version (n={N}, trees={T}, P={P}); max |kernel - plain| on "
              f"them {err:.3g}", flush=True)
        if n_same < min_same:
            raise AssertionError(f"{name}: {label} only {n_same}/{C} "
                                 "chains identical")
        res[label] = (n_same, err)
    return res


def smem_note(name, N, T, K, regrow=False, pad=128, dtype=torch.float32):
    """One line on kernel ``name``'s shared memory per block at K (of its
    instantiation with the regrow step when ``regrow``, of its build for
    ``pad`` heap slots and ``dtype``)."""
    from stan4bart_torch.ops.bart_sweep_kernel import kernel_smem

    m = kernel_smem(name, N, T, K, regrow, pad, dtype)
    where = ("in device memory" if not m["resid_on_chip"]
             else "on chip" if m["clusters"] else "slice does not fit")
    return (f"{name}{' float64' if dtype == torch.float64 else ''}"
            f"{' with the regrow' if regrow else ''}"
            f"{f' ({pad}-slot heaps)' if pad != 128 else ''} K={K}: "
            f"{m['static']} B static + {m['dynamic']} B "
            f"dynamic shared memory per block of the {m['optin']} B opt-in "
            f"limit, {m['clusters']} clusters resident at once, residual "
            f"{where}")


def hold_at_path_shape(device, label, N, C, kernels, seed, T=75,
                       dtype=torch.float32, **cfg_kw):
    """Each kernel of ``kernels`` (its name in ``check_sweep``'s lines ->
    (launcher, wrapper)) at a main path's cut shape, at the K its wrapper
    picks there, against the plain version, in ``dtype`` (``cfg_kw``:
    BartConfig fields other than the trees); the largest error per
    name."""
    from stan4bart_torch.ops.bart_sweep_kernel import sweep_plain

    _, state, yt, args = sweep_args(N, T, C, seed, device, dtype, **cfg_kw)
    outs, ks = {}, {}
    for name, (launch, wrapper) in kernels.items():
        outs[name] = launch(*args)
        ks[name] = wrapper.last_cluster
    outs["plain"] = sweep_plain(*args)
    torch.cuda.synchronize()
    res = check_sweep(f"{label} n={N} chains={C}", outs, state, yt, C, N, T,
                      C - 1)
    print(f"{label} n={N} chains={C}: the K each kernel picks at a main "
          "path's shape: " + ", ".join(f"{k} K={v}" for k, v in ks.items()),
          flush=True)
    return {k: v[1] for k, v in res.items()}


def phase_full(device, reps=7, C=256, N=10_000, T=75):
    """The three kernels vs plain at the bench shape, and their times."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled, kernel_smem, sweep_chain_cuda,
        sweep_cuda, sweep_plain, sweep_tiled_cuda)

    cfg, state, yt, args = sweep_args(N, T, C, 3, device)
    outs = {"batch": sweep_cuda(*args), "tiled": sweep_tiled_cuda(*args),
            "chain": sweep_chain_cuda(*args), "plain": sweep_plain(*args)}
    torch.cuda.synchronize()
    kb = bart_sweep_fused_batch.last_cluster
    kt = bart_sweep_fused_batch_tiled.last_cluster
    kc = bart_sweep_fused.last_cluster
    res = check_sweep("phase 2", outs, state, yt, C, N, T, C - 1)
    for label, k in (("tiled", kt), ("chain", kc)):
        same = all(torch.equal(x, y) for x, y in zip(outs["batch"],
                                                     outs[label]))
        print(f"phase 2: {label} (K={k}) and batch (K={kb}) outputs "
              f"bit-identical: {same}", flush=True)
        if not same:
            raise AssertionError(f"phase 2: {label} differs from batch")
    del outs
    # phases 6-9 run their fits at 128 chains, where the K differs
    at128 = hold_at_path_shape(
        device, "phase 2", N, 128,
        {"batch": (sweep_cuda, bart_sweep_fused_batch),
         "chain": (sweep_chain_cuda, bart_sweep_fused)}, seed=6, T=T)

    scan = []
    for k in range(1, 5):     # at least 2048 observations per block
        m = kernel_smem("bart_sweep_batch", N, T, k)
        ms = _time(lambda: sweep_cuda(*args, cluster=k), 3)[0]
        scan.append(f"K={k} {ms:.4f} ms ({m['clusters']} clusters "
                    "resident)")
    print("phase 2: batch kernel by K, median of 3: " + "; ".join(scan),
          flush=True)
    b_ms, b_all = _time(lambda: sweep_cuda(*args), reps)
    t_ms, t_all = _time(lambda: sweep_tiled_cuda(*args), reps)
    c_ms, c_all = _time(lambda: sweep_chain_cuda(*args), reps)
    p_ms, p_all = _time(lambda: sweep_plain(*args), max(5, reps // 2))
    nbytes = sweep_bytes(C, T, N, cfg.max_nodes)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bw = copy_bandwidth(device)
    print(f"phase 2 {smem_note('bart_sweep_batch', N, T, kb)}; "
          f"{smem_note('bart_sweep_tiled', N, T, kt)}; "
          f"{smem_note('bart_sweep_chain', N, T, kc)}", flush=True)
    print(f"phase 2 times over {reps} reps: batch kernel (K={kb}) median "
          f"{b_ms:.4f} ms {[round(t, 4) for t in b_all]}; tiled kernel "
          f"(K={kt}) median {t_ms:.4f} ms {[round(t, 4) for t in t_all]}; "
          f"chain kernel (K={kc}) median {c_ms:.4f} ms "
          f"{[round(t, 4) for t in c_all]}; plain median {p_ms:.4f} ms; "
          f"memory bound {bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s), {nbytes / bw * 1e3:.4f} ms at "
          f"the measured copy rate {bw / 1e12:.3f} TB/s; {card()}",
          flush=True)
    return dict(ms=b_ms, plain_ms=p_ms, bound_ms=bound_ms,
                max_abs_err=max(res["batch"][1], at128["batch"]), cluster=kb,
                tiled_ms=t_ms, tiled_max_abs_err=res["tiled"][1],
                chain_ms=c_ms,
                chain_max_abs_err=max(res["chain"][1], at128["chain"]),
                chain_cluster=kc)


def phase_ablate(device, C, reps=7, N=10_000, T=75):
    """The ablation stubs of the single-pass kernel against their plain
    versions, and the copy, obs and full times at C chains."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        ablate_cuda, ablate_plain, bart_sweep_ablate, bart_sweep_fused_batch,
        sweep_cuda)

    cfg, state, yt, args = sweep_args(N, T, C, 5, device)
    lv = state.leaf_value.contiguous()
    stub = (args[1], args[2], lv, args[3], args[4], args[5])
    u, consts = args[8], args[10]
    err = 0.0
    for mode in ("copy", "obs"):
        k = ablate_cuda(mode, *stub, u, consts)
        p = ablate_plain(mode, *stub)
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(k, p)):
            if x.dtype == torch.int32:
                if not torch.equal(x, y):
                    raise AssertionError(f"ablate {mode}: output {i} differs")
            else:
                torch.testing.assert_close(
                    x, y, **(STATS_TOL if i == 6 else FIT_TOL),
                    msg=f"ablate {mode}: output {i}")
                err = max(err, float((x - y).abs().max()))
    K = bart_sweep_ablate.last_cluster
    ms = {"copy": _time(lambda: ablate_cuda("copy", *stub, u, consts),
                        reps)[0],
          "obs": _time(lambda: ablate_cuda("obs", *stub, u, consts),
                       reps)[0],
          "full": _time(lambda: sweep_cuda(*args), reps)[0]}
    plain_ms = _time(lambda: ablate_plain("obs", *stub), 3)[0]
    if bart_sweep_fused_batch.last_cluster != K:
        raise AssertionError("ablate: stubs and full kernel differ in K")
    bound_ms = sweep_bytes(C, T, N, cfg.max_nodes) / HBM_BYTES_PER_S * 1e3
    print(f"phase 2 ablation C={C} N={N} T={T} K={K}: stubs equal their "
          f"plain versions (max |stub - plain| {err:.3g}); copy "
          f"{ms['copy']:.4f} ms, obs {ms['obs']:.4f} ms, full "
          f"{ms['full']:.4f} ms: node math (full - obs) "
          f"{ms['full'] - ms['obs']:.4f} ms, observation work (obs - copy) "
          f"{ms['obs'] - ms['copy']:.4f} ms, floor (copy) {ms['copy']:.4f} "
          f"ms; bound {bound_ms:.4f} ms; plain obs {plain_ms:.4f} ms; "
          f"{card()}", flush=True)
    return dict(ms, max_abs_err=err, bound_ms=bound_ms, plain_ms=plain_ms,
                cluster=K)


def phase_large(device, N, C, reps=7, T=75):
    """The obs-tiled kernel at its default K and at K = 1, and the
    per-chain one at its K where it runs, vs plain at a large-n shape, and
    their times; the per-chain kernel to the bit against the obs-tiled one
    at the same K, and at n = 50 000 timed at every K it fits."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        MAX_CLUSTER, MAX_N_CHAIN, bart_sweep_fused,
        bart_sweep_fused_batch_tiled, kernel_smem, sweep_chain_cuda,
        sweep_plain, sweep_tiled_cuda)

    chain = N <= MAX_N_CHAIN
    cfg, state, yt, args = sweep_args(N, T, C, 4, device)
    outs = {"tiled": sweep_tiled_cuda(*args)}
    K = bart_sweep_fused_batch_tiled.last_cluster
    outs["tiled K=1"] = sweep_tiled_cuda(*args, cluster=1)
    outs["plain"] = sweep_plain(*args)
    if chain:
        outs["chain"] = sweep_chain_cuda(*args)
        kc = bart_sweep_fused.last_cluster
        tiled_kc = sweep_tiled_cuda(*args, cluster=kc)
    torch.cuda.synchronize()
    res = check_sweep(f"phase 4 n={N}", outs, state, yt, C, N, T, C - 1)
    out = dict(max_abs_err=max(res["tiled"][1], res["tiled K=1"][1]),
               cluster=K)
    print(f"phase 4 n={N} {smem_note('bart_sweep_tiled', N, T, K)}; "
          f"{smem_note('bart_sweep_tiled', N, T, 1)}", flush=True)
    if chain:
        same = all(torch.equal(x, y) for x, y in zip(tiled_kc,
                                                     outs["chain"]))
        print(f"phase 4 n={N}: chain and tiled (K={kc}) outputs "
              f"bit-identical: {same}; "
              f"{smem_note('bart_sweep_chain', N, T, kc)}; "
              f"{smem_note('bart_sweep_chain', N, T, 1)}", flush=True)
        if not same:
            raise AssertionError(f"phase 4 n={N}: chain differs from tiled")
        if kernel_smem("bart_sweep_chain", N, T, 1)["clusters"] == 0:
            # no fallback: a K whose slice does not fit raises
            try:
                sweep_chain_cuda(*args, cluster=1)
            except RuntimeError as e:
                print(f"phase 4 n={N}: chain kernel at K=1 refused: {e}",
                      flush=True)
            else:
                raise AssertionError(f"phase 4 n={N}: chain kernel ran at "
                                     "K=1, whose slice does not fit")
        out.update(chain_max_abs_err=res["chain"][1], chain_cluster=kc)
        del tiled_kc
    del outs
    out["ms"], k_all = _time(lambda: sweep_tiled_cuda(*args), reps)
    out["k1_ms"], k1_all = _time(lambda: sweep_tiled_cuda(*args, cluster=1),
                                 reps)
    msg = (f"phase 4 n={N} chains={C}: tiled kernel (K={K}) median "
           f"{out['ms']:.4f} ms {[round(t, 4) for t in k_all]}; tiled "
           f"kernel (K=1) median {out['k1_ms']:.4f} ms "
           f"{[round(t, 4) for t in k1_all]}")
    if chain:
        out["chain_ms"], c_all = _time(lambda: sweep_chain_cuda(*args), reps)
        msg += (f"; chain kernel (K={kc}) median {out['chain_ms']:.4f} ms "
                f"{[round(t, 4) for t in c_all]}")
        if kc == K:
            msg += (f", {out['chain_ms'] / out['ms']:.4f}x the tiled "
                    "kernel's")
    # the obs-tiled kernel at every cluster size, for the cluster rule
    scan = []
    for k in range(1, MAX_CLUSTER + 1):
        m = kernel_smem("bart_sweep_tiled", N, T, k)
        ms = _time(lambda: sweep_tiled_cuda(*args, cluster=k), 3)[0]
        scan.append(f"K={k} {ms:.4f} ms ({m['clusters']} clusters resident"
                    f"{', residual on chip' if m['resid_on_chip'] else ''})")
    print(f"phase 4 n={N} chains={C}: tiled kernel by K, median of 3: "
          + "; ".join(scan), flush=True)
    if chain and N == 50_000:
        # the per-chain kernel at every K whose slice fits on chip
        scan = []
        for k in range(1, MAX_CLUSTER + 1):
            m = kernel_smem("bart_sweep_chain", N, T, k)
            if m["clusters"] < 1:
                scan.append(f"K={k} does not fit")
                continue
            ms = _time(lambda: sweep_chain_cuda(*args, cluster=k), 3)[0]
            scan.append(f"K={k} {ms:.4f} ms ({m['clusters']} clusters "
                        "resident)")
        print(f"phase 4 n={N} chains={C}: chain kernel by K, median of 3: "
              + "; ".join(scan), flush=True)
    out["plain_ms"], p_all = _time(lambda: sweep_plain(*args),
                                   max(5, reps // 2))
    nbytes = sweep_bytes(C, T, N, cfg.max_nodes)
    out["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{msg}; plain median {out['plain_ms']:.4f} ms "
          f"{[round(t, 4) for t in p_all]}; memory bound "
          f"{out['bound_ms']:.4f} ms ({nbytes / 1e9:.4f} GB at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; {card()}",
          flush=True)
    torch.cuda.empty_cache()
    return out


def launch_counters():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_ablate, bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled, bart_sweep_fused_sharded)

    return {"bart_sweep_batch": bart_sweep_fused_batch,
            "bart_sweep_tiled": bart_sweep_fused_batch_tiled,
            "bart_sweep_chain": bart_sweep_fused,
            "bart_sweep_ablate": bart_sweep_ablate,
            "bart_sweep_sharded": bart_sweep_fused_sharded}


def reset_counts():
    """Every launch count set to 0 (and every count of launches that ran
    the in-sweep regrow, of the deep builds, of the heap builds, of the
    float64 builds and with weights); returns the wrappers by kernel."""
    counts = launch_counters()
    for fn in counts.values():
        fn.launches = 0
        fn.regrow_launches = 0
        fn.deep_launches = 0
        fn.heap_launches = 0
        fn.f64_launches = 0
        fn.weighted_launches = 0
    return counts


def check_launches(label, counts, kernel, expected):
    """``kernel`` launched ``expected`` times since ``reset_counts``, every
    other kernel not at all."""
    launches = {k: fn.launches for k, fn in counts.items()}
    for k, got in launches.items():
        want = expected if k == kernel else 0
        if got != want:
            raise AssertionError(f"{label}: {k} launched {got} times, "
                                 f"expected {want}")
    return launches[kernel]


def run_fit(label, device, n, chains, kernel, iters, warmup, trees,
            binary=False, data=None, formula=FLAGSHIP, **fit_kw):
    """The flagship fit (or ``formula``'s) at full width through the user
    entry point, with the launch counts read just after it: every sweep
    must launch ``kernel`` and no other sweep kernel."""
    import stan4bart_torch
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe, generate_friedman_data)

    d = (data if data is not None else
         generate_friedman_data(n, ranef=True, causal=True, binary=binary))
    df = friedman_dataframe(d)
    counts = reset_counts()
    t0 = time.perf_counter()
    kw = dict(stan_args={"max_treedepth": 6}, bart_args={"n_trees": trees})
    kw.update(fit_kw)
    fit = stan4bart_torch.stan4bart(
        formula, df, treatment="z", chains=chains, iter=iters,
        warmup=warmup, seed=11, verbose=-1, device=device, **kw)
    wall = time.perf_counter() - t0
    launches = check_launches(label, counts, kernel,
                              iters * fit.prog.skip_bart + 1)
    tm = fit.timings
    draws_s = chains * (iters - warmup) / tm["sample"]
    K = getattr(counts[kernel], "last_cluster", None)
    print(f"{label}: stan4bart n={n} chains={chains} trees={trees} "
          f"(sweep kernel {kernel}"
          + ("" if K is None else f", cluster K={K}") + ") "
          f"iter={iters} warmup={warmup}: {wall:.1f} s wall, sampling "
          f"{draws_s:.1f} draws/s; per-phase s: NUTS+linear/level Gibbs "
          f"{tm['nuts_gibbs']:.2f}, sweep {tm['sweep']:.2f}, post "
          f"{tm['post']:.2f}, warmup {tm['warmup']:.2f}, sample "
          f"{tm['sample']:.2f}", flush=True)
    return d, fit, launches


def launch_note(kernel, launches, iters):
    return (f"{kernel} launches {launches} = {iters} iterations + 1 init, "
            "other sweep kernels 0")


def check_gates(label, cor, sigma, kernel, launches, iters):
    print(f"{label} quality: cor(indiv.bart, mu_bart) {cor:.4f} (>= 0.95), "
          f"sigma {sigma:.4f} (0.8 < sigma < 1.4); "
          + launch_note(kernel, launches, iters), flush=True)
    if cor < 0.95 or not 0.8 < sigma < 1.4:
        raise AssertionError(f"{label} quality gates failed")


def gaussian_gates(label, fit, d):
    """Every gate of the reference's continuous e2e test
    (tests/test_e2e_continuous.py:72-138) on a fit of the flagship model
    but the held-out RMSE, which needs a split of its own:
    cor(indiv.bart, mu_bart) >= 0.95, cor(indiv.fixef) >= 0.99,
    cor(indiv.ranef) >= 0.68, 0.8 < sigma < 1.4, SATE within 1 of tau,
    sd(ppd - ev) / sigma within 1.15, Sigma's terms and shapes and its
    posterior mean positive definite, the fixef names and values (X4
    within 3 of 10, z within 1.5 of 5), divergences below 20 % of the
    draws.  Prints them with the seconds the extracts took; raises when
    one fails."""
    t0 = time.perf_counter()
    z = d["z"]
    mu_fx = np.where(z == 1, d["mu_fixef_1"], d["mu_fixef_0"])
    q = dict(
        cor_bart=centered_cor(fit.fitted("indiv.bart"), d["mu_bart"]),
        cor_fixef=centered_cor(fit.fitted("indiv.fixef"), mu_fx),
        cor_ranef=float(np.corrcoef(fit.fitted("indiv.ranef"),
                                    d["mu_ranef"])[0, 1]),
        sigma=float(fit.fitted("sigma")))
    ev = fit.extract("ev")
    q["sate"] = float(np.mean((ev - fit.extract("ev", sample="test"))
                              * (2 * z - 1)[:, None]))
    q["ppd_ratio"] = float((fit.extract("ppd") - ev).std() / q["sigma"])
    del ev
    Sig = fit.extract("Sigma")
    shapes = {k: v.shape[:2] for k, v in Sig.items()}
    q["min_eig"] = float(np.linalg.eigvalsh(Sig["g.1"].mean(-1)).min())
    fx = fit.extract("fixef").mean(-1)
    stan = fit.extract("stan")
    q["divergent"] = float(
        stan[fit.stan_names.index("divergent__")].mean())
    secs = time.perf_counter() - t0
    print(f"{label} gaussian gates over {stan.shape[1]} draws "
          f"(tests/test_e2e_continuous.py:72-138): cor(indiv.bart) "
          f"{q['cor_bart']:.4f} (>= 0.95), cor(indiv.fixef) "
          f"{q['cor_fixef']:.4f} (>= 0.99), cor(indiv.ranef) "
          f"{q['cor_ranef']:.4f} (>= 0.68), sigma {q['sigma']:.4f} (0.8 < "
          f"sigma < 1.4), SATE {q['sate']:.4f} (truth {d['tau']}, within "
          f"1), sd(ppd - ev) / sigma {q['ppd_ratio']:.4f} (within 1.15), "
          f"Sigma {shapes} (g.1 2 x 2, g.2 1 x 1), smallest eigenvalue of "
          f"mean Sigma g.1 {q['min_eig']:.4g} (> 0), fixef "
          f"{fit.mf.X_names} {fx[0]:.4f} (within 3 of 10), {fx[1]:.4f} "
          f"(within 1.5 of 5), divergent {q['divergent']:.4f} (< 0.2); "
          f"the gates' extracts took {secs:.1f} s", flush=True)
    if not (q["cor_bart"] >= 0.95 and q["cor_fixef"] >= 0.99
            and q["cor_ranef"] >= 0.68 and 0.8 < q["sigma"] < 1.4
            and abs(q["sate"] - d["tau"]) < 1.0
            and 1 / 1.15 < q["ppd_ratio"] < 1.15
            and shapes == {"g.1": (2, 2), "g.2": (1, 1)}
            and q["min_eig"] > 0 and fit.mf.X_names == ["X4", "z"]
            and abs(fx[0] - 10.0) < 3.0 and abs(fx[1] - 5.0) < 1.5
            and q["divergent"] < 0.2):
        raise AssertionError(f"{label}: gaussian gates failed")
    return q


def phase_main(device, label, n, chains, kernel, iters=150, warmup=75,
               trees=75):
    """A main path at full width, through the user entry point: every
    sweep must launch ``kernel`` and no other sweep kernel."""
    d, fit, launches = run_fit(label, device, n, chains, kernel, iters,
                               warmup, trees)
    graph_check(label, fit)
    for name in ("stan", "bart_train", "bart_test", "k"):
        arr = getattr(fit.draws, name)
        if not np.all(np.isfinite(arr)):
            raise AssertionError(f"{label}: non-finite {name} draws")
    trace = fit.extract("sigma", combine_chains=False, include_warmup=True)
    blocks = " ".join(f"{b.mean():.3f}/{int((b.mean(0) > 1.4).sum())}"
                      for b in np.split(trace, range(25, iters, 25)))
    stan = fit.extract("stan")
    td = float(stan[fit.stan_names.index("treedepth__")].mean())
    print(f"{label}: mean treedepth {td:.2f}; sigma by 25-iteration block, "
          f"warmup included (mean over chains/chains above 1.4): {blocks}; "
          + launch_note(kernel, launches, iters), flush=True)
    gaussian_gates(label, fit, d)
    return launches, fit


def phase_chain(device, label="phase 6", n=10_000, chains=128, iters=150,
                warmup=75, trees=75):
    """The per-chain path at full width: the phase 3 fit with
    ``keep_fits=False`` and a callback, so every iteration runs
    ``GibbsProgram.step`` and every sweep the per-chain kernel.  The
    callback returns every field of the draw (its stan row, both BART
    fits, varcount and k), and the gaussian gates run on the fit those
    outputs make, as on phase 3's raw draws."""
    from stan4bart_torch.gibbs import GibbsDraw

    def callback(draw):
        return {"stan": draw.stan_pars, "bart_train": draw.yhat_train,
                "bart_test": draw.yhat_test, "varcount": draw.raw.varcount,
                "k": draw.raw.k}

    d, fit, launches = run_fit(label, device, n, chains, "bart_sweep_chain",
                               iters, warmup, trees, keep_fits=False,
                               callback=callback)
    if fit.draws is None or hasattr(fit.draws, "stan"):
        raise AssertionError(f"{label}: raw draws were stored")
    try:
        fit.extract("ev")
    except ValueError:
        pass
    else:
        raise AssertionError(f"{label}: extract('ev') did not raise")
    out = fit.extract("callback")          # post-warmup draws
    yhat = out["bart_train"]
    if yhat.shape != (n, chains * (iters - warmup)) or not all(
            np.all(np.isfinite(a)) for a in out.values()):
        raise AssertionError(f"{label}: callback outputs {yhat.shape}, "
                             "or not finite")
    print(f"{label}: " + launch_note("bart_sweep_chain", launches, iters),
          flush=True)
    gaussian_gates(label, replace(fit, draws=GibbsDraw(**fit.draws),
                                  keep_fits=True), d)
    return launches


def phase_options(device, label="phase 6 options", n=2000, chains=16,
                  iters=40, warmup=20, trees=20):
    """A short per-chain fit on the card with a callback beside the raw
    draws, pooled adaptation of stepsize and metric, k ~ chi(1.25) and
    stored forests: the callback's sigma must equal extract('sigma'), k
    must move, and the chains must share one stepsize and metric after
    warmup; the last stored forest must be the swept one, ``predict``
    over the stored forests must give the stored BART fit (1e-5), and a
    resume of the fit saved and loaded on the card is held against the
    original's.  Returns the per-chain kernel's launches."""
    import os
    import tempfile

    import stan4bart_torch
    from stan4bart_torch.utils.friedman import friedman_dataframe

    def callback(draw):
        return {"sigma": draw["aux.1"]}

    d, fit, launches = run_fit(
        label, device, n, chains, "bart_sweep_chain", iters, warmup, trees,
        callback=callback,
        stan_args={"max_treedepth": 6, "pooled_adaptation": True,
                   "pooled_parts": "both"},
        bart_args={"n_trees": trees, "k": stan4bart_torch.chi(1.25),
                   "keep_trees": True})
    sigma_cb = fit.extract("callback")["sigma"]
    k = fit.extract("k", include_warmup=True)
    nuts = fit.final_states.nuts
    same_eps = bool((nuts.da.log_eps == nuts.da.log_eps[0]).all())
    same_metric = bool((nuts.inv_mass == nuts.inv_mass[:1]).all())
    print(f"{label}: callback sigma equals extract('sigma'): "
          f"{np.array_equal(sigma_cb, fit.extract('sigma'))}; k draws "
          f"{k.min():.4f}-{k.max():.4f}; one stepsize {same_eps} and one "
          f"metric {same_metric} across {chains} chains; {launches} "
          "per-chain launches", flush=True)
    if not (np.array_equal(sigma_cb, fit.extract("sigma"))
            and np.all(np.isfinite(k)) and np.ptp(k) > 0 and same_eps
            and same_metric):
        raise AssertionError(f"{label} failed")

    # the stored forests: the last is the state step swept, and walking
    # them over the training rows gives the stored BART fit
    st = fit.final_states.bart
    last_same = all(
        np.array_equal(getattr(fit.draws, name)[:, -1], t.cpu().numpy())
        for name, t in (("tree_feature", st.feature), ("tree_cut", st.cut),
                        ("tree_leaf_value", st.leaf_value)))
    df = friedman_dataframe(d)
    train_err = float(np.abs(fit.predict(df, type="indiv.bart")
                             - fit.extract("indiv.bart")).max())
    rows = len(fit.trees()["n"])
    fit.print_trees(max_print=2)
    print(f"{label}: last stored forest equals the swept state: "
          f"{last_same}; max |predict(train) - extract('indiv.bart')| "
          f"{train_err:.3g} (<= 1e-5); trees() {rows} rows", flush=True)
    if not (last_same and train_err <= 1e-5 and rows > 0):
        raise AssertionError(f"{label}: stored forests")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.pkl")
        fit.save(path)
        back = stan4bart_torch.Stan4bartFit.load(path, device=device)
    resumed = {}
    for which, f in (("original", fit), ("loaded", back)):
        counts = reset_counts()
        resumed[which] = f.continue_sampling(10)
        launches += check_launches(f"{label} resume of the {which} fit",
                                   counts, "bart_sweep_chain", 10)
    a, b = resumed["original"], resumed["loaded"]
    diff = max(float(np.abs(getattr(a.draws, name).astype(np.float64)
                            - getattr(b.draws, name)).max())
               for name in ("stan", "bart_train", "tree_leaf_value"))
    same_trees = all(np.array_equal(getattr(a.draws, name),
                                    getattr(b.draws, name))
                     for name in ("tree_feature", "tree_cut"))
    finite = all(np.all(np.isfinite(getattr(x.draws, name)))
                 for x in (a, b) for name in ("stan", "bart_train"))
    print(f"{label}: continue_sampling(10) after save / load on the card: "
          f"{b.iterations} iterations, 10 per-chain launches each; max "
          f"|loaded - original| over stan, bart_train and leaf values "
          f"{diff:.3g}, tree structures equal {same_trees}", flush=True)
    if not (a.iterations == b.iterations == fit.iterations + 10
            and finite):
        raise AssertionError(f"{label}: resume after load")
    return launches


def phase_offset_types(device, n=2000, chains=16, trees=20, iters=12,
                       warmup=6):
    """One short fit per non-default offset_type with a user offset taken
    from the generator's components, each through the single-pass
    kernel: finite draws and the level interweave off.  Returns the
    single-pass kernel's launches."""
    from stan4bart_torch.utils.friedman import generate_friedman_data

    d = generate_friedman_data(n, ranef=True, causal=True)
    fixef = np.where(d["z"] == 1, d["mu_fixef_1"], d["mu_fixef_0"])
    offsets = {"fixef": fixef, "ranef": d["mu_ranef"],
               "bart": d["mu_bart"], "parametric": fixef + d["mu_ranef"]}
    launches = 0
    for ot, off in offsets.items():
        label = f"phase 6 offset_type={ot}"
        _, fit, got = run_fit(label, device, n, chains, "bart_sweep_batch",
                              iters, warmup, trees, data=d, offset=off,
                              offset_type=ot)
        launches += got
        finite = all(np.all(np.isfinite(getattr(fit.draws, name)))
                     for name in ("stan", "bart_train", "bart_test", "k"))
        print(f"{label}: finite draws {finite}; level interweave "
              f"{fit.prog.level_gibbs}, linear refresh "
              f"{fit.prog.linear_gibbs}", flush=True)
        if not finite or fit.prog.level_gibbs:
            raise AssertionError(f"{label} failed")
    return launches


def binary_gates(label, fit, d):
    """The reference's probit gates (tests/test_e2e_binary.py:32-105):
    cor(posterior-mean P(y=1), true p) > 0.75, deviance < 0.8 x null,
    ppd in {0, 1} with mean |ppd - ev| < 0.05, and ev = Phi(indiv.bart +
    indiv.fixef + indiv.ranef).  Returns the posterior-mean P(y = 1)."""
    from scipy.special import ndtr      # the standard normal cdf

    ev_draws = fit.extract("ev")
    ev = ev_draws.mean(-1)
    p_true = ndtr(np.where(d["z"] == 1, d["mu_1"], d["mu_0"]))
    cor = float(np.corrcoef(ev, p_true)[0, 1])
    y = d["y"]
    dev = float(-2 * np.sum(y * np.log(ev) + (1 - y) * np.log1p(-ev)))
    p0 = y.mean()
    dev0 = float(-2 * np.sum(y * np.log(p0) + (1 - y) * np.log1p(-p0)))
    ppd = fit.extract("ppd")
    zero_one = bool(np.all((ppd == 0.0) | (ppd == 1.0)))
    ppd_err = float(np.abs(ppd.mean(-1) - ev).mean())
    del ppd
    latent = ndtr(fit.extract("indiv.bart") + fit.extract("indiv.fixef")
                  + fit.extract("indiv.ranef"))
    latent_err = float(np.abs(ev_draws - latent).max())
    print(f"{label} binary gates over {ev_draws.shape[1]} draws: cor(ev, "
          f"true p) {cor:.4f} (> 0.75); deviance {dev:.1f} vs null "
          f"{dev0:.1f} (< 0.8 x); ppd in {{0, 1}} {zero_one}, mean |ppd - "
          f"ev| {ppd_err:.4f} (< 0.05); max |ev - Phi(bart + fixef + "
          f"ranef)| {latent_err:.3g} (<= 1e-6)", flush=True)
    if not (cor > 0.75 and dev < 0.8 * dev0 and zero_one and ppd_err < 0.05
            and latent_err <= 1e-6):
        raise AssertionError(f"{label}: binary gates failed")
    return ev


def phase_probit(device, label="phase 7", n=10_000, chains=128,
                 iters=150, warmup=75, trees=75):
    """The stored-forest surfaces at full width: a probit fit with
    keep_trees through the single-pass kernel, its gates, predict against
    the in-loop fits, loo / waic, and two resumes.  Returns the
    single-pass kernel's launches and the fit's posterior-mean P(y = 1)
    (phase 9's deviance ladder)."""
    from stan4bart_torch.gibbs import tree_map
    from stan4bart_torch.utils.friedman import friedman_dataframe

    d, fit, launches = run_fit(
        label, device, n, chains, "bart_sweep_batch", iters, warmup, trees,
        binary=True, bart_args={"n_trees": trees, "keep_trees": True})
    graph_check(label, fit)
    for name in ("stan", "bart_train", "bart_test", "k", "tree_leaf_value"):
        if not np.all(np.isfinite(getattr(fit.draws, name))):
            raise AssertionError(f"{label}: non-finite {name} draws")
    if fit.draws.tree_feature.shape != (chains, iters, trees, 127):
        raise AssertionError(f"{label}: stored forests "
                             f"{fit.draws.tree_feature.shape}")
    ev = binary_gates(label, fit, d)

    df = friedman_dataframe(d)
    cf = dict(df)
    cf["z"] = 1 - np.asarray(df["z"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred_test = fit.predict(cf, type="indiv.bart")
    pred_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    test_err = float(np.abs(pred_test
                            - fit.extract("indiv.bart", sample="test")).max())
    del pred_test
    train_err = float(np.abs(fit.predict(df, type="indiv.bart")
                             - fit.extract("indiv.bart")).max())
    print(f"{label}: predict over {iters - warmup} x {chains} stored "
          f"forests of {trees} trees on {n} counterfactual rows took "
          f"{pred_s:.2f} s, peak device memory {peak / 2 ** 30:.2f} GiB; max "
          f"|predict - extract('indiv.bart', sample='test')| {test_err:.3g}, "
          f"train {train_err:.3g} (each <= 1e-5); {card()}", flush=True)
    if not (test_err <= 1e-5 and train_err <= 1e-5):
        raise AssertionError(f"{label}: predict differs from the stored fits")

    # loo / waic over the last 15 iterations: the Pareto fits and the
    # log-likelihood run on the host, 75 s of the script for all 75
    # post-warmup iterations of 256 chains
    last = replace(fit, draws=tree_map(lambda a: a[:, -15:], fit.draws),
                   warmup=0)
    ic = {}
    for name, f in (("probit loo", last.loo), ("probit waic", last.waic)):
        t0 = time.perf_counter()
        ic[name] = f()
        ic[name]["seconds"] = time.perf_counter() - t0
    msg = []
    for name, r in ic.items():
        keys = (("elpd_loo", "p_loo", "looic") if "loo" in name
                else ("elpd_waic", "p_waic", "waic"))
        if not all(np.isfinite(r[k]) for k in keys):
            raise AssertionError(f"{label}: {name} not finite")
        msg.append(f"{name} " + ", ".join(f"{k} {r[k]:.2f}" for k in keys)
                   + (f", {r['n_high_k']} of {r['n_obs']} pareto_k > 0.7"
                      if "loo" in name else "")
                   + f", {r['seconds']:.2f} s")
    print(f"{label}: " + "; ".join(msg) + f" (over the last 15 iterations, "
          f"{15 * chains} draws)", flush=True)

    resumed = {}
    for which, kw in (("whole", {}), ("chunked", {"chunk_size": 4})):
        counts = reset_counts()
        t0 = time.perf_counter()
        resumed[which] = fit.continue_sampling(10, **kw)
        secs = time.perf_counter() - t0
        launches += check_launches(f"{label} continue_sampling(10) {which}",
                                   counts, "bart_sweep_batch", 10)
        r = resumed[which]
        grew = all(getattr(r.draws, name).shape[1] == iters + 10
                   for name in ("tree_feature", "tree_cut",
                                "tree_leaf_value", "stan"))
        finite = all(np.all(np.isfinite(getattr(r.draws, name)))
                     for name in ("stan", "bart_train", "bart_test",
                                  "tree_leaf_value"))
        print(f"{label}: continue_sampling(10{', chunk_size=4' if kw else ''}"
              f") took {secs:.2f} s, 10 single-pass launches; "
              f"{r.iterations - r.warmup} post-warmup iterations, forests "
              f"grew by 10 {grew}, finite {finite}", flush=True)
        if not (r.iterations - r.warmup == iters - warmup + 10 and grew
                and finite):
            raise AssertionError(f"{label}: resume {which}")
    diff, same = resume_equal(
        resumed["whole"], resumed["chunked"],
        ("stan", "bart_train", "bart_test", "tree_feature", "tree_cut",
         "tree_leaf_value"))
    print(f"{label}: whole vs chunked resume: max difference over stan "
          f"draws, fits and forests {diff:.3g}, equal to the bit {same}",
          flush=True)
    if not same:
        raise AssertionError(f"{label}: whole and chunked resumes differ")
    return launches, ev


def finite_draws(label, fit, names=("stan", "bart_train", "bart_test", "k")):
    for name in names:
        if not np.all(np.isfinite(getattr(fit.draws, name))):
            raise AssertionError(f"{label}: non-finite {name} draws")


def option_flags(fit):
    """The model and sampler options as the fit resolved them."""
    prog, cfg = fit.prog, fit.pm.cfg
    return (f"qr {fit.R_inv is not None}, centered_ranef {cfg.centered}, "
            f"prior_covariance {('decov', 'lkj')[cfg.cov_prior]}, "
            f"prior_dist {cfg.prior_dist}, sigma_gibbs {prog.sigma_gibbs}, "
            f"leaf_gibbs {prog.leaf_gibbs}, leaf_block {prog.leaf_block} "
            f"(dim {prog.leaf_block_dim}), regrow_per_sweep "
            f"{prog.bart_cfg.regrow_per_sweep}; linear_gibbs "
            f"{prog.linear_gibbs}, level_gibbs {prog.level_gibbs}")


def all_options_stan_args(**extra):
    import stan4bart_torch

    return {"max_treedepth": 6, "qr": True, "centered_ranef": True,
            "prior_covariance": stan4bart_torch.lkj(), "sigma_gibbs": True,
            **extra}


def option_costs(fit, reps=3):
    """Milliseconds of one call of each optional update of ``fit``'s
    program on its final state (median of ``reps``): what each adds to an
    iteration (sigma_gibbs to nuts_gibbs, the regrows to sweep, the leaf
    draws to post)."""
    prog, st = fit.prog, fit.final_states
    gen = torch.Generator(device=prog.device)
    gen.manual_seed(0)
    c, _ = prog.pm.layout.constrain(st.nuts.q)
    sigma = prog.pm.transformed(c, st.nuts.q.shape[0])["aux"]
    calls = {
        "sigma_gibbs": lambda: prog._sigma_gibbs_update(
            st.nuts.q, st.stan_offset, prog.y, gen),
        "regrow (1 per sweep)": lambda: prog._regrow(
            st.bart, prog.y - st.bart_offset, sigma, gen),
        "leaf_gibbs": lambda: prog._leaf_gibbs_update(
            st.bart, st.bart_offset, st.latents, sigma, gen),
        "leaf_block": lambda: prog._leaf_block_update(
            st.bart, st.bart_offset, st.latents, sigma, gen),
    }
    out = {}
    for name, fn in calls.items():
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(times[1:]))
    return out


def phase_all_options(device, t3, label="phase 8", n=10_000, chains=128,
                iters=150, warmup=75, trees=75):
    """Every option at full width: the phase 3 data and seed with
    every model and sampler option of the single-device fit on (qr,
    centered ranef, lkj, sigma_gibbs, leaf_gibbs, leaf_block, subtree
    regrows), every sweep through the single-pass kernel; the
    reference's gaussian gates, SATE within 1 of the truth, Sigma
    positive definite, and the per-phase seconds beside phase 3's
    (``t3``, its timings, when phase 3 ran).  Returns the single-pass
    kernel's launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    d, fit, launches = run_fit(
        label, device, n, chains, "bart_sweep_batch", iters, warmup, trees,
        stan_args=all_options_stan_args(leaf_gibbs=1, leaf_block=25),
        bart_args={"n_trees": trees, "regrow_per_sweep": 1})
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: options: {option_flags(fit)}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; {card()}", flush=True)
    if not (fit.prog.linear_gibbs and fit.prog.level_gibbs
            and fit.prog.sigma_gibbs and fit.R_inv is not None):
        raise AssertionError(f"{label}: an option is off")
    finite_draws(label, fit)
    tm = fit.timings
    if t3 is not None:
        print(f"{label}: per-phase s with the options (phase 3 without, same "
              "call): " + ", ".join(
                  f"{k} {tm[k]:.2f} ({t3[k]:.2f})"
                  for k in ("nuts_gibbs", "sweep", "post", "total")),
              flush=True)
    stan = fit.extract("stan")
    td = float(stan[fit.stan_names.index("treedepth__")].mean())
    nlf = float(stan[fit.stan_names.index("n_leapfrog__")].mean())
    del stan
    print(f"{label}: mean treedepth {td:.2f}, mean leapfrogs {nlf:.1f}; "
          "one call of each option's update on the final state, median of "
          "3 (host clock, synchronized): " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in option_costs(fit).items()),
          flush=True)
    cor = centered_cor(fit.fitted("indiv.bart"), d["mu_bart"])
    sigma = float(fit.fitted("sigma"))
    z = d["z"]
    sate = float(np.mean((fit.fitted("ev") - fit.fitted("ev", sample="test"))
                         * (2 * z - 1)))
    eig = {k: float(np.linalg.eigvalsh(S.mean(-1)).min())
           for k, S in fit.extract("Sigma").items()}
    print(f"{label}: SATE {sate:.4f} (truth {d['tau']}, within 1); smallest "
          "eigenvalue of the posterior-mean Sigma by term: " + ", ".join(
              f"{k} {v:.4g}" for k, v in eig.items()), flush=True)
    check_gates(label, cor, sigma, "bart_sweep_batch", launches, iters)
    if abs(sate - d["tau"]) >= 1.0 or min(eig.values()) <= 0:
        raise AssertionError(f"{label}: SATE or Sigma gate failed")
    return launches


def resume_equal(a, b, names):
    """The largest difference between two fits' draws over ``names``, and
    whether they are equal to the bit."""
    diff = max(float(np.abs(getattr(a.draws, k).astype(np.float64)
                            - getattr(b.draws, k)).max()) for k in names)
    return diff, all(np.array_equal(getattr(a.draws, k), getattr(b.draws, k))
                     for k in names)


def beta_unrotated(fit):
    """The final state's rotated coefficients in the original coordinates,
    R_inv beta_qr, per chain."""
    c, _ = fit.pm.layout.constrain(fit.final_states.nuts.q)
    beta = fit.pm.transformed(
        c, fit.final_states.nuts.q.shape[0])["beta"].double().cpu().numpy()
    return beta @ fit.R_inv.T


def phase_option_fits(device, label="phase 8 options", n=2000, chains=16,
                        trees=20, iters=12, warmup=6):
    """Short fits of the options at the offset-type size: one per
    coefficient prior (R2 with qr), a probit fit with the leaf draws and
    regrows, a per-chain fit with a callback, stored forests and every
    option the per-chain kernel serves (predict equal to the stored fits,
    a resume whole equal to one in chunks to the bit), and a qr fit
    saved, loaded on the card and resumed (its stored betas un-rotated
    once).  Returns the launches by kernel."""
    import os
    import tempfile

    import stan4bart_torch as s4b
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe, generate_friedman_data)

    launches = {"bart_sweep_batch": 0, "bart_sweep_chain": 0}
    d = generate_friedman_data(n, ranef=True, causal=True)
    priors = (("hs", {"prior": s4b.hs()}),
              ("hs_plus", {"prior": s4b.hs_plus()}),
              ("laplace", {"prior": s4b.laplace()}),
              ("lasso", {"prior": s4b.lasso()}),
              ("product_normal", {"prior": s4b.product_normal()}),
              ("R2", {"prior": s4b.R2(0.5, "mean"), "qr": True}))
    for name, sa in priors:
        # these fits are held to finite draws only, so their trajectories
        # are cut to 2^4 leapfrogs to keep the script's time
        sub = f"{label} prior={name}"
        _, fit, got = run_fit(sub, device, n, chains, "bart_sweep_batch",
                              iters, warmup, trees, data=d,
                              stan_args={"max_treedepth": 4, **sa})
        launches["bart_sweep_batch"] += got
        finite_draws(sub, fit)
        graph_check(sub, fit)
        fixef = np.round(fit.fitted("fixef").astype(float), 3).tolist()
        print(f"{sub}: finite draws; posterior-mean fixef {fixef}, sigma "
              f"{float(fit.fitted('sigma')):.4f}; {option_flags(fit)}",
              flush=True)

    sub = f"{label} probit"
    db = generate_friedman_data(n, ranef=True, causal=True, binary=True)
    _, fit, got = run_fit(
        sub, device, n, chains, "bart_sweep_batch", iters, warmup, trees,
        data=db, stan_args={"max_treedepth": 6, "leaf_gibbs": 2,
                            "leaf_block": 5},
        bart_args={"n_trees": trees, "regrow_per_sweep": 2})
    launches["bart_sweep_batch"] += got
    finite_draws(sub, fit)
    print(f"{sub}: finite draws; {option_flags(fit)}", flush=True)
    if fit.prog.sigma_gibbs or fit.prog.leaf_gibbs != 2:
        raise AssertionError(f"{sub}: options")

    sub = f"{label} per-chain"
    _, fit, got = run_fit(
        sub, device, n, chains, "bart_sweep_chain", iters, warmup, trees,
        data=d, callback=lambda draw: {"sigma": draw["aux.1"]},
        stan_args={"max_treedepth": 6, "sigma_gibbs": True,
                   "centered_ranef": True, "leaf_block": 5},
        bart_args={"n_trees": trees, "keep_trees": True,
                   "regrow_per_sweep": 1})
    launches["bart_sweep_chain"] += got
    finite_draws(sub, fit, ("stan", "bart_train", "bart_test",
                            "tree_leaf_value"))
    df = friedman_dataframe(d)
    train_err = float(np.abs(fit.predict(df, type="indiv.bart")
                             - fit.extract("indiv.bart")).max())
    resumed = {}
    for which, kw in (("whole", {}), ("chunked", {"chunk_size": 5})):
        counts = reset_counts()
        resumed[which] = fit.continue_sampling(10, **kw)
        launches["bart_sweep_chain"] += check_launches(
            f"{sub} resume {which}", counts, "bart_sweep_chain", 10)
    names = ("stan", "bart_train", "bart_test", "tree_feature", "tree_cut",
             "tree_leaf_value")
    diff, same = resume_equal(resumed["whole"], resumed["chunked"], names)
    print(f"{sub}: {option_flags(fit)}; max |predict(train) - "
          f"extract('indiv.bart')| {train_err:.3g} (<= 1e-5); "
          f"continue_sampling(10) whole vs chunk_size=5: max difference "
          f"over stan draws, fits and forests {diff:.3g}, equal to the bit "
          f"{same}", flush=True)
    if not (train_err <= 1e-5 and same and fit.prog.sigma_gibbs
            and fit.pm.cfg.centered):
        raise AssertionError(f"{sub} failed")

    sub = f"{label} qr resume"
    _, fit, got = run_fit(sub, device, n, chains, "bart_sweep_batch", iters,
                          warmup, trees, data=d,
                          stan_args={"max_treedepth": 6, "qr": True})
    launches["bart_sweep_batch"] += got
    bi = [fit._name_idx[f"beta.{j + 1}"] for j in range(fit.mf.K)]

    def last_row_err(f):
        return float(np.abs(f.draws.stan[:, -1, bi]
                            - beta_unrotated(f)).max())

    errs = {"fit": last_row_err(fit)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.pkl")
        fit.save(path)
        back = s4b.Stan4bartFit.load(path, device=device)
    more = {}
    for which, f in (("original", fit), ("loaded", back)):
        counts = reset_counts()
        more[which] = f.continue_sampling(10)
        launches["bart_sweep_batch"] += check_launches(
            f"{sub} resume of the {which} fit", counts, "bart_sweep_batch",
            10)
        errs[which] = last_row_err(more[which])
    kept = all(np.array_equal(m.draws.stan[:, :iters], fit.draws.stan)
               for m in more.values())
    diff, same = resume_equal(more["original"], more["loaded"],
                              ("stan", "bart_train"))
    scale = float(np.abs(fit.draws.stan[..., bi]).max())
    print(f"{sub}: max |last stored beta - R_inv beta_qr(final state)| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (|beta| up to {scale:.3g}); stored draws kept by the resumes "
          f"{kept}; loaded vs original resume equal to the bit {same} "
          f"(max difference {diff:.3g})", flush=True)
    if not (kept and same and all(e <= 1e-6 * max(scale, 1.0)
                                  for e in errs.values())
            and more["loaded"].qr_unrotated):
        raise AssertionError(f"{sub} failed")
    return launches


def vi_update_ms(fit, reps=3):
    """Milliseconds of one VI update of every chain on ``fit``'s final
    state (host clock, synchronized; median of ``reps`` after one
    warm-up call)."""
    prog, st = fit.prog, fit.final_states
    y_stan = st.latents if prog.is_binary else prog.y
    gen = torch.Generator(device=prog.device)
    gen.manual_seed(0)
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog._vi_update(st, y_stan, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def deviance(p, y):
    """The binomial deviance of probabilities p (clipped to [1e-9,
    1 - 1e-9], as the reference's ladder test does)."""
    p = np.clip(p, 1e-9, 1 - 1e-9)
    return float(-2 * np.sum(y * np.log(p) + (1 - y) * np.log1p(-p)))


def vi_fit(label, device, t3, n, chains, iters, warmup, trees, binary=False,
           **fit_kw):
    """One VI-within-Gibbs fit at full width through the single-pass
    kernel, with its per-phase seconds beside phase 3's NUTS fit (``t3``)
    and its peak device memory; returns (data, fit, launches, the
    warnings it raised)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        d, fit, launches = run_fit(label, device, n, chains,
                                   "bart_sweep_batch", iters, warmup, trees,
                                   binary=binary, **fit_kw)
    peak = torch.cuda.max_memory_allocated()
    finite_draws(label, fit)
    tm, prog = fit.timings, fit.prog
    ms = vi_update_ms(fit)
    nuts_ms = ("" if t3 is None else
               f"; phase 3's NUTS + linear/level Gibbs "
               f"{t3['nuts_gibbs'] / t3['iters'] * 1e3:.2f} ms per "
               "iteration")
    print(f"{label}: {prog.vi_method} {prog.vi_family} q, {prog.vi_steps} "
          f"steps x {prog.vi_mc} draws per iteration: one VI update of "
          f"{chains} chains {ms:.2f} ms (median of 3, host clock, "
          f"synchronized); VI + linear/level Gibbs "
          f"{tm['nuts_gibbs'] / iters * 1e3:.2f} ms per iteration{nuts_ms}; "
          f"peak device memory {peak / 2 ** 30:.2f} GiB; {card()}",
          flush=True)
    if t3 is not None:
        print(f"{label}: per-phase s over {iters} iterations (phase 3's "
              f"NUTS fit over {t3['iters']}, same call): " + ", ".join(
                  f"{k} {tm[k]:.2f} ({t3[k]:.2f})"
                  for k in ("nuts_gibbs", "sweep", "post", "total")),
              flush=True)
    return d, fit, launches, [str(w.message) for w in caught]


def vi_gates(label, fit, d, sigma_lo, sate=False):
    """The reference's VI / ADVI gates (tests/test_vi_gibbs.py:20-28,
    tests/test_algorithms.py:38-50): cor(indiv.bart, mu_bart) >= 0.95
    (the port's phase 3 gate; the reference's small fixture asks 0.9),
    |fixef of z - 5| < 1.5 and sigma_lo < sigma < 3.0; with ``sate``
    the SATE printed too."""
    cor = centered_cor(fit.fitted("indiv.bart"), d["mu_bart"])
    fx = fit.extract("fixef").mean(-1)
    sigma = float(fit.fitted("sigma"))
    msg = ""
    if sate:
        z = d["z"]
        msg = "; SATE {:.4f} (truth {})".format(float(np.mean(
            (fit.fitted("ev") - fit.fitted("ev", sample="test"))
            * (2 * z - 1))), d["tau"])
    print(f"{label} gates: cor(indiv.bart, mu_bart) {cor:.4f} (>= 0.95); "
          f"fixef of z {fx[1]:.4f} (within 1.5 of 5); sigma {sigma:.4f} "
          f"({sigma_lo} < sigma < 3.0){msg}", flush=True)
    if not (cor >= 0.95 and abs(fx[1] - 5.0) < 1.5
            and sigma_lo < sigma < 3.0):
        raise AssertionError(f"{label}: gates failed")


def phase_algorithms(device, t3, fit3, ev7, label="phase 9", n=10_000,
                     chains=128, iters=100, warmup=50, trees=75):
    """The other algorithms at full width, on phase 3's data and seed,
    every sweep through the single-pass kernel: a. algorithm="vi"
    (warns that sigma is biased high), b. "advi" meanfield, c. "advi"
    fullrank, each with the reference's VI gates; d. "vi" on phase 7's
    probit data with the binary gates and, when phase 7 ran (``ev7``),
    the BART-only probit fit of the reference's ladder on the same data
    (its fixed-effect columns moved into ``bart()``, its random effects
    dropped: an empty parametric vector), with the binary gates, and the
    reference's whole deviance ladder (tests/test_e2e_binary.py:54-89);
    e. SMC adjudication of phase 3's fit (``fit3``) with the reference's
    gates.  100 iterations, 50 of them warmup (150 / 75 met
    the same gates but took 183 s on an H100).
    Returns the single-pass kernel's launches."""
    from stan4bart_torch.fit import _init_parametric_fit
    from scipy.special import ndtr      # the standard normal cdf

    launches = 0
    for sub, algorithm, sa, sigma_lo in (
            ("a vi", "vi", {}, 0.8),
            ("b advi meanfield", "advi", {}, 0.5),
            ("c advi fullrank", "advi", {"vi_family": "fullrank"}, 0.5)):
        sub = f"{label}{sub}"
        d, fit, got, caught = vi_fit(
            sub, device, t3, n, chains, iters, warmup, trees,
            algorithm=algorithm, stan_args={"max_treedepth": 6, **sa})
        launches += got
        warned = any("biased high" in m for m in caught)
        print(f"{sub}: 'biased high' warning {warned}", flush=True)
        if warned != (algorithm == "vi") or fit.prog.vi_family != (
                sa.get("vi_family", "meanfield")):
            raise AssertionError(f"{sub}: warning or family")
        vi_gates(sub, fit, d, sigma_lo, sate=algorithm == "vi")
        del fit

    sub = f"{label}d vi probit"
    d, fit, got, _ = vi_fit(sub, device, t3, n, chains, iters, warmup, trees,
                            binary=True, algorithm="vi")
    launches += got
    ev = binary_gates(sub, fit, d)
    if ev7 is not None:
        y = d["y"]
        eta_glm, _ = _init_parametric_fit(fit.mf, "binomial")
        del fit
        bart_sub = f"{sub} bart-only"
        t0 = time.perf_counter()
        _, bart_only, got = run_fit(
            bart_sub, device, n, chains, "bart_sweep_batch", iters, warmup,
            trees, data=d, formula="y ~ bart(. - g.1 - g.2)")
        launches += got
        if bart_only.pm.num_upars != 0:
            raise AssertionError(f"{bart_sub}: parametric vector of "
                                 f"{bart_only.pm.num_upars}, not empty")
        ev_bart = binary_gates(bart_sub, bart_only, d)
        print(f"{bart_sub}: {time.perf_counter() - t0:.1f} s with its "
              f"gates; {card()}", flush=True)
        del bart_only
        dev7, dev_glm = deviance(ev7, y), deviance(ndtr(eta_glm), y)
        dev_bart, dev_vi = deviance(ev_bart, y), deviance(ev, y)
        print(f"{sub}: deviance ladder (tests/test_e2e_binary.py:54-89): "
              f"phase 7's NUTS fit {dev7:.1f} <= probit IRLS {dev_glm:.1f}, "
              f"<= 1.35 x the BART-only fit's {dev_bart:.1f} "
              f"({1.35 * dev_bart:.1f}) and <= 1.35 x this VI fit's "
              f"{dev_vi:.1f} ({1.35 * dev_vi:.1f})", flush=True)
        if not (dev7 <= dev_glm and dev7 <= 1.35 * dev_bart
                and dev7 <= 1.35 * dev_vi):
            raise AssertionError(f"{sub}: deviance ladder")
    else:
        del fit

    if fit3 is not None:
        sub = f"{label}e smc"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        adj = fit3.adjudicate_parametric_smc(n_particles=1024, n_mcmc=8)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        names = adj["names"]
        ib, isg = names.index("beta.1"), names.index("aux.1")
        sm, mm = adj["smc_mean"], adj["mcmc_mean"]
        print(f"{sub}: adjudicate_parametric_smc(1024 particles, 8 HMC "
              f"steps) of phase 3's fit took {secs:.2f} s, peak device "
              f"memory {peak / 2 ** 30:.2f} GiB; {card()}; final_temp "
              f"{adj['final_temp']} (1.0), log_evidence "
              f"{adj['log_evidence']:.2f} (finite); beta.1 SMC "
              f"{sm[ib]:.4f} vs MCMC {mm[ib]:.4f} (within 1.0); sigma SMC "
              f"{sm[isg]:.4f} vs MCMC {mm[isg]:.4f} (SMC < MCMC + 0.05, "
              f"> 0.4 x MCMC)", flush=True)
        if not (adj["final_temp"] == 1.0
                and np.isfinite(adj["log_evidence"])
                and abs(sm[ib] - mm[ib]) < 1.0
                and 0.4 * mm[isg] < sm[isg] < mm[isg] + 0.05
                and np.all(np.isfinite(adj["draws"]))):
            raise AssertionError(f"{sub}: gates failed")
    return launches


def phase_algorithm_options(device, label="phase 9 options", n=2000,
                            chains=16, trees=20, iters=20, warmup=10):
    """Short VI fits at the options size: one with a callback (the
    per-chain kernel only), a longer one in chunks whose first iterations
    equal the whole fit's and whose whole run equals that fit saved,
    loaded on the card and resumed, to the bit; and VI with sigma_gibbs.
    Returns the launches by kernel."""
    import os
    import tempfile

    import stan4bart_torch as s4b
    from stan4bart_torch.utils.friedman import generate_friedman_data

    launches = {"bart_sweep_batch": 0, "bart_sweep_chain": 0}
    d = generate_friedman_data(n, ranef=True, causal=True)
    vi = dict(algorithm="vi", stan_args={"max_treedepth": 6})

    sub = f"{label} callback"
    _, fit, got = run_fit(sub, device, n, chains, "bart_sweep_chain", iters,
                          warmup, trees, data=d,
                          callback=lambda draw: {"sigma": draw["aux.1"]},
                          **vi)
    launches["bart_sweep_chain"] += got
    same = np.array_equal(fit.extract("callback")["sigma"],
                          fit.extract("sigma"))
    finite_draws(sub, fit)
    print(f"{sub}: {got} per-chain launches; callback sigma equals "
          f"extract('sigma') {same}", flush=True)
    if not same:
        raise AssertionError(f"{sub} failed")

    sub = f"{label} resume"
    _, whole, got = run_fit(sub, device, n, chains, "bart_sweep_batch",
                            iters, warmup, trees, data=d, **vi)
    launches["bart_sweep_batch"] += got
    _, longer, got = run_fit(f"{sub} uninterrupted, chunk_size=5", device,
                             n, chains, "bart_sweep_batch", iters + 10,
                             warmup, trees, data=d, chunk_size=5, **vi)
    launches["bart_sweep_batch"] += got
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.pkl")
        whole.save(path)
        back = s4b.Stan4bartFit.load(path, device=device)
    counts = reset_counts()
    resumed = back.continue_sampling(10)
    launches["bart_sweep_batch"] += check_launches(
        f"{sub} continue_sampling(10)", counts, "bart_sweep_batch", 10)
    names = ("stan", "bart_train", "bart_test", "k")
    head = max(float(np.abs(getattr(whole.draws, k).astype(np.float64)
                            - getattr(longer.draws, k)[:, :iters]).max())
               for k in names)
    diff, same = resume_equal(resumed, longer, names)
    same_vi = all(torch.equal(a, b) for a, b in zip(
        resumed.final_states.vi, longer.final_states.vi))
    print(f"{sub}: whole {iters} iterations vs the first {iters} of "
          f"{iters + 10} in chunks of 5: max difference {head:.3g}; "
          f"save / load on the card + continue_sampling(10) vs "
          f"uninterrupted: max difference {diff:.3g}, equal to the bit "
          f"{same}, final VI state equal {same_vi} (count "
          f"{float(longer.final_states.vi.count[0]):.0f})", flush=True)
    if head or not (same and same_vi):
        raise AssertionError(f"{sub} failed")

    sub = f"{label} sigma_gibbs"
    _, fit, got = run_fit(sub, device, n, chains, "bart_sweep_batch", iters,
                          warmup, trees, data=d, algorithm="vi",
                          stan_args={"max_treedepth": 6,
                                     "sigma_gibbs": True})
    launches["bart_sweep_batch"] += got
    finite_draws(sub, fit)
    print(f"{sub}: sigma_gibbs {fit.prog.sigma_gibbs}; posterior-mean "
          f"sigma {float(fit.fitted('sigma')):.4f}; finite draws",
          flush=True)
    if not fit.prog.sigma_gibbs:
        raise AssertionError(f"{sub}: sigma_gibbs off")
    return launches


def _local_args(args, rank, world):
    """Rank ``rank``'s shard of one sweep's kernel operands (``sweep_args``)
    out of ``world`` equal shards of the observations."""
    from stan4bart_torch.ops.bart_sweep_kernel import SweepConsts

    cfg, feature, cut, lidx, tfit, resid0, s2, t2, u, zn, consts = args
    n = consts.n_obs // world
    sl = slice(rank * n, (rank + 1) * n)
    local = consts._replace(ranks_t=consts.ranks_t[:, sl].contiguous(),
                            n_obs=n, npad=-(-max(n, 128) // 128) * 128)
    assert isinstance(local, SweepConsts)
    return (cfg, feature, cut, lidx[..., sl].contiguous(),
            tfit[..., sl].contiguous(), resid0[:, sl].contiguous(), s2, t2,
            u, zn, local), sl


def _same_chains(a, b, sl_a=slice(None), sl_b=slice(None)):
    """Per chain, whether two sweeps' raw outputs give the same forest and
    leaf indices (over the given observation slices); and the largest
    leaf-value and fit differences over those chains."""
    same = ((a[0] == b[0]).flatten(1).all(1) & (a[1] == b[1]).flatten(1).all(1)
            & (a[3][..., sl_a] == b[3][..., sl_b]).flatten(1).all(1))
    ok = same.nonzero()[:, 0]
    lv = fit = 0.0
    f64 = a[2].dtype == torch.float64
    if len(ok):
        torch.testing.assert_close(a[2][ok], b[2][ok],
                                   **(F64_TOL if f64 else LV_TOL),
                                   msg="leaf values")
        torch.testing.assert_close(a[4][ok][..., sl_a], b[4][ok][..., sl_b],
                                   **(F64_TOL if f64 else FIT_TOL),
                                   msg="tree fits")
        lv = float((a[2][ok] - b[2][ok]).abs().max())
        fit = float((a[4][ok][..., sl_a] - b[4][ok][..., sl_b]).abs().max())
    return same.cpu().numpy(), max(lv, fit)


def _sharded_rank(rank, world, device, N, C, T, reps, path_shape,
                  regrow=False, deep=False, f64=False, heap=False):
    """Phase 10a in one rank: the sharded kernel on this rank's shard
    against the plain sharded sweep (both all-reducing over the world)
    and against the obs-tiled kernel over the whole n, at (N, C) and at
    the composed path's ``path_shape`` (its n and chains per data group)
    with the K and apply blocks the kernel picks there; rank 0 also times
    them and checks world size 1.  With ``regrow`` (phase 11b), the same
    at (N, C) with p_regrow = 1 against the plain sharded sweep, with its
    regrow updates and all-reduces, and rank 0 times it.  With ``deep``
    (phase 12a), the kernel's build for 512-slot heaps at max_depth 8 at
    (N, C) with p_regrow 0 and 1 against the plain sharded sweep, and
    rank 0 times it; with ``f64`` (phase 13a) the same of its float64
    build at depth 6; with ``heap`` (phase 14a) the same of its heap
    build at max_depth 10 in float32 (32 chains, 20 trees, timed by rank
    0) and at max_depth 12 in float64 (16 chains, 20 trees)."""
    import torch.distributed as dist

    from stan4bart_torch.ops.bart_sweep_kernel import (
        apply_blocks, bart_sweep_fused_sharded, sweep_plain,
        sweep_sharded_cuda, sweep_tiled_cuda)
    from stan4bart_torch.parallel.mesh import DataAxis

    # gloo's all_reduce and broadcast take CUDA tensors
    x = torch.full((3,), float(rank + 1), device=device)
    dist.all_reduce(x)
    y = torch.full((3,), float(rank), device=device)
    dist.broadcast(y, 0)
    gloo_cuda = bool((x == world * (world + 1) / 2).all()
                     and (y == 0).all() and x.is_cuda)
    cfg, state, yt, args = sweep_args(N, T, C, 4, device)
    largs, sl = _local_args(args, rank, world)
    axis = DataAxis()
    k = sweep_sharded_cuda(*largs, reduce=axis.sum)
    reductions = axis.calls
    p = sweep_plain(*largs, reduce=axis.sum)
    t = sweep_tiled_cuda(*args)
    torch.cuda.synchronize()
    same_p, err_p = _same_chains(k, p)
    same_t, err_t = _same_chains(k, t, slice(None), sl)
    out = dict(gloo_cuda=gloo_cuda, backend=str(dist.get_backend()),
               same_plain=same_p, err_plain=err_p, same_tiled=same_t,
               err_tiled=err_t, reductions=reductions,
               cluster=bart_sweep_fused_sharded.last_cluster)
    # the composed path's shape (phase 10b's data group)
    N2, C2 = path_shape
    _, _, _, args2 = sweep_args(N2, T, C2, 6, device)
    largs2, sl2 = _local_args(args2, rank, world)
    k2 = sweep_sharded_cuda(*largs2, reduce=axis.sum)
    out.update(path_cluster=bart_sweep_fused_sharded.last_cluster,
               path_apply=apply_blocks(C2, largs2[-1].n_obs))
    p2 = sweep_plain(*largs2, reduce=axis.sum)
    t2 = sweep_tiled_cuda(*args2)
    torch.cuda.synchronize()
    out["path_same_plain"], out["path_err_plain"] = _same_chains(k2, p2)
    out["path_same_tiled"], out["path_err_tiled"] = _same_chains(
        k2, t2, slice(None), sl2)
    del args2, largs2, k2, p2, t2
    # the sweep with its all-reduces, every rank at once (host clock)
    walls = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep_sharded_cuda(*largs, reduce=axis.sum)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["wall_ms"] = float(np.median(walls))
    out["walls"] = walls
    dist.barrier()
    if rank == 0:
        # one rank on the card at a time: the kernels alone, the plain
        # version, the obs-tiled kernel over the whole n, world size 1
        out["ms"], out["all_ms"] = _time(lambda: sweep_sharded_cuda(*largs),
                                         reps)
        out["plain_ms"] = _time(lambda: sweep_plain(*largs), 3)[0]
        out["tiled_ms"] = _time(lambda: sweep_tiled_cuda(*args), reps)[0]
        w1 = sweep_sharded_cuda(*args)
        torch.cuda.synchronize()
        out["same_w1"], out["err_w1"] = _same_chains(w1, t)
        out["w1_ms"] = _time(lambda: sweep_sharded_cuda(*args), reps)[0]
        out["bound_ms"] = (sweep_bytes(C, T, N // world, cfg.max_nodes)
                           / HBM_BYTES_PER_S * 1e3)
        out["bound_w1_ms"] = (sweep_bytes(C, T, N, cfg.max_nodes)
                              / HBM_BYTES_PER_S * 1e3)
    dist.barrier()
    if regrow:
        lon, rg = regrow_args(largs, 1.0, 104)
        axis = DataAxis()
        before = bart_sweep_fused_sharded.regrow_launches
        kr = sweep_sharded_cuda(*lon, reduce=axis.sum, rg=rg)
        out["rg_updates"] = bart_sweep_fused_sharded.regrow_launches - before
        out["rg_reductions"] = axis.calls
        pr = sweep_plain(*lon, reduce=axis.sum, rg=rg)
        torch.cuda.synchronize()
        out["rg_same"], out["rg_err"] = _same_chains(kr, pr)
        out["rg_moved"] = changed_chains(kr, k)
        del pr
        dist.barrier()
        if rank == 0:
            out["rg_ms"], out["rg_all_ms"] = _time(
                lambda: sweep_sharded_cuda(*lon, rg=rg), reps)
            out["rg_plain_ms"] = _time(lambda: sweep_plain(*lon, rg=rg),
                                       3)[0]
            out["rg_bound_ms"] = (
                (sweep_bytes(C, T, N // world, cfg.max_nodes)
                 + regrow_bytes(C, T, cfg.max_nodes))
                / HBM_BYTES_PER_S * 1e3)
        dist.barrier()
    if deep:
        dcfg, dstate, _, dargs = sweep_args(N, T, C, 8, device, **DEEP)
        dl, _ = _local_args(dargs, rank, world)
        don, drg = regrow_args(dl, 1.0, 108)
        out["deep_start"] = depth_note(dstate.feature)[:2]
        axis = DataAxis()
        before = bart_sweep_fused_sharded.deep_launches
        k0 = sweep_sharded_cuda(*dl, reduce=axis.sum)
        k1 = sweep_sharded_cuda(*don, reduce=axis.sum, rg=drg)
        out["deep_updates"] = (bart_sweep_fused_sharded.deep_launches
                               - before)
        out["deep_cluster"] = bart_sweep_fused_sharded.last_cluster
        p0 = sweep_plain(*dl, reduce=axis.sum)
        torch.cuda.synchronize()
        out["deep_same0"], out["deep_err0"] = _same_chains(k0, p0)
        del p0
        p1 = sweep_plain(*don, reduce=axis.sum, rg=drg)
        torch.cuda.synchronize()
        out["deep_same1"], out["deep_err1"] = _same_chains(k1, p1)
        out["deep_after"] = depth_note(p1[0])[:2]
        del p1, k0, k1
        dist.barrier()
        if rank == 0:
            out["deep_ms"], out["deep_all_ms"] = _time(
                lambda: sweep_sharded_cuda(*dl), reps)
            out["deep_ms_1"] = _time(
                lambda: sweep_sharded_cuda(*don, rg=drg), reps)[0]
            out["deep_plain_ms"] = _time(lambda: sweep_plain(*dl), 1)[0]
            out["deep_bound_ms"] = (
                sweep_bytes(C, T, N // world, dcfg.max_nodes, DEEP_PAD)
                / HBM_BYTES_PER_S * 1e3)
        dist.barrier()
    if f64:
        f64_ = torch.float64
        fcfg, _, _, fargs = sweep_args(N, T, C, 14, device, f64_)
        fl, _ = _local_args(fargs, rank, world)
        fon, frg = regrow_args(fl, 1.0, 114)
        axis = DataAxis()
        before = bart_sweep_fused_sharded.f64_launches
        k0 = sweep_sharded_cuda(*fl, reduce=axis.sum)
        k1 = sweep_sharded_cuda(*fon, reduce=axis.sum, rg=frg)
        out["f64_updates"] = bart_sweep_fused_sharded.f64_launches - before
        out["f64_reductions"] = axis.calls
        out["f64_cluster"] = bart_sweep_fused_sharded.last_cluster
        p0 = sweep_plain(*fl, reduce=axis.sum)
        torch.cuda.synchronize()
        out["f64_same0"], out["f64_err0"] = _same_chains(k0, p0)
        del p0
        p1 = sweep_plain(*fon, reduce=axis.sum, rg=frg)
        torch.cuda.synchronize()
        out["f64_same1"], out["f64_err1"] = _same_chains(k1, p1)
        del p1, k0, k1
        dist.barrier()
        if rank == 0:
            out["f64_ms"], out["f64_all_ms"] = _time(
                lambda: sweep_sharded_cuda(*fl), reps)
            out["f64_ms_1"] = _time(
                lambda: sweep_sharded_cuda(*fon, rg=frg), reps)[0]
            out["f64_plain_ms"] = _time(lambda: sweep_plain(*fl), 1)[0]
            out["f64_bound_ms"] = (
                sweep_bytes(C, T, N // world, fcfg.max_nodes, dtype=f64_)
                / HBM_BYTES_PER_S * 1e3)
        dist.barrier()
    if heap:
        out["heap"] = {}
        for tag, dt, Ch, kw, seed in (("float32", torch.float32, 32, HEAP10,
                                       24),
                                      ("float64", torch.float64, 16, HEAP12,
                                       25)):
            hcfg, hstate, _, hargs = sweep_args(N, 20, Ch, seed, device, dt,
                                                **kw)
            hl, _ = _local_args(hargs, rank, world)
            hon, hrg = regrow_args(hl, 1.0, seed + 100)
            axis = DataAxis()
            before = bart_sweep_fused_sharded.heap_launches
            k0 = sweep_sharded_cuda(*hl, reduce=axis.sum)
            k1 = sweep_sharded_cuda(*hon, reduce=axis.sum, rg=hrg)
            h = dict(updates=bart_sweep_fused_sharded.heap_launches - before,
                     cluster=bart_sweep_fused_sharded.last_cluster,
                     start=depth_note(hstate.feature, 10)[:2],
                     chains=Ch, max_depth=hcfg.max_depth)
            p0 = sweep_plain(*hl, reduce=axis.sum)
            torch.cuda.synchronize()
            h["same0"], h["err0"] = _same_chains(k0, p0)
            del p0
            p1 = sweep_plain(*hon, reduce=axis.sum, rg=hrg)
            torch.cuda.synchronize()
            h["same1"], h["err1"] = _same_chains(k1, p1)
            del p1, k0, k1
            dist.barrier()
            if rank == 0 and dt == torch.float32:
                h["ms"], h["all_ms"] = _time(
                    lambda: sweep_sharded_cuda(*hl), reps)
                h["ms_1"] = _time(lambda: sweep_sharded_cuda(*hon, rg=hrg),
                                  reps)[0]
                h["plain_ms"] = _time(lambda: sweep_plain(*hl), 1)[0]
                h["bound_ms"] = (sweep_bytes(Ch, 20, N // world,
                                             hcfg.max_nodes, HEAP_PAD)
                                 / HBM_BYTES_PER_S * 1e3)
            dist.barrier()
            out["heap"][tag] = h
            del hargs, hl, hon, hrg
    return out


def phase_sharded_kernel(N=50_000, C=64, T=75, reps=7, label="phase 10a",
                         path_shape=(10_000, 128), regrow=False,
                         deep=False, f64=False, heap=False):
    """The observation-sharded sweep kernel over 2 ranks on the card; with
    ``regrow``, phase 11b in the same ranks, with ``deep`` phase 12a's
    sharded part, with ``f64`` phase 13a's, with ``heap`` phase 14a's."""
    from stan4bart_torch.parallel import mesh

    t0 = time.perf_counter()
    r0, r1 = mesh.spawn(_sharded_rank, ["cuda:0", "cuda:0"], RANK_BACKEND,
                        args=(N, C, T, reps, path_shape, regrow, deep, f64,
                              heap),
                        timeout_s=600)
    same_p = r0["same_plain"] & r1["same_plain"]
    same_t = r0["same_tiled"] & r1["same_tiled"]
    print(f"{label}: backend {r0['backend']}, gloo all_reduce / broadcast "
          f"on CUDA tensors: {r0['gloo_cuda'] and r1['gloo_cuda']}; n={N} "
          f"over 2 ranks, chains={C}, trees={T}, stats K="
          f"{r0['cluster']}: {int(same_p.sum())}/{C} chains identical to "
          f"the plain sharded sweep (max |kernel - plain| "
          f"{max(r0['err_plain'], r1['err_plain']):.3g}), "
          f"{int(same_t.sum())}/{C} to the obs-tiled kernel over the whole "
          f"n (max {max(r0['err_tiled'], r1['err_tiled']):.3g}); "
          f"{r0['reductions']} all-reduces per rank for {T} trees; world "
          f"size 1: {int(r0['same_w1'].sum())}/{C} chains identical to the "
          f"obs-tiled kernel (max {r0['err_w1']:.3g})", flush=True)
    if not (r0["gloo_cuda"] and r1["gloo_cuda"]):
        raise AssertionError(f"{label}: gloo refused CUDA tensors")
    N2, C2 = path_shape
    path_p = r0["path_same_plain"] & r1["path_same_plain"]
    path_t = r0["path_same_tiled"] & r1["path_same_tiled"]
    print(f"{label}: at phase 10b's shape, n={N2} over 2 ranks, chains="
          f"{C2}, trees={T}, stats K={r0['path_cluster']}, apply blocks "
          f"{r0['path_apply']} per chain: {int(path_p.sum())}/{C2} chains "
          "identical to the plain sharded sweep (max |kernel - plain| "
          f"{max(r0['path_err_plain'], r1['path_err_plain']):.3g}), "
          f"{int(path_t.sum())}/{C2} to the obs-tiled kernel over the whole "
          f"n (max {max(r0['path_err_tiled'], r1['path_err_tiled']):.3g})",
          flush=True)
    if (same_p.sum() < C or same_t.sum() < C - 1
            or r0["same_w1"].sum() < C - 1 or r0["reductions"] != T
            or path_p.sum() < C2 or path_t.sum() < C2 - 1):
        raise AssertionError(f"{label}: the sharded kernel disagrees")
    share = 1.0 - r0["ms"] / r0["wall_ms"]
    print(f"{label}: stats + apply kernels per sweep at n={N // 2} per rank "
          f"median {r0['ms']:.4f} ms {[round(x, 4) for x in r0['all_ms']]}; "
          f"the sweep with its {T} all-reduces, both ranks at once, median "
          f"{r0['wall_ms']:.4f} ms (host clock; rank 1 "
          f"{r1['wall_ms']:.4f}), the collectives' share "
          f"{100 * share:.1f} %; obs-tiled kernel over n={N} in the same "
          f"call {r0['tiled_ms']:.4f} ms; the sharded kernel at world size "
          f"1 over n={N} {r0['w1_ms']:.4f} ms; plain sharded sweep "
          f"{r0['plain_ms']:.4f} ms; memory bound {r0['bound_ms']:.4f} ms at "
          f"the local n ({r0['bound_w1_ms']:.4f} ms at n={N}); "
          f"{time.perf_counter() - t0:.1f} s; {card()}", flush=True)
    if regrow:
        same = r0["rg_same"] & r1["rg_same"]
        print(f"phase 11b: the sharded kernel with p_regrow 1 at n={N} over "
              f"2 ranks, chains={C}: {int(same.sum())}/{C} chains identical "
              "to the plain sharded sweep (max |kernel - plain| "
              f"{max(r0['rg_err'], r1['rg_err']):.3g}); the move changed "
              f"{r0['rg_moved']}/{C} chains' forests; per rank "
              f"{T} tree updates and {r0['rg_updates']} regrow updates "
              f"(rank 1 {r1['rg_updates']}), {r0['rg_reductions']} "
              f"all-reduces (rank 1 {r1['rg_reductions']}); kernels alone "
              f"median {r0['rg_ms']:.4f} ms "
              f"{[round(x, 4) for x in r0['rg_all_ms']]} against "
              f"{r0['ms']:.4f} ms at p_regrow 0; plain sharded sweep "
              f"{r0['rg_plain_ms']:.4f} ms; bound {r0['rg_bound_ms']:.4f} "
              f"ms; {card()}", flush=True)
        if (same.sum() < C or r0["rg_updates"] != r1["rg_updates"]
                or r0["rg_reductions"] != T + r0["rg_updates"]):
            raise AssertionError("phase 11b: the sharded kernel with the "
                                 "regrow disagrees")
    deep_err = 0.0
    if deep:
        deep_err = max(r[k] for r in (r0, r1)
                       for k in ("deep_err0", "deep_err1"))
        same0 = r0["deep_same0"] & r1["deep_same0"]
        same1 = r0["deep_same1"] & r1["deep_same1"]
        print(f"phase 12a: the sharded kernel's 512-slot build at max_depth "
              f"8, n={N} over 2 ranks, chains={C}, trees={T}, stats K="
              f"{r0['deep_cluster']}, from a forest whose deepest node is "
              f"at depth {r0['deep_start'][0]} ({r0['deep_start'][1]} nodes "
              f"at depth >= 7; after the p_regrow 1 sweep "
              f"{r0['deep_after'][1]}): {int(same0.sum())}/{C} and "
              f"{int(same1.sum())}/{C} chains identical to the plain sharded "
              "sweep at p_regrow 0 and 1 (max |kernel - plain| "
              f"{deep_err:.3g}); "
              f"{r0['deep_updates']} deep tree updates per rank (rank 1 "
              f"{r1['deep_updates']}); kernels alone median "
              f"{r0['deep_ms']:.4f} ms "
              f"{[round(x, 4) for x in r0['deep_all_ms']]} at p_regrow 0 "
              f"({r0['ms']:.4f} ms at depth 6), {r0['deep_ms_1']:.4f} ms at "
              f"1; plain sharded sweep {r0['deep_plain_ms']:.4f} ms; bound "
              f"{r0['deep_bound_ms']:.4f} ms; {card()}", flush=True)
        if (same0.sum() < C or same1.sum() < C
                or r0["deep_updates"] != 2 * T
                or r1["deep_updates"] != 2 * T):
            raise AssertionError("phase 12a: the sharded kernel's deep "
                                 "build disagrees")
    f64_err = 0.0
    if f64:
        f64_err = max(r[k] for r in (r0, r1)
                      for k in ("f64_err0", "f64_err1"))
        same0 = r0["f64_same0"] & r1["f64_same0"]
        same1 = r0["f64_same1"] & r1["f64_same1"]
        print(f"phase 13a: the sharded kernel's float64 build, n={N} over 2 "
              f"ranks, chains={C}, trees={T}, stats K={r0['f64_cluster']}: "
              f"{int(same0.sum())}/{C} and {int(same1.sum())}/{C} chains "
              "identical to the plain float64 sharded sweep at p_regrow 0 "
              f"and 1 (max |kernel - plain| {f64_err:.3g}, within "
              f"{F64_TOL['atol']}); {r0['f64_updates']} float64 tree "
              f"updates per rank (rank 1 {r1['f64_updates']}), "
              f"{r0['f64_reductions']} float64 all-reduces; kernels alone "
              f"median {r0['f64_ms']:.4f} ms "
              f"{[round(x, 4) for x in r0['f64_all_ms']]} at p_regrow 0 "
              f"({r0['ms']:.4f} ms in float32), {r0['f64_ms_1']:.4f} ms at "
              f"1; plain float64 sharded sweep {r0['f64_plain_ms']:.4f} ms; "
              f"bound {r0['f64_bound_ms']:.4f} ms; {card()}", flush=True)
        if (same0.sum() < C - 1 or same1.sum() < C - 1
                or r0["f64_updates"] != 2 * T
                or r1["f64_updates"] != 2 * T):
            raise AssertionError("phase 13a: the sharded kernel's float64 "
                                 "build disagrees")
    heap_out = {}
    if heap:
        errs = []
        for tag, h0 in r0["heap"].items():
            h1 = r1["heap"][tag]
            Ch = h0["chains"]
            same0 = h0["same0"] & h1["same0"]
            same1 = h0["same1"] & h1["same1"]
            errs += [h[k] for h in (h0, h1) for k in ("err0", "err1")]
            print(f"phase 14a: the sharded kernel's heap build in {tag} at "
                  f"max_depth {h0['max_depth']}, n={N} over 2 ranks, "
                  f"chains={Ch}, trees=20, stats K={h0['cluster']}, from a "
                  f"forest whose deepest node is at depth {h0['start'][0]} "
                  f"({h0['start'][1]} nodes at depth >= 10): "
                  f"{int(same0.sum())}/{Ch} and {int(same1.sum())}/{Ch} "
                  "chains identical to the plain sharded sweep at p_regrow 0 "
                  f"and 1 (max |kernel - plain| {max(errs[-4:]):.3g}); "
                  f"{h0['updates']} heap tree updates per rank (rank 1 "
                  f"{h1['updates']})", flush=True)
            if (same0.sum() < Ch - 1 or same1.sum() < Ch - 1
                    or h0["updates"] != 40 or h1["updates"] != 40):
                raise AssertionError("phase 14a: the sharded kernel's heap "
                                     "build disagrees")
        h0 = r0["heap"]["float32"]
        print(f"phase 14a: sharded heap build, float32, max_depth 10, "
              f"{N // 2} rows a rank x {h0['chains']} chains x 20 trees, "
              f"kernels alone median {h0['ms']:.4f} ms "
              f"{[round(x, 4) for x in h0['all_ms']]} at p_regrow 0, "
              f"{h0['ms_1']:.4f} ms at 1; plain sharded sweep "
              f"{h0['plain_ms']:.4f} ms; bound {h0['bound_ms']:.4f} ms; "
              f"{card()}", flush=True)
        heap_out = dict(heap_err=max(errs), heap_ms=h0["ms"],
                        heap_ms_1=h0["ms_1"], heap_plain_ms=h0["plain_ms"],
                        heap_bound_ms=h0["bound_ms"],
                        heap_cluster=h0["cluster"])
    return dict(r0, max_abs_err=max(
        r0["err_w1"], *(r[k] for r in (r0, r1) for k in (
            "err_plain", "err_tiled", "path_err_plain", "path_err_tiled"))),
        share=share, deep_err=deep_err, f64_err=f64_err, **heap_out)


def _digest(fit):
    import hashlib

    h = hashlib.sha256()
    for name in ("stan", "bart_train", "bart_test", "k", "varcount"):
        h.update(np.ascontiguousarray(getattr(fit.draws, name)).tobytes())
    return h.hexdigest()


def _composed_rank(rank, world, device, n, chains, iters, warmup, trees,
                   obs_shards):
    """Phase 10b in one rank: the flagship fit in a world of ``world``
    ranks with ``obs_shards`` data ranks per chain group."""
    import stan4bart_torch
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe, generate_friedman_data)

    d = generate_friedman_data(n, ranef=True, causal=True)
    counts = reset_counts()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit = stan4bart_torch.stan4bart(
        FLAGSHIP, friedman_dataframe(d), treatment="z", chains=chains,
        iter=iters, warmup=warmup, seed=11, verbose=-1, device=device,
        stan_args={"max_treedepth": 6, "obs_shards": obs_shards},
        bart_args={"n_trees": trees})
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    out = dict(digest=_digest(fit), launches=launches, wall=wall,
               timings=fit.timings,
               peak=torch.cuda.max_memory_allocated() if on_card else 0,
               info={k: fit.run_info[k] for k in
                     ("world_size", "chain_groups", "obs_shards", "backend",
                      "all_reduces")},
               finite=all(bool(np.all(np.isfinite(getattr(fit.draws, k))))
                          for k in ("stan", "bart_train", "bart_test", "k")))
    if rank == 0:
        z = d["z"]
        out.update(
            cor=centered_cor(fit.fitted("indiv.bart"), d["mu_bart"]),
            sigma=float(fit.fitted("sigma")),
            sate=float(np.mean((fit.fitted("ev")
                                - fit.fitted("ev", sample="test"))
                               * (2 * z - 1))),
            tau=float(d["tau"]))
    return out


def phase_composed(label="phase 10b", n=10_000, chains=256, iters=150,
                   warmup=75, trees=75, device="cuda:0"):
    """The phase 3 fit on 4 ranks: 2 chain groups x obs_shards = 2."""
    from stan4bart_torch.parallel import mesh

    t0 = time.perf_counter()
    res = mesh.spawn(_composed_rank, [device] * 4, RANK_BACKEND,
                     args=(n, chains, iters, warmup, trees, 2),
                     timeout_s=900)
    r0 = res[0]
    want = (iters + 1) * trees
    for r, x in enumerate(res):
        for k, got in x["launches"].items():
            if got != (want if k == "bart_sweep_sharded" else 0):
                raise AssertionError(f"{label}: rank {r} {k} launched {got} "
                                     f"times")
        if x["digest"] != r0["digest"] or not x["finite"]:
            raise AssertionError(f"{label}: rank {r}'s draws differ or are "
                                 "not finite")
    tm = [x["timings"] for x in res]
    print(f"{label}: stan4bart n={n} chains={chains} trees={trees} "
          f"iter={iters} warmup={warmup} on {r0['info']['world_size']} "
          f"ranks ({r0['info']['chain_groups']} chain groups x obs_shards "
          f"{r0['info']['obs_shards']}, backend {r0['info']['backend']}): "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start; "
          "bart_sweep_sharded launches per rank "
          f"{r0['launches']['bart_sweep_sharded']} = ({iters} iterations + 1 "
          f"init) x {trees} trees, other sweep kernels 0; all-reduces per "
          f"rank {r0['info']['all_reduces']}; the gathered draws identical "
          "on every rank; per rank wall s "
          + ", ".join(f"{x['wall']:.1f}" for x in res)
          + "; per-phase s (rank 0..3): NUTS+linear/level Gibbs "
          + "/".join(f"{t['nuts_gibbs']:.1f}" for t in tm) + ", sweep "
          + "/".join(f"{t['sweep']:.1f}" for t in tm) + ", post "
          + "/".join(f"{t['post']:.1f}" for t in tm) + ", gather "
          + "/".join(f"{t['gather']:.1f}" for t in tm)
          + "; peak device memory per rank "
          + ", ".join(f"{x['peak'] / 2 ** 30:.2f}" for x in res)
          + f" GiB; {card()}", flush=True)
    check_gates(label, r0["cor"], r0["sigma"], "bart_sweep_sharded",
                r0["launches"]["bart_sweep_sharded"] // trees, iters)
    print(f"{label}: SATE {r0['sate']:.4f} (truth {r0['tau']}, within 1)",
          flush=True)
    if abs(r0["sate"] - r0["tau"]) >= 1.0:
        raise AssertionError(f"{label}: SATE gate failed")
    return r0["launches"]["bart_sweep_sharded"]


def _contract_rank(rank, world, device, fits):
    """Phase 10c in one rank: each small fit of ``fits`` in turn in the
    world; their draws and launch counts."""
    out = []
    for kw in fits:
        counts = reset_counts()
        fit = _small_fit(device, **kw)
        out.append(dict(
            draws={k: getattr(fit.draws, k) for k in
                   ("stan", "bart_train", "tree_feature", "tree_cut")},
            launches={k: fn.launches for k, fn in counts.items()},
            f64={k: fn.f64_launches for k, fn in counts.items()},
            threads=torch.get_num_threads()))
    return out


def _small_fit(device, seed, n=2000, **kw):
    import stan4bart_torch
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe, generate_friedman_data)

    d = generate_friedman_data(n, ranef=True, causal=True)
    return stan4bart_torch.stan4bart(
        FLAGSHIP, friedman_dataframe(d), treatment="z", iter=20, warmup=10,
        seed=seed, verbose=-1, device=device,
        bart_args={"n_trees": 20, "keep_trees": True}, **kw)


def phase_contracts(device, label="phase 10c", chains=16, n=2000):
    """The chain path's and the obs-sharded path's contracts at n = 2000,
    the obs-sharded one in float32 and in float64 (every tree update a
    launch of the sharded kernel's float64 build)."""
    from stan4bart_torch.parallel import mesh, multihost

    t0 = time.perf_counter()
    sharded = dict(seed=6, chains=chains, n=n,
                   stan_args={"max_treedepth": 6, "obs_shards": 2})
    fits = (dict(seed=5, chains=chains, n=n, stan_args={"max_treedepth": 6}),
            sharded, dict(sharded, dtype=torch.float64))
    # the ranks run while this process fits the single-process references
    # (nothing here is timed); the ranks use fewer host threads than this
    # process, which a fit on the card does not see
    box = {}

    def run_ranks():
        try:
            box["ranks"] = mesh.spawn(_contract_rank, [str(device)] * 2,
                                      RANK_BACKEND, args=(fits,),
                                      timeout_s=600)
        except Exception as e:      # raised below, in this thread
            box["error"] = e

    ranks_thread = threading.Thread(target=run_ranks)
    ranks_thread.start()
    C = chains // 2
    refs = [_small_fit(device, seed=multihost.rank_seed(5, r, 2), chains=C,
                       n=n, stan_args={"max_treedepth": 6})
            for r in range(2)]
    ref = {dt: _small_fit(device, seed=multihost.rank_seed(6, 0, 1),
                          chains=chains, n=n, dtype=dt,
                          stan_args={"max_treedepth": 6})
           for dt in (torch.float32, torch.float64)}
    ranks_thread.join()
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    res = [r[0] for r in ranks]
    draws = res[0]["draws"]
    for r in range(2):
        for k, v in draws.items():
            if not np.array_equal(v[r * C:(r + 1) * C],
                                  getattr(refs[r].draws, k)):
                raise AssertionError(f"{label}: rank {r}'s {k} differs from "
                                     "the single-process fit")
        if not all(np.array_equal(v, res[1]["draws"][k])
                   for k, v in draws.items()):
            raise AssertionError(f"{label}: the ranks' draws differ")
    chain_batch = res[0]["launches"]["bart_sweep_batch"]
    if chain_batch != 21 or res[0]["launches"]["bart_sweep_sharded"]:
        raise AssertionError(f"{label}: the chain path's launches "
                             f"{res[0]['launches']}")
    print(f"{label}: a 2-rank chain-sharded fit (n={n}, {chains} chains, 20 "
          "iterations, bart_sweep_batch launches per rank "
          f"{chain_batch}) equals, to the bit, "
          f"rank by rank, single-process fits of {C} chains with the "
          f"ranks' seeds (host threads: ranks {res[0]['threads']}, "
          f"single-process fits {torch.get_num_threads()})", flush=True)
    out = {"bart_sweep_batch": chain_batch}
    for i, dt in ((1, torch.float32), (2, torch.float64)):
        res = ranks[0][i]
        d, r = res["draws"], ref[dt].draws
        same = np.array([
            np.array_equal(d["tree_feature"][c, 0], r.tree_feature[c, 0])
            and np.array_equal(d["tree_cut"][c, 0], r.tree_cut[c, 0])
            for c in range(chains)])
        launches = res["launches"]["bart_sweep_sharded"]
        f64 = res["f64"]["bart_sweep_sharded"]
        print(f"{label}: a 2-rank obs-sharded {dt} fit's first forests "
              f"equal the unsharded fit's in {int(same.sum())}/{chains} "
              f"chains; bart_sweep_sharded launches per rank {launches}, "
              f"{f64} of them the float64 build; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if (same.sum() < chains - 1 or launches != 21 * 20
                or f64 != (launches if dt == torch.float64 else 0)
                or sum(res["launches"].values()) != launches):
            raise AssertionError(f"{label}: the obs-sharded {dt} fit "
                                 "differs")
        key = ("bart_sweep_sharded" if dt == torch.float32
               else "bart_sweep_sharded_f64")
        out[key] = launches
    return out


def regrow_bytes(C, T, M, dtype=torch.float32):
    """Bytes the in-sweep regrow adds to a sweep's bound: its variates
    (3 + 3 M uniforms per chain and tree, in ``dtype``), read once.  The
    cut ranks its walks read are the ranks table ``sweep_bytes`` counts
    once already, and the leaf indices and residuals it reads are on
    chip."""
    return C * T * (3 + 3 * M) * dtype.itemsize


def regrow_args(args, p, seed, shut=False):
    """``sweep_args``' operands with ``p_regrow = p`` and regrow variates
    drawn in float32 from ``seed`` and widened to the operands' dtype
    (every gate shut when ``shut``)."""
    from stan4bart_torch.ops import bart as ops

    cfg = args[0]
    C, T = args[1].shape[:2]
    gen = torch.Generator(device=args[1].device)
    gen.manual_seed(seed)
    rg = ops.draw_tree_regrow_variates(gen, C, cfg, torch.float32,
                                       args[1].device).to(args[5].dtype)
    if shut:
        rg[..., 0] = 1.0
    return (cfg._replace(p_regrow=p),) + args[1:], rg


def changed_chains(a, b):
    """How many chains' forests differ between two sweeps' outputs."""
    return int(((a[0] != b[0]).flatten(1).any(1)
                | (a[1] != b[1]).flatten(1).any(1)).sum())


def regrow_at_shape(device, label, N, C, kernels, seed, T=75, times=False,
                    reps=7, weighted=False):
    """Each kernel of ``kernels`` (name -> (launcher, wrapper)) at N x C
    chains, at the K it picks, with p_regrow = 1 against the plain sweep
    on the same (u, zn, rg) variates (identical forests and leaf indices
    in every chain); every gate shut against p_regrow = 0 (to the bit);
    and how many chains' forests the move changed.  ``weighted``: every
    sweep with observation weights drawn in [0.5, 2).  With ``times``,
    the kernels' CUDA-event times at p_regrow = 0, 0.25 and 1 and the
    plain sweep's at 1.  Returns the largest error and the times."""
    from stan4bart_torch.ops.bart_sweep_kernel import sweep_plain

    _, state, yt, args = sweep_args(N, T, C, seed, device)
    w = None
    if weighted:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 200)
        w = 0.5 + 1.5 * torch.rand(N, generator=gen, device=device)
    on, rg = regrow_args(args, 1.0, seed + 100)
    shut, rg_shut = regrow_args(args, 0.5, seed + 100, shut=True)
    outs, off, ks, moved = {}, {}, {}, {}
    for name, (launch, wrapper) in kernels.items():
        off[name] = launch(*args, weights=w)
        closed = launch(*shut, weights=w, rg=rg_shut)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(off[name], closed)):
            raise AssertionError(f"{label}: {name} with every regrow gate "
                                 "shut differs from p_regrow = 0")
        outs[name] = launch(*on, weights=w, rg=rg)
        ks[name] = wrapper.last_cluster
        moved[name] = changed_chains(outs[name], off[name])
    outs["plain"] = sweep_plain(*on, weights=w, rg=rg)
    torch.cuda.synchronize()
    res = check_sweep(f"{label} regrow p=1 n={N} chains={C}"
                      + (" weighted" if weighted else ""), outs, state,
                      yt, C, N, T, C)
    print(f"{label} n={N} chains={C}{' weighted' if weighted else ''}: "
          "with every gate shut each kernel "
          "equals its p_regrow = 0 sweep to the bit; at p_regrow = 1 the "
          "move changed the forests of "
          + ", ".join(f"{k} (K={ks[k]}) {v}/{C}" for k, v in moved.items())
          + " chains", flush=True)
    out = dict(err=max(v[1] for v in res.values()), clusters=ks)
    if times:
        mid, rg_mid = regrow_args(args, 0.25, seed + 100)
        for name, (launch, _) in kernels.items():
            for tag, a, r in (("0", args, None), ("0.25", mid, rg_mid),
                              ("1", on, rg)):
                ms, all_ms = _time(lambda: launch(*a, weights=w, rg=r),
                                   reps)
                out[f"{name}_ms_{tag}"] = ms
                out[f"{name}_all_{tag}"] = all_ms
        out["plain_ms_1"] = _time(
            lambda: sweep_plain(*on, weights=w, rg=rg), 3)[0]
    return out


def phase_regrow_kernels(device, reps=7):
    """Phase 11a: the one-launch kernels with the in-sweep regrow at the
    bench shape (timed, with the bound) and at the shapes the main paths
    run (phases 6-9: 10 000 x 128; phase 5: 50 000 x 32), where the
    obs-tiled kernel also runs at K = 1, whose 50 000 rows a block keep
    the residual in device memory (its streaming kernel's regrow step),
    unweighted and weighted."""
    from functools import partial

    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled, kernel_smem, sweep_chain_cuda,
        sweep_cuda, sweep_tiled_cuda)

    C, N, T, M = 256, 10_000, 75, 127
    three = {"batch": (sweep_cuda, bart_sweep_fused_batch),
             "tiled": (sweep_tiled_cuda, bart_sweep_fused_batch_tiled),
             "chain": (sweep_chain_cuda, bart_sweep_fused)}
    bench = regrow_at_shape(device, "phase 11a", N, C, three, 3, T,
                            times=True, reps=reps)
    at128 = regrow_at_shape(
        device, "phase 11a", N, 128,
        {k: three[k] for k in ("batch", "chain")}, 6, T)
    if kernel_smem("bart_sweep_tiled", 50_000, T, 1, True)["resid_on_chip"]:
        raise AssertionError("phase 11a: the obs-tiled kernel at 50 000 "
                             "rows a block keeps the residual on chip; "
                             "its streaming kernel would go unchecked")
    at50k = {"tiled": three["tiled"],
             "tiled streamed": (partial(sweep_tiled_cuda, cluster=1),
                                bart_sweep_fused_batch_tiled)}
    at50k = [regrow_at_shape(device, "phase 11a", 50_000, 32, at50k, 7, T,
                             weighted=wt) for wt in (False, True)]
    print("phase 11a " + smem_note("bart_sweep_tiled", 50_000, T, 1, True),
          flush=True)
    nbytes = sweep_bytes(C, T, N, M) + regrow_bytes(C, T, M)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    lines = "; ".join(
        f"{k} (K={bench['clusters'][k]}) p_regrow 0 / 0.25 / 1: "
        f"{bench[k + '_ms_0']:.4f} / {bench[k + '_ms_0.25']:.4f} / "
        f"{bench[k + '_ms_1']:.4f} ms" for k in three)
    print("phase 11a " + "; ".join(
        smem_note(f"bart_sweep_{k}", N, T, bench["clusters"][k], True)
        for k in three), flush=True)
    print(f"phase 11a times at n={N} chains={C} trees={T}, median of "
          f"{reps}: {lines}; batch at p_regrow 1 "
          f"{[round(t, 4) for t in bench['batch_all_1']]}; plain sweep at "
          f"p_regrow 1 {bench['plain_ms_1']:.4f} ms; bound with the move "
          f"{bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s; the regrow variates "
          f"{regrow_bytes(C, T, M) / 1e6:.1f} MB); {card()}", flush=True)
    return dict(bench, bound_ms=bound_ms,
                max_abs_err=max(bench["err"], at128["err"],
                                *(r["err"] for r in at50k)))


def phase_regrow_fit(device, label="phase 11c", n=10_000, chains=128,
                     iters=150, warmup=75, trees=75, p_regrow=0.25):
    """Phase 11c: the phase 3 fit (at 128 chains) with the in-sweep
    regrow, every sweep through the single-pass kernel with the move: the
    gaussian gates and SATE.  Returns the launches and its
    ``fit_quality`` (12b's depth-6 numbers)."""
    from stan4bart_torch.ops.bart_sweep_kernel import bart_sweep_fused_batch

    d, fit, launches = run_fit(label, device, n, chains, "bart_sweep_batch",
                               iters, warmup, trees,
                               bart_args={"n_trees": trees,
                                          "p_regrow": p_regrow})
    regrown = bart_sweep_fused_batch.regrow_launches
    finite_draws(label, fit)
    if fit.prog.bart_cfg.p_regrow != p_regrow or regrown != launches:
        raise AssertionError(f"{label}: {regrown} of {launches} launches "
                             "ran the regrow")
    q = fit_quality(d, fit)
    check_gates(label, q["cor"], q["sigma"], "bart_sweep_batch", launches,
                iters)
    print(f"{label}: p_regrow {p_regrow}, {regrown} launches with the move; "
          f"SATE {q['sate']:.4f} (truth {d['tau']}, within 1)", flush=True)
    if abs(q["sate"] - d["tau"]) >= 1.0:
        raise AssertionError(f"{label}: SATE gate failed")
    return launches, q


def phase_profile(device, fit3=None, label="phase 11d", n=10_000,
                  chains=256, trees=75):
    """Phase 11d: ``utils.profiling.profile_phases`` at the bench shape
    (n_iter 3, repeats 1) on phase 3's final states, or on a short fit's
    when phase 3 did not run; prints ``format_profile``'s lines."""
    from stan4bart_torch.utils.profiling import format_profile, profile_phases

    if fit3 is None:
        _, fit3, _ = run_fit(f"{label} states", device, n, chains,
                             "bart_sweep_batch", 4, 2, trees)
    t0 = time.perf_counter()
    p = profile_phases(fit3.prog, fit3.final_states, n_iter=3, repeats=1)
    print(f"{label}: profile_phases at n={n} chains={chains} trees={trees} "
          f"({time.perf_counter() - t0:.1f} s); {card()}\n"
          + format_profile(p), flush=True)
    return p


# phase 12's trees: max_depth 8, the deep builds' 512-slot heaps (and
# max_depth 9, the 1024-slot ones).  12a's sweeps start from prior forests
# drawn with power 0.5 (p_split 0.95 / sqrt(1 + d)), under which a tree of
# 75 reaches depth 7 or 8 in most chains, and sweep under that prior
DEEP = dict(max_depth=8, power=0.5)
DEEP9 = dict(max_depth=9, power=0.5)
DEEP_PAD = 512


def depth_note(feature, at=7):
    """(the deepest active node's depth, the active nodes at depth >=
    ``at``, their share of the active nodes) of a (C, T, M) forest."""
    from stan4bart_torch.ops.bart import INACTIVE

    act = feature != INACTIVE
    used = act.flatten(0, 1).any(0).nonzero()[:, 0]
    deepest = int(used.max() + 1).bit_length() - 1
    deep = int(act[..., 2 ** at - 1:].sum())
    return deepest, deep, deep / max(int(act.sum()), 1)


def kernels_at_shape(device, label, N, C, kernels, seed, T=75,
                     weighted=False, times=False, reps=7, cfg_kw=DEEP,
                     dtype=torch.float32):
    """Phase 12a (and 13a) at N x C chains: each kernel of ``kernels``
    (name -> (launcher, wrapper)) in its build for ``cfg_kw``'s heap
    (512-slot heaps at max_depth 8, 1024-slot at 9, 128 at the default
    depth 6) and for ``dtype`` at the K it picks, with p_regrow 0 and 1
    against the plain sweep on the same variates (identical forests and
    leaf indices in all chains but at most one, as phase 2: the plain
    sweep's leaf sums on the card are atomics in no fixed order, so a
    decision on a near tie may go either way between runs), the kernels
    equal to the bit at the largest K they picked (a kernel that picked a
    smaller one runs again at it); every regrow gate shut equal to
    p_regrow 0 to the bit; past depth 6 from a prior forest that reaches
    depth 7 (past depth 9, depth 10; its deepest node and nodes at or
    past that depth printed).
    ``weighted``: observation weights in [0.5, 2).  With ``times`` the
    kernels' CUDA-event
    times at p_regrow 0 and 1 and the plain sweep's at 0.  Returns the
    largest error, the Ks and times."""
    from stan4bart_torch.ops.bart import node_pad
    from stan4bart_torch.ops.bart_sweep_kernel import sweep_plain

    cfg, state, yt, args = sweep_args(N, T, C, seed, device, dtype,
                                      **cfg_kw)
    deep = cfg.max_depth > 6
    at = 10 if cfg.max_depth > 9 else 7
    if args[-1].node_pad != node_pad(cfg) or deep != (node_pad(cfg) > 128):
        raise AssertionError(f"{label}: heap {args[-1].node_pad} slots")
    deepest, n7, share = depth_note(state.feature, at)
    tag = (f"{label}{' float64' if dtype == torch.float64 else ''} "
           f"max_depth {cfg.max_depth} ({args[-1].node_pad}-slot "
           f"heaps) n={N} chains={C}" + (" weighted" if weighted else ""))
    if deep:
        print(f"{tag}: the starting forest's deepest node at depth "
              f"{deepest}, {n7} nodes at depth >= {at} ({100 * share:.2f} % "
              "of its active nodes)", flush=True)
        if deepest < at:
            raise AssertionError(f"{tag}: the starting forest stops at "
                                 f"depth {deepest}")
    w = None
    if weighted:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 200)
        w = (0.5 + 1.5 * torch.rand(N, generator=gen,
                                    device=device)).to(dtype)
    on, rg = regrow_args(args, 1.0, seed + 100)
    shut, rg_shut = regrow_args(args, 0.5, seed + 100, shut=True)
    out, ks, err, after = {}, {}, 0.0, {}
    for p, a, r in (("0", args, None), ("1", on, rg)):
        outs = {}
        for name, (launch, wrapper) in kernels.items():
            outs[name] = launch(*a, weights=w, rg=r)
            ks[name] = wrapper.last_cluster
            if p == "0":
                closed = launch(*shut, weights=w, rg=rg_shut)
                torch.cuda.synchronize()
                if not all(torch.equal(x, y)
                           for x, y in zip(outs[name], closed)):
                    raise AssertionError(f"{tag}: {name} with every regrow "
                                         "gate shut differs from p_regrow 0")
        outs["plain"] = sweep_plain(*a, weights=w, rg=r)
        torch.cuda.synchronize()
        res = check_sweep(f"{tag} p_regrow {p}", outs, state, yt, C, N, T,
                          C - 1)
        kmax = max(ks.values())
        ref = next(x for x in kernels if ks[x] == kmax)
        for x in kernels:
            same = outs[x]
            if ks[x] != kmax:
                same = kernels[x][0](*a, weights=w, rg=r, cluster=kmax)
                torch.cuda.synchronize()
            if not all(torch.equal(i, j) for i, j in zip(outs[ref], same)):
                raise AssertionError(f"{tag} p_regrow {p}: {x} at K={kmax} "
                                     f"not equal to {ref} to the bit")
            if ks[x] != kmax:
                print(f"{tag} p_regrow {p}: {x} forced to K={kmax} equals "
                      f"{ref} to the bit", flush=True)
        err = max(err, *(v[1] for v in res.values()))
        after[p] = depth_note(outs["plain"][0], at)
        del outs
    print(f"{tag}: "
          + ", ".join(f"{k} (K={v})" for k, v in ks.items())
          + f" against the plain sweep at p_regrow 0 and 1 as above (at "
          f"K={max(ks.values())} equal to each other to the bit), and with "
          "every gate "
          "shut equal to p_regrow 0 to the bit"
          + (f"; after the sweep the deepest node at depth {after['0'][0]} "
             f"/ {after['1'][0]}, {after['0'][1]} / {after['1'][1]} nodes "
             f"at depth >= {at} (p_regrow 0 / 1)" if deep else ""),
          flush=True)
    out.update(err=err, clusters=ks, start_deep=n7, deepest=deepest)
    if times:
        for name, (launch, _) in kernels.items():
            for p, a, r in (("0", args, None), ("1", on, rg)):
                ms, all_ms = _time(lambda: launch(*a, weights=w, rg=r), reps)
                out[f"{name}_ms_{p}"] = ms
                out[f"{name}_all_{p}"] = all_ms
        out["plain_ms"] = _time(lambda: sweep_plain(*args, weights=w), 3)[0]
    return out


def phase_deep_kernels(device, full=None, regrow=None, reps=7):
    """Phase 12a: the one-launch kernels' builds for 512-slot heaps at
    max_depth 8 against the plain sweep at the bench shape (timed, with
    the bound at M = 511, beside the depth-6 times of phases 2 and 11a
    when they ran: ``full``, ``regrow``) and at the main paths' shapes
    (10 000 x 128; 50 000 x 32, weighted, where the obs-tiled kernel also
    runs at K = 1 with its residual in device memory), and the builds for
    1024-slot heaps at max_depth 9 at 10 000 x 128 and 30 000 x 32."""
    from functools import partial

    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled, kernel_smem, sweep_chain_cuda,
        sweep_cuda, sweep_tiled_cuda)

    C, N, T, M = 256, 10_000, 75, 511
    three = {"batch": (sweep_cuda, bart_sweep_fused_batch),
             "tiled": (sweep_tiled_cuda, bart_sweep_fused_batch_tiled),
             "chain": (sweep_chain_cuda, bart_sweep_fused)}
    bench = kernels_at_shape(device, "phase 12a", N, C, three, 3, T,
                             times=True, reps=reps)
    at128 = kernels_at_shape(device, "phase 12a", N, 128,
                             {k: three[k] for k in ("batch", "chain")}, 6, T)
    if kernel_smem("bart_sweep_tiled", 50_000, T, 1, True,
                   DEEP_PAD)["resid_on_chip"]:
        raise AssertionError("phase 12a: the deep obs-tiled kernel at "
                             "50 000 rows a block keeps the residual on "
                             "chip; its streaming kernel would go "
                             "unchecked")
    at50k = kernels_at_shape(
        device, "phase 12a", 50_000, 32,
        {"tiled": three["tiled"], "chain": three["chain"],
         "tiled streamed": (partial(sweep_tiled_cuda, cluster=1),
                            bart_sweep_fused_batch_tiled)},
        7, T, weighted=True)
    # the 1024-slot build (max_depth 9): at phases 6-9's shape, and
    # weighted at 30 000 x 32, on chip and at K = 1 streamed
    if kernel_smem("bart_sweep_tiled", 30_000, T, 1, True,
                   1024)["resid_on_chip"]:
        raise AssertionError("phase 12a: the depth-9 obs-tiled kernel at "
                             "30 000 rows a block keeps the residual on "
                             "chip")
    at9 = [kernels_at_shape(device, "phase 12a", N, 128,
                            {k: three[k] for k in ("batch", "chain")}, 12,
                            T, cfg_kw=DEEP9),
           kernels_at_shape(device, "phase 12a", 30_000, 32,
                            {"tiled": three["tiled"],
                             "tiled streamed": (
                                 partial(sweep_tiled_cuda, cluster=1),
                                 bart_sweep_fused_batch_tiled)},
                            13, T, weighted=True, cfg_kw=DEEP9)]
    print("phase 12a " + "; ".join(
        smem_note(f"bart_sweep_{k}", N, T, at9[0]["clusters"][k], r, 1024)
        for k in ("batch", "chain") for r in (False, True)), flush=True)
    for name in ("bart_sweep_tiled", "bart_sweep_chain"):
        print("phase 12a " + smem_note(name, 50_000, T,
                                       at50k["clusters"][name[11:]], True,
                                       DEEP_PAD), flush=True)
    print("phase 12a " + smem_note("bart_sweep_tiled", 50_000, T, 1, True,
                                   DEEP_PAD), flush=True)
    print("phase 12a " + "; ".join(
        smem_note(f"bart_sweep_{k}", N, T, bench["clusters"][k], r,
                  DEEP_PAD) for k in three for r in (False, True)),
        flush=True)
    nbytes = sweep_bytes(C, T, N, M, DEEP_PAD)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound1_ms = (nbytes + regrow_bytes(C, T, M)) / HBM_BYTES_PER_S * 1e3
    depth6 = {"batch": (full or {}).get("ms"),
              "tiled": (full or {}).get("tiled_ms"),
              "chain": (full or {}).get("chain_ms")}
    lines = "; ".join(
        f"{k} (K={bench['clusters'][k]}) p_regrow 0 / 1: "
        f"{bench[k + '_ms_0']:.4f} / {bench[k + '_ms_1']:.4f} ms"
        + ("" if depth6[k] is None else
           f" (depth 6: {depth6[k]:.4f}"
           + ("" if regrow is None else
              f" / {regrow[k + '_ms_1']:.4f}") + " ms)")
        for k in three)
    print(f"phase 12a times at max_depth 8, n={N} chains={C} trees={T}, "
          f"median of {reps}: {lines}; plain sweep at p_regrow 0 "
          f"{bench['plain_ms']:.4f} ms; bound {bound_ms:.4f} ms "
          f"({nbytes / 1e9:.4f} GB at {HBM_BYTES_PER_S / 1e12} TB/s, "
          f"M = {M}, {DEEP_PAD} leaf normals a tree), with the move "
          f"{bound1_ms:.4f} ms; {card()}", flush=True)
    return dict(bench, bound_ms=bound_ms, bound1_ms=bound1_ms,
                max_abs_err=max(bench["err"], at128["err"], at50k["err"],
                                *(r["err"] for r in at9)))


def fit_quality(d, fit):
    """The numbers phase 12b compares at depth 8 and 6: cor(indiv.bart,
    truth), sigma, SATE, the test frame's RMSE against the truth (the
    counterfactual means), the final forests' share of active nodes at
    depth >= 7 and the sweep seconds."""
    z = d["z"]
    ev_test = fit.fitted("ev", sample="test")
    truth = np.where(z == 1, d["mu_0"], d["mu_1"])
    return dict(
        cor=centered_cor(fit.fitted("indiv.bart"), d["mu_bart"]),
        sigma=float(fit.fitted("sigma")),
        sate=float(np.mean((fit.fitted("ev") - ev_test) * (2 * z - 1))),
        rmse=float(np.sqrt(np.mean((ev_test - truth) ** 2))),
        deep_share=depth_note(fit.final_states.bart.feature)[2],
        sweep_s=fit.timings["sweep"])


def quality_line(q):
    return (f"cor {q['cor']:.4f}, sigma {q['sigma']:.4f}, SATE "
            f"{q['sate']:.4f}, test-frame RMSE {q['rmse']:.4f}, nodes at "
            f"depth >= 7 {100 * q['deep_share']:.3f} %, sweep "
            f"{q['sweep_s']:.2f} s")


def phase_deep_fit(device, label="phase 12b", n=10_000, chains=128,
                   iters=150, warmup=75, trees=75):
    """Phase 12b: the phase 3 fit (at 128 chains) with max_depth 8, every
    sweep through the single-pass kernel's build for 512-slot heaps: the
    gaussian gates and SATE within 0.1 of the truth.  Returns the
    launches and its ``fit_quality``."""
    from stan4bart_torch.ops.bart_sweep_kernel import bart_sweep_fused_batch

    d, fit, launches = run_fit(label, device, n, chains, "bart_sweep_batch",
                               iters, warmup, trees,
                               bart_args={"n_trees": trees, "max_depth": 8})
    deep = bart_sweep_fused_batch.deep_launches
    finite_draws(label, fit)
    if fit.prog.sweep_consts.node_pad != DEEP_PAD or deep != launches:
        raise AssertionError(f"{label}: {deep} of {launches} launches ran "
                             "the deep build")
    q = fit_quality(d, fit)
    check_gates(label, q["cor"], q["sigma"], "bart_sweep_batch", launches,
                iters)
    print(f"{label}: max_depth 8, {deep} launches of the 512-slot build "
          f"(the plain sweep none: every sweep is a kernel launch); "
          f"{quality_line(q)}; SATE truth {d['tau']}, within 0.1",
          flush=True)
    if abs(q["sate"] - d["tau"]) >= 0.1:
        raise AssertionError(f"{label}: SATE gate failed")
    return launches, q


# phase 15: simulation-based calibration of the composed sampler
# (stan4bart_torch/utils/sbc.py) at the reps and seed of SBC_r05.json
SBC_REPS = 160
SBC_SEED = 20260819
SBC_15A = ("kernel_f32", "kernel_f32_probit")
SBC_15B = ("kernel_f32_tiled", "kernel_f32/chain", "continuous", "probit",
           "weights", "qr", "lkj", "interweave", "leaf_block")
# (warmup, iterations) of 15a's cells in the default run: half of
# SBC_r05.json's (300, 495), so that the script stays in its time (L 49,
# 10 bins of 5 ranks each); 15b's cells run the full budget
SBC_15A_BUDGET = (150, 245)
# every quantity's p above tests/test_sbc.py:28-41's gate (a fixed-seed
# run of about 22 quantities fails it by chance well under 1 % of the
# time); p under the artifact's alpha is marked on the cell's line
SBC_GATE = 1e-4
SBC_ALPHA = 1e-3


def sbc_kernel(spec):
    """The sweep kernel every sweep of SBC cell ``spec`` (``<cell>`` or
    ``<cell>/chain``) launches: the per-chain one on the per-chain driver,
    the obs-tiled one where the cell forces it, else the single-pass
    one (the float64 cells its double build)."""
    from stan4bart_torch.utils.sbc import CELLS

    cell, _, driver = spec.partition("/")
    if driver == "chain":
        return "bart_sweep_chain"
    return "bart_sweep_tiled" if CELLS[cell].get("tiled") else \
        "bart_sweep_batch"


def sbc_hold(device, label, specs):
    """Each kernel the SBC cells ``specs`` sweep through, in each dtype
    they run, against the plain sweep at their shape (n = 100, 160 chains,
    8 trees of max_depth 3, 50 cuts); the largest error by kernel."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        _LAUNCH, bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled)
    from stan4bart_torch.utils.sbc import CELLS, DTYPES, N_OBS

    wrappers = {"bart_sweep_batch": bart_sweep_fused_batch,
                "bart_sweep_tiled": bart_sweep_fused_batch_tiled,
                "bart_sweep_chain": bart_sweep_fused}
    by_dtype = {}
    for spec in specs:
        k = sbc_kernel(spec)
        dt = DTYPES[CELLS[spec.partition("/")[0]].get("dtype", "float64")]
        by_dtype.setdefault(dt, {})[k] = (_LAUNCH[k], wrappers[k])
    err = {}
    for dt, kernels in by_dtype.items():
        tag = "float64" if dt == F64 else "float32"
        res = hold_at_path_shape(device, f"{label} {tag}", N_OBS, SBC_REPS,
                                 kernels, seed=15, T=8, dtype=dt,
                                 max_depth=3, n_cuts=50)
        for k, e in res.items():
            err[k if dt != F64 else f"{k}_f64"] = e
    return err


def sbc_cell(device, label, spec, budget=None):
    """SBC cell ``spec`` at SBC_REPS reps (``utils.sbc.run_cell``: one
    program of SBC_REPS chains, each fitting its own simulated data) and
    ``budget`` (warmup, iterations; the harness's by default), every
    sweep a launch of its kernel (``sbc_kernel``; the float64 cells every
    one of its double build).  Returns the harness's record with the
    kernel, its launches, the driver and the budget."""
    from stan4bart_torch.utils import sbc

    cell, _, driver = spec.partition("/")
    warmup, iters = budget or (sbc.WARMUP, sbc.ITERS)
    counts = reset_counts()
    out = sbc.run_cell(spec, sbc.CELLS[cell], SBC_REPS, SBC_SEED,
                       device=device, driver=driver or "batched",
                       warmup=warmup, iters=iters)
    kernel = sbc_kernel(spec)
    launches = check_launches(f"phase 15 {spec}", counts, kernel,
                              warmup + iters + 1)
    f64 = counts[kernel].f64_launches
    if f64 != (launches if sbc.CELLS[cell].get("dtype") is None else 0):
        raise AssertionError(f"phase 15 {spec}: {f64} of {launches} "
                             "launches ran the float64 build")
    out.update(driver=driver or "batched", kernel=kernel,
               launches=launches, f64_launches=f64, warmup=warmup,
               iters=iters)
    print(sbc_line(label, out), flush=True)
    return out


def sbc_line(label, out):
    """One line of a cell's record: every quantity's chi2, p and counts
    (a p under SBC_ALPHA marked ``<alpha``), min_p and the wall."""
    t = ", ".join(f"{k} {v}" for k, v in out["timings"].items())
    n = ", ".join(f"{k} {v}" for k, v in out["nuts"].items())
    qs = "; ".join(
        f"{q} chi2 {v['chi2']} p {v['p']:.4g}"
        + (" <alpha" if v["p"] < SBC_ALPHA else "") + f" {v['counts']}"
        for q, v in out["quantities"].items())
    return (f"{label} SBC {out['cell']}: {out['reps']} reps, warmup "
            f"{out['warmup']}, {out['iters']} iterations, L {out['L']}, "
            f"{out['launches']} launches of {out['kernel']}"
            + (" (float64 build)" if out["f64_launches"] else "")
            + f"; {qs}; min_p {out['min_p']:.4g} (gate p > {SBC_GATE}, "
            f"alpha {SBC_ALPHA}); wall {out['wall_s']} s, fit s {t}; "
            f"sampling NUTS {n}; {card()}")


def hold_graph(prog, st, gen):
    """``prog``'s graphed Gram log-density (``models/parametric.py``
    ``GramGraph``) against its eager form at state ``st``'s anchor, at
    its q and at 3 points about it: whether value and gradient are equal
    to the bit everywhere, and the largest relative difference."""
    from stan4bart_torch.ops.nuts import value_and_grad

    y_stan = st.latents if prog.is_binary else prog.y
    logp = prog._logp(st.nuts.q, st.stan_offset, y_stan)
    same, err = True, 0.0
    for k in range(4):
        q = st.nuts.q + 0.1 * k * torch.randn(
            st.nuts.q.shape, generator=gen, dtype=prog.dtype,
            device=st.nuts.q.device)
        got = logp.replay(q)
        want = value_and_grad(lambda u: logp(u), q)
        for a, b in zip(got, want):
            same = same and torch.equal(a, b)
            err = max(err, float(((a - b).abs()
                                  / b.abs().clamp(min=1.0)).max()))
    return same, err


def graph_check(label, fit):
    """``hold_graph`` on ``fit``'s own program at a first state
    (``init_state``, seed 11) and at the fit's final states; raises
    unless the graph equals the eager form to the bit at both."""
    prog = fit.prog
    if not prog.use_gram or prog.pm.num_upars == 0:
        return
    C = fit.final_states.nuts.q.shape[0]
    gen = torch.Generator(device=prog.device)
    gen.manual_seed(11)
    first = prog.init_state(gen, C)
    res = [hold_graph(prog, st, gen) for st in (first, fit.final_states)]
    print(f"{label}: the graphed Gram log-density and gradient at "
          f"{C} chains, {prog.dtype}, against the eager form at the first "
          "and final states: equal to the bit "
          f"{[r[0] for r in res]}, max relative difference "
          f"{max(r[1] for r in res):.3g}", flush=True)
    if not all(r[0] for r in res):
        raise AssertionError(f"{label}: the graphed log-density differs "
                             "from the eager one")


def gram_graph_check(device, label, specs):
    """``hold_graph`` at each cell's shape (160 chains of its simulated
    data, at its first state); raises unless equal to the bit."""
    from stan4bart_torch.utils import sbc

    worst = {}
    for spec in specs:
        cell = sbc.CELLS[spec.partition("/")[0]]
        _, pm, prog, _ = sbc.build_cell(cell, seed=SBC_SEED, device=device)
        rng = np.random.default_rng(SBC_SEED)
        _, _, prog.y = sbc.simulate(pm, prog, cell["binary"], rng, SBC_REPS)
        gen = torch.Generator(device=device)
        gen.manual_seed(SBC_SEED)
        same, worst[spec] = hold_graph(prog, prog.init_state(gen, SBC_REPS),
                                       gen)
        if not same:
            raise AssertionError(f"{label} {spec}: the graphed log-density "
                                 f"differs from the eager one by "
                                 f"{worst[spec]:.3g}")
    print(f"{label}: the graphed Gram log-density and gradient against the "
          "eager form at 160 chains equal to the bit in "
          + ", ".join(worst), flush=True)
    return worst


def phase_sbc(device, label, specs):
    """Phase 15a / 15b in this process: ``sbc_hold`` of the cells'
    kernels and ``gram_graph_check`` at their shapes, then each cell
    (``sbc_cell``; 15a's at SBC_15A_BUDGET).  Returns (the hold's errors,
    the cells' records)."""
    err = sbc_hold(device, label, specs)
    gram_graph_check(device, label, specs)
    budget = SBC_15A_BUDGET if label == "phase 15a" else None
    return err, [sbc_cell(device, label, s, budget) for s in specs]


def start_groups(phase, jobs):
    """Phase ``phase``'s ``jobs`` (15a's or 15b's SBC cells, 16a's or 16b's
    harness runs) split over child processes, one a job up to two fewer
    than the host's cores, each running the phase on its share side by
    side (every job is host-bound); ``join_sbc`` or ``join_quality``
    collects them."""
    workers = min(len(jobs), max(1, (os.cpu_count() or 1) - 2))
    groups = [jobs[i::workers] for i in range(workers)]
    return [start_fit(phase, f"phase {phase}", g) for g in groups]


def join_sbc(label, children, gate, paths, out=None):
    """The children's records (into ``out`` by ``write_sbc`` when given)
    and their launches into ``paths``; raises (after writing) when
    ``gate`` or ``out`` and a quantity's p is at most SBC_GATE.  Returns
    the kernels' largest errors against plain at the SBC shape."""
    err, records = {}, []
    for child in children:
        e, r = join_fit(child, timeout_s=3000)
        err.update({k: max(v, err.get(k, 0.0)) for k, v in e.items()})
        records += r
    if out is not None:
        write_sbc(out, records)
    launches, bad = sbc_report(label, err, records)
    for k, v in launches.items():
        paths.setdefault(k, {})[label] = v
    if bad and (gate or out is not None):
        raise AssertionError(f"{label}: SBC ranks non-uniform: "
                             + "; ".join(bad))
    return err


def sbc_report(label, err, records):
    """The launches by kernel of the cells' records and the quantities
    at p at most SBC_GATE; prints the kernels' errors against plain and
    each cell's min_p."""
    launches, bad = {}, []
    for out in records:
        key = out["kernel"] + ("_f64" if out["f64_launches"] else "")
        launches[key] = launches.get(key, 0) + out["launches"]
        bad += [f"{out['cell']} {q} p {v['p']:.3g} {v['counts']}"
                for q, v in out["quantities"].items() if v["p"] <= SBC_GATE]
    print(f"{label}: kernels at the SBC shape against plain, max error "
          + ", ".join(f"{k} {v:.3g}" for k, v in err.items()) + "; min_p "
          + ", ".join(f"{r['cell']} {r['min_p']:.4g}" for r in records),
          flush=True)
    return launches, bad


def write_sbc(path, records):
    """``records`` into ``path`` in SBC_r05.json's schema with the card's
    name and power limit, beside the cells of earlier runs that
    ``SBC_torch_h100.json`` at the root holds (a cell run again is
    replaced)."""
    from stan4bart_torch.utils.sbc import BINS, L

    cells = {}
    if os.path.exists("SBC_torch_h100.json"):
        with open("SBC_torch_h100.json") as fh:
            cells = {c["cell"]: c for c in json.load(fh)["cells"]}
    cells.update({r["cell"]: r for r in records})
    out = {"harness": "sbc", "reps": SBC_REPS, "L": L, "bins": BINS,
           "alpha": SBC_ALPHA, "seed": SBC_SEED, "card": card(),
           "cells": list(cells.values()),
           "all_pass": all(c["pass"] for c in cells.values())}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"phase 15b: {len(records)} cells written to {path} "
          f"({len(cells)} in all)", flush=True)


# phase 16: the statistical-quality and causal-study harnesses
# (stan4bart_torch/utils/quality.py, utils/ihdp_study.py) at their budgets
IHDP_REPS, IHDP_ITERS = 50, 1000
IHDP_JAX = "IHDP_synthetic_jax_cpu.json"
# the records of earlier 16b runs at the root, which a run adds to
QUALITY_JSON = "QUALITY_torch_h100.json"
IHDP_JSON = "IHDP_synthetic_torch_h100.json"
QUALITY_16B = ("weighted", "rmse", "probit", "plain", "interweave")
# (warmup, iterations) of 16a's weighted fit in the default run: half of
# quality_chip.py's (300, 1000), so that the script stays in its time;
# its held-out fit and 16b's jobs run their harness's budget
QUALITY_16A_BUDGET = {"weighted": (150, 450)}
# the keys of a replication's line (benchmarks/ihdp_sim.py)
IHDP_KEYS = ("bias", "covered", "ci_length", "pehe", "pegste", "satt_est",
             "satt_truth", "rep")


def counted(label, fn, iters, weighted=False):
    """``fn()``, a harness's (record, fit), with the launch counts read
    around it: every sweep of the fit (``iters`` iterations and the first
    sweep) a launch of the single-pass kernel, every one with weights
    when ``weighted`` and none when not.  Returns the record with its
    launches and K."""
    counts = reset_counts()
    rec, fit = fn()
    kernel = counts["bart_sweep_batch"]
    launches = check_launches(label, counts, "bart_sweep_batch",
                              iters * fit.prog.skip_bart + 1)
    if kernel.weighted_launches != (launches if weighted else 0):
        raise AssertionError(f"{label}: {kernel.weighted_launches} of "
                             f"{launches} launches had weights")
    rec.update(launches=launches, weighted_launches=kernel.weighted_launches,
               cluster=kernel.last_cluster)
    return rec


def quality_job(device, job, budget=None):
    """One harness run of phase 16 in this process: a quality gate
    (``utils.quality.GATES``) at its harness's budget (a gaussian one at
    ``budget``, (warmup, iterations), where given) or ``ihdp:<rep>``, a
    replication of the synthetic IHDP study at IHDP_ITERS iterations.
    Returns its record with its launches, wall seconds and card."""
    from stan4bart_torch.utils import ihdp_study, quality

    t0 = time.perf_counter()
    if job.startswith("ihdp:"):
        rep = int(job[5:])
        rec = counted(f"phase 16 {job}", lambda: ihdp_study.synthetic_rep(
            rep, IHDP_ITERS, device), IHDP_ITERS)
    else:
        kw = {} if budget is None else dict(warmup=budget[0],
                                            iters=budget[1])

        def fit():
            rec = quality.run(job, device, **kw)
            return rec, rec.pop("fit")

        iters = kw.get("iters", {"rmse": quality.RMSE_ITER,
                                 "probit": quality.PROBIT_ITER}.get(
                                     job, quality.ITER))
        rec = counted(f"phase 16 {job}", fit, iters,
                      weighted=job == "weighted")
    rec.update(job_wall_s=round(time.perf_counter() - t0, 1), card=card())
    return rec


def phase_quality(device, label, jobs):
    """``quality_job`` of each of ``jobs`` in this process (phase 16a's
    weighted gates at QUALITY_16A_BUDGET and its held-out gate; a share
    of 16b's jobs); prints each quality record's values beside their
    limits.  Returns the records by job."""
    from stan4bart_torch.utils import quality

    budgets = QUALITY_16A_BUDGET if label == "phase 16a" else {}
    out = {}
    for job in jobs:
        rec = out[job] = quality_job(device, job, budgets.get(job))
        if not job.startswith("ihdp:"):
            budget = (f"{quality.CHAINS} chains, warmup {rec['warmup']} of {rec['iter']} "
                      "iterations; " if "iter" in rec else "")
            print(f"{label} {quality.report(rec)}; {budget}{rec['launches']} "
                  f"launches of bart_sweep_batch (K={rec['cluster']}, "
                  f"{rec['weighted_launches']} weighted), wall "
                  f"{rec['job_wall_s']} s, fit s {rec['timings']}; {card()}",
                  flush=True)
    return out


def join_quality(label, children, paths):
    """The children's records by job, their launches into ``paths``
    under ``label`` (``quality_failures`` reads their gates)."""
    records = {}
    for child in children:
        records.update(join_fit(child, timeout_s=3000))
    paths["bart_sweep_batch"][label] = sum(r["launches"]
                                           for r in records.values())
    return records


def jobs16(spec):
    """Phase 16b's jobs from ``--jobs16b``: comma-separated gates and
    ``ihdp:<rep>`` or ``ihdp:<first>-<last>``."""
    jobs = []
    for job in spec.split(","):
        first, _, last = job.partition("-")
        if job.startswith("ihdp:") and last:
            jobs += [f"ihdp:{r}" for r in range(int(first[5:]),
                                                 int(last) + 1)]
        else:
            jobs.append(job)
    return jobs


def earlier16():
    """The records by job of earlier 16b runs, from the root's
    QUALITY_JSON and IHDP_JSON where they exist."""
    records = {}
    if os.path.exists(QUALITY_JSON):
        with open(QUALITY_JSON) as fh:
            records.update(json.load(fh)["records"])
    if os.path.exists(IHDP_JSON):
        with open(IHDP_JSON) as fh:
            study = json.load(fh)
        runs = {r["rep"]: r for r in study["runs"]}
        records.update({f"ihdp:{row['rep']}": dict(runs[row["rep"]], **row)
                        for row in study["reps"]})
    return records


def quality_failures(records):
    return [job for job, r in records.items()
            if not job.startswith("ihdp:") and not r["all_pass"]]


def ihdp_compare(rows, path):
    """The port's synthetic study against the JAX package's record
    ``path`` over the replications both have: coverage within 3 binomial
    standard errors of a difference at their pooled rate, the mean paired
    difference of satt_est within 3 standard errors of 0, and mean PEHE
    within 10 %.  Returns (lines of each value beside its limit, whether
    all hold)."""
    with open(path) as fh:
        ref = {r["rep"]: r for r in json.load(fh)["reps"]}
    reps = sorted(set(ref) & {r["rep"] for r in rows})
    mine = {r["rep"]: r for r in rows}
    n = len(reps)
    cov = [float(np.mean([d[r]["covered"] for r in reps]))
           for d in (mine, ref)]
    pooled = (cov[0] + cov[1]) / 2
    se_cov = float(np.sqrt(pooled * (1 - pooled) * 2 / n))
    diff = np.array([mine[r]["satt_est"] - ref[r]["satt_est"] for r in reps])
    se_diff = float(diff.std(ddof=1) / np.sqrt(n))
    pehe = [float(np.mean([d[r]["pehe"] for r in reps]))
            for d in (mine, ref)]
    checks = [
        (f"coverage {cov[0]:.4f} vs the JAX study's {cov[1]:.4f}: "
         f"|difference| {abs(cov[0] - cov[1]):.4f} <= 3 x {se_cov:.4f}",
         abs(cov[0] - cov[1]) <= 3 * se_cov),
        (f"mean paired satt_est difference {diff.mean():.5f} within 3 x "
         f"{se_diff:.5f} of 0", abs(diff.mean()) <= 3 * se_diff),
        (f"mean PEHE {pehe[0]:.4f} vs the JAX study's {pehe[1]:.4f}: "
         f"within 10 % ({abs(pehe[0] / pehe[1] - 1):.4f})",
         abs(pehe[0] - pehe[1]) <= 0.1 * pehe[1]),
    ]
    return ([f"{n} paired reps"] + [f"{t} {'PASS' if ok else 'FAIL'}"
                                    for t, ok in checks],
            all(ok for _, ok in checks))


def write_quality16(records, quality_out, ihdp_out):
    """Phase 16's records: the quality gates (and the probit record in
    PROBIT_QUALITY_r05.json's schema) into ``quality_out``, the synthetic
    study's rows and aggregate into ``ihdp_out``, each run with the name
    and power limit of the card it ran on.  Returns the study's rows."""
    from stan4bart_torch.utils import ihdp_study

    gates = {job: r for job, r in records.items()
             if not job.startswith("ihdp:")}
    runs = sorted((r for job, r in records.items()
                   if job.startswith("ihdp:")), key=lambda r: r["rep"])
    rows = [{k: r[k] for k in IHDP_KEYS} for r in runs]
    for path, obj in ((quality_out, {
            "harness": "stan4bart_torch.utils.quality", "card": card(),
            "records": gates,
            "all_pass": all(r["all_pass"] for r in gates.values())}),
            (ihdp_out, {
                "harness": "stan4bart_torch.utils.ihdp_study --synthetic",
                "card": card(), "n_reps": len(rows), "iters": IHDP_ITERS,
                "reps": rows,
                "runs": [{k: r[k] for k in ("rep", "launches", "cluster",
                                            "job_wall_s", "card")}
                         for r in runs],
                "aggregate": ihdp_study.aggregate(
                    rows, "IHDP-synthetic aggregate", len(rows))})):
        if path is None or not obj.get("reps", obj.get("records")):
            continue
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(obj, fh, indent=1)
        print(f"phase 16: written to {path}", flush=True)
    return rows


def phase_study_report(records, quality_out, ihdp_out):
    """Phase 16b's end: the records written (``write_quality16``), the
    study's aggregate and its paired comparison with the JAX package's
    (``ihdp_compare``) printed; raises, after writing, when a quality
    gate or the comparison failed."""
    from stan4bart_torch.utils import ihdp_study

    rows = write_quality16(records, quality_out, ihdp_out)
    agg = ihdp_study.aggregate(rows, "IHDP-synthetic aggregate", len(rows))
    walls = [r["job_wall_s"] for r in records.values() if "rep" in r]
    lines, ok = ihdp_compare(rows, IHDP_JAX)
    print(f"phase 16b IHDP synthetic study, {len(rows)} reps x "
          f"{IHDP_ITERS} iterations (2 chains, single-pass kernel): "
          + json.dumps(agg) + f"; rep walls {min(walls)}-{max(walls)} s; "
          + "; ".join(lines) + f"; {card()}", flush=True)
    bad = quality_failures(records)
    if bad or not ok:
        raise AssertionError("phase 16b: " + ", ".join(
            bad + ([] if ok else ["IHDP comparison with the JAX study"])))


def _fit_child(out_q, phase, args):
    """Host-bound fit phase ``phase`` ("6", "8", "12b", "13b", "14b", "15a"
    or "15b") in a process of its own (``start_fit``), with ``args`` after
    the device: puts ("ok", its result) or ("error", traceback) on
    out_q."""
    import traceback

    from stan4bart_torch.utils.device import resolve_device

    try:
        fn = {"6": phase_chain, "8": phase_all_options,
              "12b": phase_deep_fit, "13b": phase_f64_fit,
              "14b": phase_heap_fit, "15a": phase_sbc,
              "15b": phase_sbc, "16a": phase_quality,
              "16b": phase_quality}[phase]
        out_q.put(("ok", fn(resolve_device("cuda"), *args)))
    except BaseException:
        out_q.put(("error", traceback.format_exc()))


def start_fit(phase, *args):
    """Fit phase ``phase`` started in a child process, so that its
    host-bound fit runs beside another phase's (12b, 13b and 14b beside
    phase 11c's, the same fit at depth 6 and in float32, their
    comparator, all under the same load; 6 beside 5 and 8 beside 7 to
    keep the script in its time); ``join_fit`` collects it."""
    ctx = torch.multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    proc = ctx.Process(target=_fit_child, args=(out_q, phase, args),
                       daemon=True)
    proc.start()
    return phase, proc, out_q


def join_fit(child, timeout_s=900):
    """A child fit phase's result; raises with the child's traceback when
    it failed.  The child is stopped either way."""
    import queue

    phase, proc, out_q = child
    try:
        status, value = out_q.get(timeout=timeout_s)
    except queue.Empty:
        raise TimeoutError(f"phase {phase} did not finish in {timeout_s} s")
    finally:
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join(5)
    if status != "ok":
        raise RuntimeError(f"phase {phase} failed:\n{value}")
    return value


def deep_entries(deep, sharded, launches, paths, heap=None):
    """The kernels line's entries of the builds for 512-slot heaps
    (phase 12a's numbers at max_depth 8; launches of the deep builds on
    the main paths: phase 12b's fit), with the 1024-slot builds' times
    and bound at max_depth 9 (phase 14a's) when ``heap`` is given."""
    bench = sweep_bytes(256, 75, 10_000, 511, DEEP_PAD)
    out = []
    for k, src, line in (("batch", "bart_sweep_batch", 859),
                         ("tiled", "bart_sweep_tiled", 1495),
                         ("chain", "bart_sweep_chain", 596)):
        at9 = {} if heap is None else {
            "ms_depth9": heap["depth9"][f"{k}_ms_0"],
            "ms_depth9_p_regrow_1": heap["depth9"][f"{k}_ms_1"],
            "plain_ms_depth9": heap["depth9"]["plain_ms"],
            "bound_ms_depth9": heap["bound9_ms"],
            "bound_ms_depth9_p_regrow_1": heap["bound19_ms"],
            "cluster_depth9": heap["depth9"]["clusters"][k],
        }
        out.append({
            "name": f"{src}_deep",
            "route": "cuda",
            "source": f"stan4bart_torch/csrc/{src}.cu",
            # the 512-slot build of the port of this TPU kernel; the JAX
            # package sweeps such trees with XLA (ops/bart.py:717)
            "replaces": f"stan4bart_tpu/ops/bart_sweep_kernel.py:{line}",
            "launches": launches.get(f"{src}_deep", 0),
            "launches_by_path": paths.get(f"{src}_deep", {}),
            "max_abs_err": deep["max_abs_err"],
            "ms": deep[f"{k}_ms_0"],
            "kernel_ms": deep[f"{k}_ms_0"],
            "ms_p_regrow_1": deep[f"{k}_ms_1"],
            "plain_ms": deep["plain_ms"],
            "bound_ms": deep["bound_ms"],
            "bound_ms_p_regrow_1": deep["bound1_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "cluster": deep["clusters"][k],
            "bound_bytes": bench,
            **at9,
        })
    out.append({
        "name": "bart_sweep_sharded_deep",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_sharded.cu",
        "replaces": "stan4bart_tpu/ops/bart.py:717",
        "launches": launches.get("bart_sweep_sharded_deep", 0),
        "launches_by_path": paths.get("bart_sweep_sharded_deep", {}),
        "max_abs_err": sharded["deep_err"],
        "ms": sharded["deep_ms"],
        "kernel_ms": sharded["deep_ms"],
        "ms_p_regrow_1": sharded["deep_ms_1"],
        "plain_ms": sharded["deep_plain_ms"],
        "bound_ms": sharded["deep_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": sharded["deep_cluster"],
    })
    return out


# phase 13: float64 state, the kernels' double-precision builds
F64 = torch.float64


def phase_f64_kernels(device, full=None, regrow=None, reps=7):
    """Phase 13a: the one-launch kernels' float64 builds against the plain
    float64 sweep on the card on shared variates (drawn in float32 and
    widened, as the wrappers draw them): at the bench shape (timed at
    p_regrow 0 and 1 with the plain sweep, K, shared memory and the
    bound, beside the float32 times of phases 2 and 11a when they ran:
    ``full``, ``regrow``; the three equal to the bit, forced to one K
    where they pick different ones), at phases 6-9's 10 000 x 128, at
    phase 13b's small fits' shapes (the per-chain build at 2000 x 16, the
    obs-tiled one at 20 000 x 8, 20 trees), at 50 000 x 32 weighted
    (also the obs-tiled kernel at K = 1, its residual in device memory),
    the 512-slot builds at max_depth 8 and the
    1024-slot builds at max_depth 9 at 10 000 x 128; each at p_regrow 0
    and 1 with every gate shut equal to p_regrow 0 to the bit."""
    from functools import partial

    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled, kernel_smem, sweep_chain_cuda,
        sweep_cuda, sweep_tiled_cuda)

    C, N, T, M = 256, 10_000, 75, 127
    three = {"batch": (sweep_cuda, bart_sweep_fused_batch),
             "tiled": (sweep_tiled_cuda, bart_sweep_fused_batch_tiled),
             "chain": (sweep_chain_cuda, bart_sweep_fused)}
    streamed = (partial(sweep_tiled_cuda, cluster=1),
                bart_sweep_fused_batch_tiled)
    label = "phase 13a"
    bench = kernels_at_shape(device, label, N, C, three, 3, T, times=True,
                             reps=reps, cfg_kw={}, dtype=F64)
    at128 = kernels_at_shape(device, label, N, 128,
                             {k: three[k] for k in ("batch", "chain")}, 6, T,
                             cfg_kw={}, dtype=F64)
    # the shapes of phase 13b's small fits: the per-chain resume
    # (f64_resume) and the obs-tiled fit (f64_tiled_fit), 20 trees
    at_resume = kernels_at_shape(device, label, 2000, 16,
                                 {"chain": three["chain"]}, 14, 20,
                                 cfg_kw={}, dtype=F64)
    at_tiled = kernels_at_shape(device, label, 20_000, 8,
                                {"tiled": three["tiled"]}, 15, 20,
                                cfg_kw={}, dtype=F64)
    if kernel_smem("bart_sweep_tiled", 50_000, T, 1, True, 128,
                   F64)["resid_on_chip"]:
        raise AssertionError(f"{label}: the float64 obs-tiled kernel at "
                             "50 000 rows a block keeps the residual on "
                             "chip; its streaming kernel would go unchecked")
    at50k = kernels_at_shape(device, label, 50_000, 32,
                             {"tiled": three["tiled"],
                              "chain": three["chain"],
                              "tiled streamed": streamed},
                             7, T, weighted=True, cfg_kw={}, dtype=F64)
    deep8 = kernels_at_shape(device, label, N, 128, three, 12, T,
                             cfg_kw=DEEP, dtype=F64)
    # the 1024-slot float64 single-pass ceiling (5 760) is below 10 000
    deep9 = kernels_at_shape(device, label, N, 128,
                             {k: three[k] for k in ("tiled", "chain")}, 13,
                             T, cfg_kw=DEEP9, dtype=F64)
    notes = ([smem_note(f"bart_sweep_{k}", N, T, bench["clusters"][k], r,
                        dtype=F64) for k in three for r in (False, True)]
             + [smem_note(f"bart_sweep_{k}", 50_000, T,
                          at50k["clusters"][k], True, dtype=F64)
                for k in ("tiled", "chain")]
             + [smem_note("bart_sweep_tiled", 50_000, T, 1, True,
                          dtype=F64)]
             + [smem_note(f"bart_sweep_{k}", N, T, deep8["clusters"][k],
                          True, DEEP_PAD, F64) for k in three]
             + [smem_note(f"bart_sweep_{k}", N, T, deep9["clusters"][k],
                          True, 1024, F64) for k in ("tiled", "chain")])
    for note in notes:
        print(f"{label} {note}", flush=True)
    nbytes = sweep_bytes(C, T, N, M, dtype=F64)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound1_ms = (nbytes + regrow_bytes(C, T, M, F64)) / HBM_BYTES_PER_S * 1e3
    f32 = {"batch": ((full or {}).get("ms"), (regrow or {}).get("batch_ms_1")),
           "tiled": ((full or {}).get("tiled_ms"),
                     (regrow or {}).get("tiled_ms_1")),
           "chain": ((full or {}).get("chain_ms"),
                     (regrow or {}).get("chain_ms_1"))}
    lines = "; ".join(
        f"{k} (K={bench['clusters'][k]}) p_regrow 0 / 1: "
        f"{bench[k + '_ms_0']:.4f} / {bench[k + '_ms_1']:.4f} ms"
        + ("" if f32[k][0] is None else
           f" (float32: {f32[k][0]:.4f}"
           + ("" if f32[k][1] is None else f" / {f32[k][1]:.4f}") + " ms)")
        for k in three)
    print(f"{label} float64 times at n={N} chains={C} trees={T}, median of "
          f"{reps}: {lines}; batch at p_regrow 0 "
          f"{[round(t, 4) for t in bench['batch_all_0']]}; plain float64 "
          f"sweep at p_regrow 0 {bench['plain_ms']:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s: 24 B an observation and tree), "
          f"with the move {bound1_ms:.4f} ms; {card()}", flush=True)
    errs = [r["err"] for r in (bench, at128, at_resume, at_tiled, at50k,
                                deep8, deep9)]
    print(f"{label}: every float64 build within {F64_TOL['atol']} of the "
          f"plain float64 sweep (max |kernel - plain| {max(errs):.3g})",
          flush=True)
    return dict(bench, bound_ms=bound_ms, bound1_ms=bound1_ms,
                max_abs_err=max(errs), deep8=deep8["clusters"],
                deep9=deep9["clusters"])


def f64_resume(device, label="phase 13b resume", n=2000, chains=16,
               trees=20, iters=20, warmup=10):
    """A small float64 fit on the per-chain path (a callback) through
    ``save``, ``load(device="cuda")`` and ``continue_sampling``: the
    loaded fit's ``continue_sampling(10)``, whole and in chunks of 4,
    equal to the bit to the original's whole one; every sweep a launch of
    the per-chain kernel's float64 build.  Returns its launches."""
    import tempfile

    import stan4bart_torch
    from stan4bart_torch.ops.bart_sweep_kernel import bart_sweep_fused
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe, generate_friedman_data)

    df = friedman_dataframe(generate_friedman_data(n, ranef=True,
                                                   causal=True))
    counts = reset_counts()
    fit = stan4bart_torch.stan4bart(
        FLAGSHIP, df, treatment="z", chains=chains, iter=iters,
        warmup=warmup, seed=5, verbose=-1, device=device, dtype=F64,
        callback=lambda d: {"sigma": d["aux.1"]},
        stan_args={"max_treedepth": 4}, bart_args={"n_trees": trees})
    launches = check_launches(label, counts, "bart_sweep_chain", iters + 1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.pkl")
        fit.save(path)
        back = stan4bart_torch.Stan4bartFit.load(path, device=device)
    if not (back.prog.dtype == F64 and back.prog.device.type == "cuda"
            and back.final_states.bart.leaf_value.dtype == F64
            and back.final_states.bart.leaf_value.is_cuda):
        raise AssertionError(f"{label}: the loaded fit is not float64 on "
                             "the card")
    resumed = {}
    for which, f, kw in (("original", fit, {}), ("loaded", back, {}),
                         ("loaded, chunked", back, {"chunk_size": 4})):
        counts = reset_counts()
        resumed[which] = f.continue_sampling(10, **kw)
        launches += check_launches(f"{label} {which}", counts,
                                   "bart_sweep_chain", 10)
    f64 = bart_sweep_fused.f64_launches
    names = ("stan", "bart_train", "bart_test", "k")
    diffs = {w: resume_equal(resumed["original"], resumed[w], names)
             for w in ("loaded", "loaded, chunked")}
    print(f"{label}: float64 fit n={n} chains={chains} on the per-chain "
          f"path, saved, loaded on the card; continue_sampling(10) of the "
          "loaded fit against the original's whole one: " + "; ".join(
              f"{w}: max difference {d:.3g}, equal to the bit {same}"
              for w, (d, same) in diffs.items())
          + f"; {f64} float64 per-chain launches in the last resume",
          flush=True)
    if not all(same for _, same in diffs.values()) or f64 != 10:
        raise AssertionError(f"{label}: the float64 resume is not equal to "
                             "the bit")
    return launches


def f64_tiled_fit(device, label="phase 13b tiled", n=20_000, chains=8,
                  trees=20, iters=12, warmup=6):
    """A short float64 fit past the single-pass ceiling: every sweep a
    launch of the obs-tiled kernel's float64 build, finite draws.
    Returns its launches."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused_batch_tiled)

    _, fit, launches = run_fit(label, device, n, chains, "bart_sweep_tiled",
                               iters, warmup, trees, dtype=F64,
                               stan_args={"max_treedepth": 4})
    finite_draws(label, fit)
    if bart_sweep_fused_batch_tiled.f64_launches != launches:
        raise AssertionError(f"{label}: a sweep ran another build")
    return launches


def phase_f64_fit(device, label="phase 13b", n=10_000, chains=128,
                  iters=150, warmup=75, trees=75):
    """Phase 13b: the phase 3 fit (at 128 chains) with
    ``dtype=torch.float64``, every sweep a launch of the single-pass
    kernel's float64 build: the gaussian gates, SATE within 1 of the
    truth, every posterior-mean Sigma positive definite, and its
    ``fit_quality``; then ``f64_resume`` and ``f64_tiled_fit``.  Returns
    the float64 builds' launches by kernel and its ``fit_quality``."""
    from stan4bart_torch.ops.bart_sweep_kernel import bart_sweep_fused_batch

    d, fit, launches = run_fit(label, device, n, chains, "bart_sweep_batch",
                               iters, warmup, trees, dtype=F64)
    f64 = bart_sweep_fused_batch.f64_launches
    graph_check(label, fit)
    finite_draws(label, fit)
    if (fit.prog.dtype != F64 or f64 != launches
            or fit.final_states.bart.leaf_value.dtype != F64):
        raise AssertionError(f"{label}: {f64} of {launches} launches ran "
                             "the float64 build")
    q = fit_quality(d, fit)
    check_gates(label, q["cor"], q["sigma"], "bart_sweep_batch", launches,
                iters)
    eig = {k: float(np.linalg.eigvalsh(S.mean(-1)).min())
           for k, S in fit.extract("Sigma").items()}
    print(f"{label}: dtype float64, {f64} launches of the float64 "
          f"single-pass build (every sweep); {quality_line(q)}; SATE truth "
          f"{d['tau']}, within 1; smallest eigenvalue of the posterior-mean "
          "Sigma by term: " + ", ".join(f"{k} {v:.4g}"
                                        for k, v in eig.items()),
          flush=True)
    if abs(q["sate"] - d["tau"]) >= 1.0 or min(eig.values()) <= 0:
        raise AssertionError(f"{label}: SATE or Sigma gate failed")
    del fit
    paths = {"bart_sweep_batch_f64": launches,
             "bart_sweep_chain_f64": f64_resume(device),
             "bart_sweep_tiled_f64": f64_tiled_fit(device)}
    return paths, q


def f64_entries(f64, sharded, launches, paths):
    """The kernels line's entries of the float64 builds (phase 13a's
    numbers at the bench shape; launches of the float64 builds on the
    main paths: phase 13b's fits)."""
    bench = sweep_bytes(256, 75, 10_000, 127, dtype=F64)
    out = []
    for k, src, line in (("batch", "bart_sweep_batch", 859),
                         ("tiled", "bart_sweep_tiled", 1495),
                         ("chain", "bart_sweep_chain", 596)):
        out.append({
            "name": f"{src}_f64",
            "route": "cuda",
            "source": f"stan4bart_torch/csrc/{src}.cu",
            # the float64 build of the port of this TPU kernel; the JAX
            # package sweeps float64 with XLA (stan4bart_tpu/fit.py:447)
            "replaces": f"stan4bart_tpu/ops/bart_sweep_kernel.py:{line}",
            "launches": launches.get(f"{src}_f64", 0),
            "launches_by_path": paths.get(f"{src}_f64", {}),
            "max_abs_err": f64["max_abs_err"],
            "ms": f64[f"{k}_ms_0"],
            "kernel_ms": f64[f"{k}_ms_0"],
            "ms_p_regrow_1": f64[f"{k}_ms_1"],
            "plain_ms": f64["plain_ms"],
            "bound_ms": f64["bound_ms"],
            "bound_ms_p_regrow_1": f64["bound1_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "cluster": f64["clusters"][k],
            "bound_bytes": bench,
        })
    out.append({
        "name": "bart_sweep_sharded_f64",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_sharded.cu",
        "replaces": "stan4bart_tpu/ops/bart.py:717",
        "launches": launches.get("bart_sweep_sharded_f64", 0),
        "launches_by_path": paths.get("bart_sweep_sharded_f64", {}),
        "max_abs_err": sharded["f64_err"],
        "ms": sharded["f64_ms"],
        "kernel_ms": sharded["f64_ms"],
        "ms_p_regrow_1": sharded["f64_ms_1"],
        "plain_ms": sharded["f64_plain_ms"],
        "bound_ms": sharded["f64_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": sharded["f64_cluster"],
    })
    return out


# phase 14: trees of max_depth 10 and deeper, whose sweeps are the kernels'
# heap builds (per-tree state in device memory).  Priors under which the
# forests reach the depth: base 0.99 with power 0.25 at depth 10 (and in
# 14b's fits), power 0.1 at 12 and 15
HEAP_PRIOR = dict(base=0.99, power=0.25)
HEAP10 = dict(max_depth=10, **HEAP_PRIOR)
HEAP12 = dict(max_depth=12, base=0.99, power=0.1)
HEAP15 = dict(max_depth=15, base=0.99, power=0.1)
HEAP_PAD = 2048


def heap_launchers():
    """The four sweep launchers by short name, with their wrappers."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled, bart_sweep_fused_sharded,
        sweep_chain_cuda, sweep_cuda, sweep_sharded_cuda, sweep_tiled_cuda)

    return {"batch": (sweep_cuda, bart_sweep_fused_batch),
            "tiled": (sweep_tiled_cuda, bart_sweep_fused_batch_tiled),
            "chain": (sweep_chain_cuda, bart_sweep_fused),
            "sharded": (sweep_sharded_cuda, bart_sweep_fused_sharded)}


def heap_forced_at_depth9(device, label, N=10_000, C=64, T=20):
    """Each kernel's heap build forced at max_depth 9 (1024 slots) against
    its 1024-slot static build at the K the static one picks, float32, at
    p_regrow 0 and 1 (the sharded kernel on one rank): equal to the bit.
    Returns the Ks."""
    _, _, _, args = sweep_args(N, T, C, 17, device, **DEEP9)
    on, rg = regrow_args(args, 1.0, 117)
    ks = {}
    for name, (launch, wrapper) in heap_launchers().items():
        for a, r in ((args, None), (on, rg)):
            static = launch(*a, rg=r)
            K = wrapper.last_cluster
            before = wrapper.heap_launches
            heap = launch(*a, rg=r, cluster=K, heap=True)
            torch.cuda.synchronize()
            if (wrapper.heap_launches == before
                    or not all(torch.equal(x, y)
                               for x, y in zip(static, heap))):
                raise AssertionError(f"{label}: {name}'s heap build forced "
                                     "at max_depth 9 differs from its "
                                     "1024-slot build")
            ks[name] = K
            del static, heap
    print(f"{label}: the heap builds forced at max_depth 9 (1024 slots), "
          f"n={N} chains={C} trees={T}, equal to the bit to the 1024-slot "
          "static builds at p_regrow 0 and 1: " + ", ".join(
              f"{k} (K={v})" for k, v in ks.items())
          + " (sharded on one rank)", flush=True)
    return ks


def phase_heap_kernels(device, reps=7):
    """Phase 14a: the one-launch kernels' heap builds against the plain
    sweep at p_regrow 0 and 1 (``kernels_at_shape``): float32 at the bench
    shape at max_depth 10 (timed, with K, shared memory and the bound at
    M = 2047) beside the 1024-slot static builds at max_depth 9 (timed,
    bound at M = 1023); float32 and float64 at max_depth 12 and float64
    at 10, 10 000 x 64 chains x 20 trees; the obs-tiled build at K = 1
    with its residual in device memory, weighted, at 40 000 x 16 in both
    types; the four-byte leaf copy at max_depth 15 (2000 x 4 x 10 trees);
    each heap build forced at max_depth 9 against the 1024-slot build to
    the bit; the single-pass heap build timed at 14b's shape and prior
    (10 000 x 128 x 75 trees) at max_depth 10, 12 and 14."""
    from functools import partial

    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused_batch_tiled, kernel_smem, sweep_tiled_cuda)

    label = "phase 14a"
    C, N, T = 256, 10_000, 75
    launchers = heap_launchers()
    three = {k: launchers[k] for k in ("batch", "tiled", "chain")}
    streamed = (partial(sweep_tiled_cuda, cluster=1),
                bart_sweep_fused_batch_tiled)
    bench = kernels_at_shape(device, label, N, C, three, 3, T, times=True,
                             reps=reps, cfg_kw=HEAP10)
    bench9 = kernels_at_shape(device, label, N, C, three, 4, T, times=True,
                              reps=reps, cfg_kw=DEEP9)
    errs = [bench["err"], bench9["err"]]
    for kw, dtype, seed in ((HEAP12, torch.float32, 5), (HEAP12, F64, 6),
                            (HEAP10, F64, 7)):
        errs.append(kernels_at_shape(device, label, N, 64, three, seed, 20,
                                     weighted=True, cfg_kw=kw,
                                     dtype=dtype)["err"])
    for dtype in (torch.float32, F64):
        if kernel_smem("bart_sweep_tiled", 40_000, 20, 1, True, HEAP_PAD,
                       dtype)["resid_on_chip"]:
            raise AssertionError(f"{label}: the heap obs-tiled kernel at "
                                 "40 000 rows a block keeps the residual "
                                 "on chip; its streaming kernel would go "
                                 "unchecked")
        errs.append(kernels_at_shape(
            device, label, 40_000, 16,
            {"tiled": three["tiled"], "tiled streamed": streamed}, 8, 20,
            weighted=True, cfg_kw=HEAP10, dtype=dtype)["err"])
    wide = kernels_at_shape(device, label, 2000, 4, three, 9, 10,
                            cfg_kw=HEAP15)
    if wide["deepest"] < 15:
        raise AssertionError(f"{label}: the max_depth 15 forest stops at "
                             f"depth {wide['deepest']}")
    errs.append(wide["err"])
    forced = heap_forced_at_depth9(device, label)
    # the single-pass heap build at phase 14b's shape and prior, by depth:
    # how its per-tree work over every heap slot grows with the heap
    scaling = {}
    for depth in (10, 12, 14):
        _, st, _, args = sweep_args(N, T, 128, 30 + depth, device,
                                    max_depth=depth, **HEAP_PRIOR)
        scaling[depth] = (_time(lambda: launchers["batch"][0](*args), 3)[0],
                          depth_note(st.feature, 10))
        del st, args
    print(f"{label} the single-pass heap build at n={N} chains=128 "
          f"trees={T} from prior forests (base {HEAP_PRIOR['base']}, power "
          f"{HEAP_PRIOR['power']}), median of 3: " + "; ".join(
              f"max_depth {d} ({2 ** (d + 1)} slots) {ms:.4f} ms, deepest "
              f"node {note[0]}, {note[1]} nodes at depth >= 10"
              for d, (ms, note) in scaling.items()) + f"; {card()}",
          flush=True)
    for note in ([smem_note(f"bart_sweep_{k}", N, T, bench["clusters"][k], r,
                            HEAP_PAD) for k in three for r in (False, True)]
                 + [smem_note("bart_sweep_tiled", 40_000, 20, 1, True,
                              HEAP_PAD, dt) for dt in (torch.float32, F64)]
                 + [smem_note(f"bart_sweep_{k}", N, T, bench9["clusters"][k],
                              r, 1024) for k in three
                    for r in (False, True)]):
        print(f"{label} {note}", flush=True)
    out = {}
    for key, res, M, pad in (("", bench, 2047, HEAP_PAD),
                             ("9", bench9, 1023, 1024)):
        nbytes = sweep_bytes(C, T, N, M, pad)
        out[f"bound{key}_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        out[f"bound1{key}_ms"] = ((nbytes + regrow_bytes(C, T, M))
                                  / HBM_BYTES_PER_S * 1e3)
        lines = "; ".join(
            f"{k} (K={res['clusters'][k]}) p_regrow 0 / 1: "
            f"{res[k + '_ms_0']:.4f} / {res[k + '_ms_1']:.4f} ms"
            for k in three)
        what = ("the heap builds at max_depth 10" if not key else
                "the 1024-slot static builds at max_depth 9")
        print(f"{label} times of {what}, n={N} chains={C} trees={T}, median "
              f"of {reps}: {lines}; plain sweep at p_regrow 0 "
              f"{res['plain_ms']:.4f} ms; bound {out[f'bound{key}_ms']:.4f} "
              f"ms ({nbytes / 1e9:.4f} GB at {HBM_BYTES_PER_S / 1e12} TB/s, "
              f"M = {M}, {pad} leaf normals a tree), with the move "
              f"{out[f'bound1{key}_ms']:.4f} ms; {card()}", flush=True)
    print(f"{label}: every heap build equal to the plain sweep as above "
          f"(max |kernel - plain| {max(errs):.3g})", flush=True)
    return dict(bench, **out, max_abs_err=max(errs), forced=forced,
                depth9={k: bench9[k] for k in bench9
                        if k.endswith(("_ms_0", "_ms_1")) or k in (
                            "plain_ms", "clusters")})


def heap_resume(device, label="phase 14b resume", n=2000, chains=16,
                trees=20, iters=20, warmup=10):
    """A small max_depth 12 fit on the per-chain path (a callback) through
    ``save``, ``load(device="cuda")`` and ``continue_sampling``: the
    loaded fit's ``continue_sampling(10)``, whole and in chunks of 4,
    equal to the bit to the original's whole one; every sweep a launch of
    the per-chain kernel's heap build.  Returns its launches."""
    import tempfile

    import stan4bart_torch
    from stan4bart_torch.ops.bart_sweep_kernel import bart_sweep_fused
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe, generate_friedman_data)

    df = friedman_dataframe(generate_friedman_data(n, ranef=True,
                                                   causal=True))
    bart_args = {"n_trees": trees, "max_depth": 12, **HEAP_PRIOR}
    counts = reset_counts()
    fit = stan4bart_torch.stan4bart(
        FLAGSHIP, df, treatment="z", chains=chains, iter=iters,
        warmup=warmup, seed=5, verbose=-1, device=device,
        callback=lambda d: {"sigma": d["aux.1"]},
        stan_args={"max_treedepth": 4}, bart_args=bart_args)
    launches = check_launches(label, counts, "bart_sweep_chain", iters + 1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.pkl")
        fit.save(path)
        back = stan4bart_torch.Stan4bartFit.load(path, device=device)
    if not (back.prog.device.type == "cuda"
            and back.prog.sweep_consts.node_pad == 8192):
        raise AssertionError(f"{label}: the loaded fit is not a max_depth 12 "
                             "fit on the card")
    resumed = {}
    for which, f, kw in (("original", fit, {}), ("loaded", back, {}),
                         ("loaded, chunked", back, {"chunk_size": 4})):
        counts = reset_counts()
        resumed[which] = f.continue_sampling(10, **kw)
        launches += check_launches(f"{label} {which}", counts,
                                   "bart_sweep_chain", 10)
    heap = bart_sweep_fused.heap_launches
    names = ("stan", "bart_train", "bart_test", "k")
    diffs = {w: resume_equal(resumed["original"], resumed[w], names)
             for w in ("loaded", "loaded, chunked")}
    print(f"{label}: max_depth 12 fit n={n} chains={chains} on the per-chain "
          "path, saved, loaded on the card; continue_sampling(10) of the "
          "loaded fit against the original's whole one: " + "; ".join(
              f"{w}: max difference {d:.3g}, equal to the bit {same}"
              for w, (d, same) in diffs.items())
          + f"; {heap} heap-build per-chain launches in the last resume",
          flush=True)
    if not all(same for _, same in diffs.values()) or heap != 10:
        raise AssertionError(f"{label}: the max_depth 12 resume is not "
                             "equal to the bit")
    return launches


def heap_tiled_fit(device, label="phase 14b tiled", n=40_000, chains=8,
                   trees=20, iters=12, warmup=6):
    """A short max_depth 10 fit past the heap single-pass build's ceiling:
    every sweep a launch of the obs-tiled kernel's heap build, finite
    draws.  Returns its launches."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused_batch_tiled)

    _, fit, launches = run_fit(
        label, device, n, chains, "bart_sweep_tiled", iters, warmup, trees,
        stan_args={"max_treedepth": 4},
        bart_args={"n_trees": trees, "max_depth": 10, **HEAP_PRIOR})
    finite_draws(label, fit)
    if bart_sweep_fused_batch_tiled.heap_launches != launches:
        raise AssertionError(f"{label}: a sweep ran another build")
    return launches


def phase_heap_fit(device, label="phase 14b", n=10_000, chains=128,
                   iters=150, warmup=75, trees=75):
    """Phase 14b: the phase 3 fit (at 128 chains) with max_depth 12 and
    the prior ``HEAP_PRIOR`` (base 0.99, power 0.25), every sweep a launch
    of the single-pass kernel's heap build: the gaussian gates, SATE
    within 1, every posterior-mean Sigma positive definite, nodes at
    depth >= 10 in the final forests (the deepest and their share
    printed) and its ``fit_quality``; then ``heap_resume`` and
    ``heap_tiled_fit``.  Returns the heap builds' launches by kernel and
    its ``fit_quality``."""
    from stan4bart_torch.ops.bart_sweep_kernel import bart_sweep_fused_batch

    d, fit, launches = run_fit(
        label, device, n, chains, "bart_sweep_batch", iters, warmup, trees,
        bart_args={"n_trees": trees, "max_depth": 12, **HEAP_PRIOR})
    heap = bart_sweep_fused_batch.heap_launches
    finite_draws(label, fit)
    if fit.prog.sweep_consts.node_pad != 8192 or heap != launches:
        raise AssertionError(f"{label}: {heap} of {launches} launches ran "
                             "the heap build")
    q = fit_quality(d, fit)
    check_gates(label, q["cor"], q["sigma"], "bart_sweep_batch", launches,
                iters)
    eig = {k: float(np.linalg.eigvalsh(S.mean(-1)).min())
           for k, S in fit.extract("Sigma").items()}
    deepest, n10, share = depth_note(fit.final_states.bart.feature, 10)
    print(f"{label}: max_depth 12, prior base {HEAP_PRIOR['base']} power "
          f"{HEAP_PRIOR['power']}, {heap} launches of the heap single-pass "
          f"build (every sweep); {quality_line(q)}; the final forests' "
          f"deepest node at depth {deepest}, {n10} nodes at depth >= 10 "
          f"({100 * share:.3f} % of the active nodes); SATE truth "
          f"{d['tau']}, within 1; smallest eigenvalue of the posterior-mean "
          "Sigma by term: " + ", ".join(f"{k} {v:.4g}"
                                        for k, v in eig.items()),
          flush=True)
    if (abs(q["sate"] - d["tau"]) >= 1.0 or min(eig.values()) <= 0
            or deepest < 10):
        raise AssertionError(f"{label}: SATE, Sigma or depth gate failed")
    del fit
    paths = {"bart_sweep_batch_heap": launches,
             "bart_sweep_chain_heap": heap_resume(device),
             "bart_sweep_tiled_heap": heap_tiled_fit(device)}
    return paths, q


def heap_entries(heap, sharded, launches, paths):
    """The kernels line's entries of the heap builds (phase 14a's numbers
    at the bench shape at max_depth 10, the sharded one's at 10a's rows a
    rank; launches of the heap builds on the main paths: phase 14b's
    fits)."""
    bench = sweep_bytes(256, 75, 10_000, 2047, HEAP_PAD)
    out = []
    for k, src, line in (("batch", "bart_sweep_batch", 859),
                         ("tiled", "bart_sweep_tiled", 1495),
                         ("chain", "bart_sweep_chain", 596)):
        out.append({
            "name": f"{src}_heap",
            "route": "cuda",
            "source": f"stan4bart_torch/csrc/{src}.cu",
            # the heap build of the port of this TPU kernel; the JAX
            # package sweeps such trees with XLA (ops/bart.py:717)
            "replaces": f"stan4bart_tpu/ops/bart_sweep_kernel.py:{line}",
            "launches": launches.get(f"{src}_heap", 0),
            "launches_by_path": paths.get(f"{src}_heap", {}),
            "max_abs_err": heap["max_abs_err"],
            "ms": heap[f"{k}_ms_0"],
            "kernel_ms": heap[f"{k}_ms_0"],
            "ms_p_regrow_1": heap[f"{k}_ms_1"],
            "plain_ms": heap["plain_ms"],
            "bound_ms": heap["bound_ms"],
            "bound_ms_p_regrow_1": heap["bound1_ms"],
            "bound_by": "bytes",
            "library_ms": None,
            "cluster": heap["clusters"][k],
            "bound_bytes": bench,
            "max_depth": 10,
        })
    out.append({
        "name": "bart_sweep_sharded_heap",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_sharded.cu",
        "replaces": "stan4bart_tpu/ops/bart.py:717",
        "launches": launches.get("bart_sweep_sharded_heap", 0),
        "launches_by_path": paths.get("bart_sweep_sharded_heap", {}),
        "max_abs_err": sharded["heap_err"],
        "ms": sharded["heap_ms"],
        "kernel_ms": sharded["heap_ms"],
        "ms_p_regrow_1": sharded["heap_ms_1"],
        "plain_ms": sharded["heap_plain_ms"],
        "bound_ms": sharded["heap_bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": sharded["heap_cluster"],
        "max_depth": 10,
    })
    return out


class Beside:
    """``fn()`` in a thread of this process, for a phase whose work runs
    in processes of its own, so that this process can run another phase
    meanwhile; ``join`` returns its result or raises its exception."""

    def __init__(self, fn):
        self.out = {}
        self.thread = threading.Thread(target=self._run, args=(fn,),
                                       daemon=True)
        self.thread.start()

    def _run(self, fn):
        try:
            self.out["value"] = fn()
        except BaseException as e:     # re-raised by join
            self.out["error"] = e

    def join(self):
        self.thread.join()
        if "error" in self.out:
            raise self.out["error"]
        return self.out["value"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14,15a,16a",
                    help="comma-separated phases to run (default all but "
                    "15b and 16b); 1, 2, 4, 10a, 11a, 11b, 12a, 13a and 14a "
                    "are the kernel phases, which the kernels line needs; "
                    "10a, 10b, 10c, 11a to 11d, 12a, 12b, 13a, 13b, 14a, "
                    "14b, 15a, 15b, 16a and 16b run one part of phase 10, "
                    "11, 12, 13, 14, 15 or 16")
    ap.add_argument("--sbc-cells", default=",".join(SBC_15B),
                    help="phase 15b's SBC cells (<cell> or <cell>/chain)")
    ap.add_argument("--sbc-out", default="SBC_torch_h100.json",
                    help="where phase 15b writes its cells, beside those "
                    "SBC_torch_h100.json already holds")
    ap.add_argument("--quality-out", default="QUALITY_torch_h100.json",
                    help="where phase 16b writes its quality gates")
    ap.add_argument("--ihdp-out", default="IHDP_synthetic_torch_h100.json",
                    help="where phase 16b writes its synthetic IHDP study")
    ap.add_argument("--jobs16b", default=",".join(
        QUALITY_16B + (f"ihdp:0-{IHDP_REPS - 1}",)),
                    help="phase 16b's jobs: quality gates and ihdp:<rep> "
                    "or ihdp:<first>-<last>; written beside the records "
                    "of earlier runs that the root's QUALITY_torch_h100.json "
                    "and IHDP_synthetic_torch_h100.json hold")
    args = ap.parse_args()
    run = set(args.phases.split(","))
    if "10" in run:
        run |= {"10a", "10b", "10c"}
    if "11" in run:
        run |= {"11a", "11b", "11c", "11d"}
    if "12" in run:
        run |= {"12a", "12b"}
    if "13" in run:
        run |= {"13a", "13b"}
    if "14" in run:
        run |= {"14a", "14b"}
    if "15" in run:
        run |= {"15a", "15b"}
    if "16" in run:
        run |= {"16a", "16b"}

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from stan4bart_torch.ops import cuda_build
    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused_batch_tiled, sweep_tiled_cuda)
    from stan4bart_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    walls, clock = {}, [time.perf_counter()]

    def lap(name):
        """Wall seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        walls[name] = now - clock[0]
        clock[0] = now

    secs = cuda_build.build(list(KERNELS + F64_KERNELS), verbose=True)
    lap("build")
    print("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f" ({walls['build']:.1f} s in all)", flush=True)

    err = [0.0, 0.0, 0.0]     # batch, tiled, chain vs plain
    if "1" in run:
        for n in (2000, 9191):
            err = [max(a, b) for a, b in zip(err, phase_small(device, n))]
        lap("phase 1")
    if "2" in run:
        full = phase_full(device)
        ablate = {c: phase_ablate(device, c) for c in (256, 64)}
        lap("phase 2")
    if "4" in run:
        large = {n: phase_large(device, n, c)
                 for n, c in ((50_000, 64), (51_840, 64), (200_000, 16))}
        # phase 5 runs its fit at 32 chains
        large[50_000]["max_abs_err_c32"] = hold_at_path_shape(
            device, "phase 4", 50_000, 32,
            {"tiled": (sweep_tiled_cuda, bart_sweep_fused_batch_tiled)},
            seed=7)["tiled"]
        lap("phase 4")
    # launches of each kernel on each main path that ran it
    paths = {k: {} for k in KERNELS}
    # phase 15a's SBC cells run in a child process each beside phases 3
    # and 5 to 9, after the kernels timed in phases 2 and 4: all are
    # host-bound
    child15 = start_groups("15a", list(SBC_15A)) if "15a" in run else None
    # phase 16a's weighted and held-out fits run beside them too, a child
    # process each (the weighted fit alone takes most of their window)
    child16 = (start_groups("16a", ["weighted", "rmse"])
               if "16a" in run else None)
    t3 = None     # phase 3's per-phase seconds, printed beside phase 8's
    fit3 = ev7 = None     # phase 3's fit and phase 7's P(y = 1), for 9
    if "3" in run:
        # run_fit holds every main path to 0 launches of the stubs
        paths["bart_sweep_batch"]["phase 3"], fit3 = phase_main(
            device, "phase 3", 10_000, 256, "bart_sweep_batch")
        t3 = dict(fit3.timings, iters=fit3.draws.stan.shape[1])
        if not {"9", "11d"} & run:   # 9 adjudicates it, 11d profiles it
            fit3 = None
        lap("phase 3" + (" and 15a beside it" if child15 else ""))
    # phase 6's fit runs in a child process beside phase 5's and phase
    # 8's beside phase 7's: all are host-bound
    child6 = start_fit("6") if {"5", "6"} <= run else None
    if "5" in run:
        paths["bart_sweep_tiled"]["phase 5"], _ = phase_main(
            device, "phase 5", 50_000, 32, "bart_sweep_tiled", iters=225,
            warmup=150)
        lap("phase 5" + (" and 6 beside it" if child6 else ""))
    if "6" in run:
        paths["bart_sweep_chain"]["phase 6"] = (
            join_fit(child6) if child6 else phase_chain(device))
        lap("phase 6" + (" (joined)" if child6 else ""))
    child8 = start_fit("8", t3) if {"7", "8"} <= run else None
    if "7" in run:
        paths["bart_sweep_batch"]["phase 7"], ev7 = phase_probit(device)
        lap("phase 7" + (" and 8 beside it" if child8 else ""))
    if "8" in run:
        paths["bart_sweep_batch"]["phase 8"] = (
            join_fit(child8) if child8 else phase_all_options(device, t3))
        lap("phase 8" + (" (joined)" if child8 else ""))
    if "9" in run:
        paths["bart_sweep_batch"]["phase 9"] = phase_algorithms(
            device, t3, fit3, ev7)
        lap("phase 9")
    sbc_err = {}
    if child15 is not None:
        sbc_err = join_sbc("phase 15a", child15, True, paths)
        lap("phase 15a (joined)")
    q16 = {}      # phase 16's records by job
    if child16 is not None:
        q16 = join_quality("phase 16a", child16, paths)
        lap("phase 16a (joined)")
        if quality_failures(q16):
            raise AssertionError("phase 16a: quality gates failed: "
                                 + ", ".join(quality_failures(q16)))
    p11 = None     # phase 3's fit, profiled by 11d
    if "11d" in run and fit3 is not None:
        p11 = fit3
    del fit3
    # phase 10's ranks are processes of their own on the card; 11b runs
    # in 10a's
    torch.cuda.empty_cache()
    sharded = None
    if {"10a", "11b", "12a", "13a", "14a"} & run:
        sharded = phase_sharded_kernel(regrow="11b" in run,
                                       deep="12a" in run, f64="13a" in run,
                                       heap="14a" in run)
        lap("phase 10a" + (" and 11b" if "11b" in run else "")
            + (" and 12a sharded" if "12a" in run else "")
            + (" and 13a sharded" if "13a" in run else "")
            + (" and 14a sharded" if "14a" in run else ""))
    # 10b's ranks are processes of their own, waited on by a thread; the
    # short option fits of phases 6, 8 and 9 run beside them in this
    # process, each with its own launch counts (the ranks count theirs)
    composed = Beside(phase_composed) if "10b" in run else None
    if "6" in run:
        paths["bart_sweep_chain"]["phase 6 options"] = phase_options(device)
        paths["bart_sweep_batch"]["phase 6 offset types"] = \
            phase_offset_types(device)
    if "8" in run:
        for k, v in phase_option_fits(device).items():
            paths[k]["phase 8 options"] = v
    if "9" in run:
        for k, v in phase_algorithm_options(device).items():
            paths[k]["phase 9 options"] = v
    if composed is not None:
        paths["bart_sweep_sharded"]["phase 10b"] = composed.join()
    lap("phase 10b and the option fits of 6, 8 and 9 beside it")
    if "10c" in run:
        for k, v in phase_contracts(device).items():
            paths.setdefault(k, {})["phase 10c"] = v
        lap("phase 10c")
    regrow = None
    if "11a" in run:
        regrow = phase_regrow_kernels(device)
        lap("phase 11a")
    # 12b's, 13b's and 14b's fits run in child processes beside 11c's,
    # their comparator
    children = [start_fit(p) for p in ("12b", "13b", "14b") if p in run]
    q6 = None     # 11c's fit_quality, printed beside 12b's and 13b's
    if "11c" in run:
        n11, q6 = phase_regrow_fit(device)
        paths["bart_sweep_batch"]["phase 11c"] = n11
        paths["bart_sweep_regrow"] = {"phase 11c": n11}
        lap("phase 11c" + "".join(f" and {c[0]}" for c in children)
            + (" beside it" if children else ""))
    comparator = ("" if q6 is None else
                  "; phase 11c (depth 6, float32, p_regrow 0.25, run "
                  f"beside it): {quality_line(q6)}")
    for child in children:
        if child[0] == "12b":
            n12, q8 = join_fit(child)
            # launches of the deep build, counted in its own entry
            paths["bart_sweep_batch_deep"] = {"phase 12b": n12}
            print("phase 12b, depth 8 against depth 6: " + quality_line(q8)
                  + comparator + f"; {card()}", flush=True)
        elif child[0] == "13b":
            n13, q13 = join_fit(child)
            # launches of the float64 builds, counted in their entries
            for k, v in n13.items():
                paths.setdefault(k, {})["phase 13b"] = v
            print("phase 13b, float64 against float32: " + quality_line(q13)
                  + comparator + f"; {card()}", flush=True)
        else:
            n14, q14 = join_fit(child)
            # launches of the heap builds, counted in their entries
            for k, v in n14.items():
                paths.setdefault(k, {})["phase 14b"] = v
            print("phase 14b, max_depth 12 against depth 6: "
                  + quality_line(q14) + comparator + f"; {card()}",
                  flush=True)
        lap(f"phase {child[0]} (joined)")
    if "11d" in run:
        phase_profile(device, p11)
        del p11
        lap("phase 11d")
    deep = None
    if "12a" in run:
        deep = phase_deep_kernels(device, full if "2" in run else None,
                                  regrow)
        lap("phase 12a")
    f64 = None
    if "13a" in run:
        f64 = phase_f64_kernels(device, full if "2" in run else None,
                                regrow)
        lap("phase 13a")
    heap = None
    if "14a" in run:
        heap = phase_heap_kernels(device)
        lap("phase 14a")
    if "15b" in run:
        join_sbc("phase 15b",
                 start_groups("15b", args.sbc_cells.split(",")), False,
                 paths, out=args.sbc_out)
        lap("phase 15b")
    if "16b" in run:
        # 16a's records (its weighted fit at a cut budget) stay out of
        # the written ones
        q16 = dict(earlier16(), **join_quality("phase 16b", start_groups(
            "16b", jobs16(args.jobs16b)), paths))
        lap("phase 16b")
        phase_study_report(q16, args.quality_out, args.ihdp_out)
    print("wall seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items())
        + f"; {sum(walls.values()):.1f} in all", flush=True)
    kernel_phases = {"1", "2", "4", "10a", "11a", "11b", "12a", "13a",
                     "14a"}
    launches = {k: (sum(v.values()) if run - kernel_phases else None)
                for k, v in paths.items()}
    # each float64 build launched on the main path that runs it
    for k, phase in (("bart_sweep_batch_f64", "13b"),
                     ("bart_sweep_chain_f64", "13b"),
                     ("bart_sweep_tiled_f64", "13b"),
                     ("bart_sweep_sharded_f64", "10c"),
                     ("bart_sweep_batch_heap", "14b"),
                     ("bart_sweep_chain_heap", "14b"),
                     ("bart_sweep_tiled_heap", "14b")):
        if phase in run and not launches.get(k):
            raise AssertionError(f"{k}: no launch in phase {phase}")
    if not kernel_phases - {"10a"} <= run or sharded is None:
        print(card(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

    big = large[50_000]
    chain_errs = [err[2], full["chain_max_abs_err"]] + [
        r["chain_max_abs_err"] for r in large.values()
        if "chain_max_abs_err" in r]
    print(json.dumps({"kernels": [{
        "name": "bart_sweep_batch",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_batch.cu",
        "replaces": "stan4bart_tpu/ops/bart_sweep_kernel.py:859",
        "launches": launches["bart_sweep_batch"],
        "launches_by_path": paths["bart_sweep_batch"],
        "max_abs_err": max(err[0], full["max_abs_err"],
                           sbc_err.get("bart_sweep_batch", 0.0)),
        "ms": full["ms"],
        "kernel_ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": full["cluster"],
    }, {
        "name": "bart_sweep_tiled",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_tiled.cu",
        "replaces": "stan4bart_tpu/ops/bart_sweep_kernel.py:1495",
        "launches": launches["bart_sweep_tiled"],
        "launches_by_path": paths["bart_sweep_tiled"],
        "max_abs_err": max([err[1], full["tiled_max_abs_err"],
                            big["max_abs_err_c32"]]
                           + [r["max_abs_err"] for r in large.values()]),
        "ms": big["ms"],
        "kernel_ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": big["cluster"],
        "ms_n200000_c16": large[200_000]["ms"],
        "bound_ms_n200000_c16": large[200_000]["bound_ms"],
        "cluster_n200000_c16": large[200_000]["cluster"],
    }, {
        "name": "bart_sweep_chain",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_chain.cu",
        "replaces": "stan4bart_tpu/ops/bart_sweep_kernel.py:596",
        "launches": launches["bart_sweep_chain"],
        "launches_by_path": paths["bart_sweep_chain"],
        "max_abs_err": max(chain_errs),
        "ms": big["chain_ms"],
        "kernel_ms": big["chain_ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": big["chain_cluster"],
        "ms_n51840_c64": large[51_840]["chain_ms"],
        "bound_ms_n51840_c64": large[51_840]["bound_ms"],
        "cluster_n51840_c64": large[51_840]["chain_cluster"],
        "ms_bench": full["chain_ms"],
        "bound_ms_bench": full["bound_ms"],
        "cluster_bench": full["chain_cluster"],
    }, {
        "name": "bart_sweep_ablate",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_ablate.cu",
        "replaces": "benchmarks/ablate_batch_kernel.py:124",
        "launches": launches["bart_sweep_ablate"],
        "launches_by_path": paths["bart_sweep_ablate"],
        "max_abs_err": max(a["max_abs_err"] for a in ablate.values()),
        "ms": ablate[256]["obs"],
        "kernel_ms": ablate[256]["obs"],
        "copy_ms": ablate[256]["copy"],
        "full_ms": ablate[256]["full"],
        "ms_c64": {k: ablate[64][k] for k in ("copy", "obs", "full")},
        "plain_ms": ablate[256]["plain_ms"],
        "bound_ms": ablate[256]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": ablate[256]["cluster"],
    }, {
        "name": "bart_sweep_sharded",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_sharded.cu",
        # no Pallas kernel: the JAX package's XLA bart_sweep(axis_name=)
        "replaces": "stan4bart_tpu/ops/bart.py:717",
        # tree updates per rank (one stats and one apply launch each)
        "launches": launches["bart_sweep_sharded"],
        "launches_by_path": paths["bart_sweep_sharded"],
        "max_abs_err": sharded["max_abs_err"],
        "ms": sharded["ms"],
        "kernel_ms": sharded["ms"],
        "plain_ms": sharded["plain_ms"],
        "bound_ms": sharded["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": sharded["cluster"],
        "sweep_wall_ms_2_ranks": sharded["wall_ms"],
        "collective_share": sharded["share"],
        "tiled_ms_same_call": sharded["tiled_ms"],
        "ms_world_size_1": sharded["w1_ms"],
        "bound_ms_world_size_1": sharded["bound_w1_ms"],
    }, {
        # the in-sweep regrow step: no Pallas kernel (the JAX package's
        # move is XLA); it runs inside the one-launch kernels and, sharded,
        # as a regrow stats and a regrow apply launch
        "name": "bart_sweep_regrow",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/sweep_common.cuh",
        "replaces": "stan4bart_tpu/ops/bart.py:531",
        # single-pass kernel launches that ran the move, on its fit path
        "launches": launches.get("bart_sweep_regrow"),
        "launches_by_path": paths.get("bart_sweep_regrow", {}),
        "max_abs_err": max(regrow["max_abs_err"], sharded["rg_err"]),
        "ms": regrow["batch_ms_1"],
        "kernel_ms": regrow["batch_ms_1"],
        "ms_p_regrow_0": regrow["batch_ms_0"],
        "ms_p_regrow_0.25": regrow["batch_ms_0.25"],
        "tiled_ms": regrow["tiled_ms_1"],
        "chain_ms": regrow["chain_ms_1"],
        "plain_ms": regrow["plain_ms_1"],
        "bound_ms": regrow["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": regrow["clusters"]["batch"],
        "sharded_ms": sharded["rg_ms"],
        "sharded_plain_ms": sharded["rg_plain_ms"],
        "sharded_bound_ms": sharded["rg_bound_ms"],
        "sharded_regrow_updates": sharded["rg_updates"],
    }] + deep_entries(deep, sharded, launches, paths, heap)
        + f64_entries(f64, sharded, launches, paths)
        + heap_entries(heap, sharded, launches, paths)}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
