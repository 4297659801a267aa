"""The cluster rule of the chain-batched sweep kernels and the ablation
stubs of the single-pass kernel.

On the CPU: ``cluster_size`` (blocks per chain) at the shapes the port
runs, and the plain versions of the stubs (``ablate_plain``) against a
numpy walk over the trees on small inputs, weighted and unweighted; the
stubs have no JAX counterpart to call (the TPU stubs live inside
``benchmarks/ablate_batch_kernel.py:main``).

On the card (marker ``cuda``; skipped without a GPU): the single-pass and
obs-tiled kernels against the plain sweep at every cluster size K over 3
chained sweeps, equal to each other to the bit at equal K, equal to the
per-chain kernel to the bit at K = 1, and equal to themselves over two
launches; the stubs against their plain versions.  Tolerances are those
of tests/test_torch_sweep_kernel.py: the same float32 terms summed in
another order."""

import numpy as np
import pytest
import torch

from stan4bart_torch.ops import bart as tb
from stan4bart_torch.ops import bart_sweep_kernel as tk

torch.set_num_threads(2)

P, T, C = 5, 8, 4
LV_TOL = dict(rtol=2e-4, atol=2e-5)
FIT_TOL = dict(rtol=5e-4, atol=5e-4)
# the obs stub's per-node sums of thousands of residuals in another order
STATS_TOL = dict(rtol=5e-4, atol=1e-2)


# clusters resident at once on an NVIDIA H100 80GB HBM3 for K = 1..8, as
# chip_smoke.py printed them (phase 2: single-pass kernel at n = 10 000;
# phase 4: obs-tiled kernel), 75 trees; the measured best K there is 1, 7
# and 6
RESIDENT_10K = [264, 198, 124, 92, 0, 0, 0, 0]
RESIDENT_50K = [132, 66, 39, 62, 47, 39, 32, 30]
RESIDENT_200K = [132, 66, 39, 30, 22, 17, 15, 15]
EVERY = [10_000] * 8     # every cluster resident


@pytest.mark.parametrize("chains, n, resident, want", [
    (256, 10_000, RESIDENT_10K, 1),    # one block per chain fills the card
    (64, 50_000, RESIDENT_50K, 7),     # two waves of 7143 observations
    (16, 200_000, RESIDENT_200K, 6),   # the largest K still in one wave
    (16, 2_000, EVERY, 1),             # too few observations to split
    (16, 9_191, EVERY, 4),             # capped at 2048 observations a block
    (256, 10_000, [264, 128] + [0] * 6, 1),
])
def test_cluster_size(chains, n, resident, want):
    assert tk.cluster_size(chains, n, resident) == want


def _stub_inputs(n, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, P))
    cfg = tb.BartConfig(num_trees=T)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = tb.sample_trees_from_prior(
        cfg, gen, torch.as_tensor(ranks, device=device), sp, C,
        dtype=torch.float32)
    consts = tk.make_sweep_consts(cfg, ranks, sp, device=device)
    # leaf values drawn with numpy so that every leaf has its own value
    lv = torch.as_tensor(rng.normal(size=state.leaf_value.shape),
                         dtype=torch.float32, device=device)
    resid0 = torch.as_tensor(rng.normal(size=(C, n)), dtype=torch.float32,
                             device=device)
    u = tb.draw_variates(gen, C, T, torch.float32, device)[0]
    w = torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                        device=device)
    return (state.feature, state.cut, lv, state.leaf_idx,
            state.tree_fit.contiguous(), resid0), u, consts, w


def _obs_numpy(lv, lidx, tfit, resid0, w):
    """The obs stub walked tree by tree, observation by observation."""
    lv, lidx, tfit = lv.numpy(), lidx.numpy(), tfit.numpy()
    R = resid0.numpy().astype(np.float64)
    Cn, Tn, M = lv.shape
    stats = np.zeros((Cn, Tn, 2, M))
    fits = np.zeros(tfit.shape)
    for t in range(Tn):
        r = R + tfit[:, t]
        for c in range(Cn):
            np.add.at(stats[c, t, 0], lidx[c, t], w)
            np.add.at(stats[c, t, 1], lidx[c, t], w * r[c])
            fits[c, t] = lv[c, t][lidx[c, t]]
        R = r - fits[:, t]
    return fits, R, stats


@pytest.mark.parametrize("weighted", [False, True])
def test_plain_obs_stub_matches_a_numpy_walk(weighted):
    stub, u, consts, w = _stub_inputs(700, 3)
    wt = w if weighted else None
    out = tk.bart_sweep_ablate("obs", *stub, u, consts, weights=wt)
    fits, R, stats = _obs_numpy(stub[2], stub[3], stub[4], stub[5],
                                w.numpy() if weighted else np.ones(700))
    for i in range(4):       # rows, leaf values and leaf indices copied
        assert torch.equal(out[i], stub[i])
    np.testing.assert_allclose(out[4].numpy(), fits, **FIT_TOL)
    np.testing.assert_allclose(out[5].numpy(), R, **FIT_TOL)
    np.testing.assert_allclose(out[6].numpy(), stats, **FIT_TOL)
    assert float(out[6][:, :, 0].sum()) == pytest.approx(
        C * T * (w.sum().item() if weighted else 700), rel=1e-5)


def test_plain_copy_stub_copies_its_inputs():
    stub, u, consts, _ = _stub_inputs(300, 4)
    out = tk.bart_sweep_ablate("copy", *stub, u, consts)
    for x, y in zip(out[:6], stub):
        assert torch.equal(x, y)
        assert x.data_ptr() != y.data_ptr()
    assert not out[6].any()
    with pytest.raises(ValueError):
        tk.bart_sweep_ablate("node", *stub, u, consts)


def test_cluster_is_checked_and_ignored_by_the_plain_version():
    n = 400
    rng = np.random.default_rng(5)
    X = rng.normal(size=(n, P))
    cfg = tb.BartConfig(num_trees=T)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator()
    gen.manual_seed(5)
    state = tb.sample_trees_from_prior(cfg, gen, torch.as_tensor(ranks), sp,
                                       C, dtype=torch.float32)
    consts = tk.make_sweep_consts(cfg, ranks, sp, device="cpu")
    var = tb.draw_variates(gen, C, T, torch.float32, "cpu")
    y = torch.as_tensor(rng.normal(size=(C, n)), dtype=torch.float32)
    sigma = torch.full((C,), 0.9)
    ref = tk.bart_sweep_fused_batch(cfg, state, y, consts, sigma, None,
                                    variates=var)[0]
    for K in tk.CLUSTERS:
        out = tk.bart_sweep_fused_batch_tiled(cfg, state, y, consts, sigma,
                                              None, variates=var,
                                              cluster=K)[0]
        for f in ref._fields:
            x, z = getattr(ref, f), getattr(out, f)
            assert x is None and z is None or torch.equal(x, z), f
    for bad in (0, 9):
        with pytest.raises(ValueError):
            tk._cluster("bart_sweep_batch", C, T, consts, bad)
    assert tk._cluster("bart_sweep_batch", C, T, consts, 3) == 3


def _cuda_inputs(n, seed):
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, P))
    y = np.sin(X[:, 0]) + X[:, 1] ** 2 + rng.normal(scale=0.5, size=n)
    cfg = tb.BartConfig(num_trees=T)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = tb.sample_trees_from_prior(
        cfg, gen, torch.as_tensor(ranks, device=dev), sp, C,
        dtype=torch.float32)
    consts = tk.make_sweep_consts(cfg, ranks, sp, device=dev)
    yt = torch.as_tensor(y, dtype=torch.float32, device=dev).expand(C, n)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, n), dtype=torch.float32,
                        device=dev)
    return cfg, state, yt.contiguous(), consts, gen, w


def _states_equal(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("feature", "cut", "leaf_value", "leaf_idx",
                         "tree_fit", "allfit"))


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n", [3_000, 9_191, 12_345])
@pytest.mark.parametrize("K", tk.CLUSTERS)
def test_cuda_cluster_kernels_match_plain(K, n, weighted):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg, state, yt, consts, gen, w = _cuda_inputs(n, 10 + K)
    w = w if weighted else None
    sigma = torch.full((C,), 0.9, device=yt.device)
    kinds = ["tiled"] + (["batch"] if consts.npad <= tk.MAX_NPAD else [])
    if K == 1 and n <= tk.MAX_N_CHAIN:
        kinds.append("chain")
    fns = {"batch": tk.bart_sweep_fused_batch,
           "tiled": tk.bart_sweep_fused_batch_tiled,
           "chain": tk.bart_sweep_fused}
    runs = dict.fromkeys(kinds + ["plain"], state)
    for _ in range(3):
        var = tb.draw_variates(gen, C, T, torch.float32, yt.device)
        for kind, st in runs.items():
            kw = {} if kind in ("chain", "plain") else {"cluster": K}
            if kind == "plain":
                out = tk.sweep_plain(
                    cfg, st.feature, st.cut, st.leaf_idx, st.tree_fit,
                    (yt - st.allfit).contiguous(), sigma * sigma,
                    st.sigma_mu * st.sigma_mu, var[0], var[1], consts,
                    weights=w)
                runs[kind] = st._replace(
                    feature=out[0], cut=out[1], leaf_value=out[2],
                    leaf_idx=out[3], tree_fit=out[4], allfit=yt - out[5])
            else:
                runs[kind] = fns[kind](cfg, st, yt, consts, sigma, None,
                                       weights=w, variates=var, **kw)[0]
        torch.cuda.synchronize()
        ref = runs["plain"]
        for kind in kinds:
            s = runs[kind]
            for f in ("feature", "cut", "leaf_idx"):
                assert torch.equal(getattr(s, f), getattr(ref, f)), (kind, f)
            torch.testing.assert_close(s.leaf_value, ref.leaf_value,
                                       **LV_TOL)
            torch.testing.assert_close(s.tree_fit, ref.tree_fit, **FIT_TOL)
            torch.testing.assert_close(s.allfit, ref.allfit, **FIT_TOL)
        for kind in kinds[1:]:
            assert _states_equal(runs[kind], runs["tiled"]), kind
    assert tk.bart_sweep_fused_batch_tiled.last_cluster == K


@pytest.mark.cuda
@pytest.mark.parametrize("K", tk.CLUSTERS)
def test_cuda_cluster_kernels_repeat_to_the_bit(K):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    cfg, state, yt, consts, gen, w = _cuda_inputs(9_191, 20 + K)
    var = tb.draw_variates(gen, C, T, torch.float32, yt.device)
    sigma = torch.full((C,), 0.9, device=yt.device)
    for fn in (tk.bart_sweep_fused_batch, tk.bart_sweep_fused_batch_tiled):
        a = fn(cfg, state, yt, consts, sigma, None, weights=w, variates=var,
               cluster=K)[0]
        b = fn(cfg, state, yt, consts, sigma, None, weights=w, variates=var,
               cluster=K)[0]
        assert _states_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["copy", "obs"])
def test_cuda_ablation_stubs_match_plain(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    stub, u, consts, w = _stub_inputs(9_191, 6, device="cuda")
    for K in tk.CLUSTERS:
        k = tk.bart_sweep_ablate(mode, *stub, u, consts, weights=w,
                                 cluster=K)
        p = tk.ablate_plain(mode, *stub, weights=w)
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(k, p)):
            if x.dtype == torch.int32:
                assert torch.equal(x, y)
            else:
                torch.testing.assert_close(
                    x, y, **(STATS_TOL if i == 6 else FIT_TOL))
