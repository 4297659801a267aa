"""The port's obs-tiled sweep wrapper against the JAX package's.

On a CPU tensor ``stan4bart_torch...bart_sweep_fused_batch_tiled`` runs
the plain PyTorch sweep (``ops/bart.py:sweep_trees``); it is held here
against the JAX package's ``bart_sweep_fused_batch_tiled`` (the obs-tiled
Pallas kernel, interpreted on the CPU) in float32 on shared variates made
with numpy, from one prior-drawn forest carried over by ``convert.py``.
A 128-observation tile width makes the reference run 3 tiles at n = 300,
as tests/test_sweep_tiled.py does.  Tolerances are those of
tests/test_torch_sweep_kernel.py: the two sum the same float32 terms in
another order.

The slice-level test routes a GibbsProgram through the tiled wrapper by
lowering the dispatch threshold.  The CUDA kernel itself is checked
against the plain version and against the single-pass kernel on the card
(marker ``cuda``; skipped without a GPU) and by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stan4bart_torch import gibbs as tg
from stan4bart_torch.convert import bart_state_from_numpy
from stan4bart_torch.formula.design import build_model_frame
from stan4bart_torch.models.assemble import build_parametric_model
from stan4bart_torch.ops import bart as tb
from stan4bart_torch.ops import bart_sweep_kernel as tk
from stan4bart_torch.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)
from stan4bart_tpu.ops import bart as jb
from stan4bart_tpu.ops import bart_sweep_kernel as jk

torch.set_num_threads(2)

N, P, T, C = 300, 5, 8, 4
LV_TOL = dict(rtol=2e-4, atol=2e-5)
FIT_TOL = dict(rtol=5e-4, atol=5e-4)


def _setup(seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, P))
    y = (np.sin(X[:, 0]) + X[:, 1] ** 2
         + rng.normal(scale=0.5, size=N)).astype(np.float32)
    cfg = jb.BartConfig(num_trees=T)
    ranks = jb.compute_ranks(X, jb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P, dtype=np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    js = jax.vmap(lambda k: jb.sample_trees_from_prior(
        cfg, k, jnp.asarray(ranks), jnp.asarray(sp),
        dtype=jnp.float32))(keys)
    return cfg, tb.BartConfig(num_trees=T), y, ranks, sp, js


@pytest.mark.parametrize("weighted", [False, True])
def test_plain_sweep_matches_interpreted_tiled_tpu_kernel(weighted):
    cfg, tcfg, y, ranks, sp, js = _setup(21 if weighted else 22)
    ts = bart_state_from_numpy(js, dtype=torch.float32, device="cpu")
    jc = jk.make_sweep_consts(cfg, ranks, sp, lane_slice=128)
    assert jc.n_slices == 3
    tc = tk.make_sweep_consts(tcfg, ranks, sp, device="cpu")
    rng = np.random.default_rng(5)
    w = (rng.uniform(0.5, 2.0, N).astype(np.float32) if weighted
         else None)
    sigma = np.array([0.6, 0.8, 1.0, 1.2], np.float32)
    yb = np.ascontiguousarray(np.broadcast_to(y, (C, N)))
    for sweep in range(3):
        u = rng.uniform(size=(C, T, 8)).astype(np.float32)
        zn = rng.normal(size=(C, T, 128)).astype(np.float32)
        js, jvc = jk.bart_sweep_fused_batch_tiled(
            cfg, js, jnp.asarray(yb), jc, jnp.asarray(sigma), None,
            chain_block=2, weights=None if w is None else jnp.asarray(w),
            variates=(jnp.asarray(u), jnp.asarray(zn)), interpret=True)
        ts, tvc = tk.bart_sweep_fused_batch_tiled(
            tcfg, ts, torch.as_tensor(yb), tc, torch.as_tensor(sigma), None,
            weights=None if w is None else torch.as_tensor(w),
            variates=(torch.as_tensor(u), torch.as_tensor(zn)))
        for name in ("feature", "cut", "leaf_idx"):
            np.testing.assert_array_equal(
                np.asarray(getattr(js, name)), getattr(ts, name).numpy(),
                err_msg=f"sweep {sweep}: {name}")
        np.testing.assert_array_equal(np.asarray(jvc), tvc.numpy())
        np.testing.assert_allclose(np.asarray(js.leaf_value),
                                   ts.leaf_value.numpy(), **LV_TOL)
        np.testing.assert_allclose(np.asarray(js.allfit), ts.allfit.numpy(),
                                   **FIT_TOL)
        np.testing.assert_allclose(np.asarray(js.tree_fit),
                                   ts.tree_fit.numpy(), **FIT_TOL)
    assert int((ts.feature >= 0).sum()) > 3 * C
    np.testing.assert_allclose(ts.tree_fit.sum(1).numpy(), ts.allfit.numpy(),
                               rtol=1e-4, atol=1e-4)


def _program():
    d = generate_friedman_data(120, ranef=True, causal=False)
    mf = build_model_frame("y ~ bart(. - g.1 - g.2 - X4) + X4 + (1 | g.1)",
                           friedman_dataframe(d))
    pm, _, _ = build_parametric_model(mf, "gaussian", {"max_treedepth": 5},
                                      dtype=torch.float32, device="cpu")
    return tg.GibbsProgram(pm, tb.BartConfig(num_trees=6), mf.y, mf.bart_X,
                           warmup=2, iterations=2,
                           dtype=torch.float32, device="cpu")


def _two_steps(prog):
    gen = torch.Generator()
    gen.manual_seed(4)
    states = prog.init_state(gen, 3)
    draws = []
    for it in range(2):
        states, d = prog.step_batched(states, it, True, gen)
        draws.append(d)
    return draws


def test_gibbs_routes_large_n_through_the_tiled_wrapper(monkeypatch):
    calls = {"batch": 0, "tiled": 0}

    def spy(key, fn):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tg, "bart_sweep_fused_batch",
                        spy("batch", tk.bart_sweep_fused_batch))
    monkeypatch.setattr(tg, "bart_sweep_fused_batch_tiled",
                        spy("tiled", tk.bart_sweep_fused_batch_tiled))
    prog = _program()
    assert not prog.sweep_tiled
    ref = _two_steps(prog)
    assert calls == {"batch": 3, "tiled": 0}

    monkeypatch.setattr(tg, "MAX_NPAD", 0)
    prog = _program()
    assert prog.sweep_tiled
    out = _two_steps(prog)
    assert calls == {"batch": 3, "tiled": 3}
    for a, b in zip(ref, out):
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            if x is None:      # no stored forests without keep_trees
                assert y is None, name
                continue
            assert torch.isfinite(y.float()).all(), name
            assert torch.equal(x, y), name


def _cuda_inputs(n, seed):
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, P))
    y = np.sin(X[:, 0]) + X[:, 1] ** 2 + rng.normal(scale=0.5, size=n)
    tcfg = tb.BartConfig(num_trees=T)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, tcfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = tb.sample_trees_from_prior(
        tcfg, gen, torch.as_tensor(ranks, device=dev), sp, C,
        dtype=torch.float32)
    consts = tk.make_sweep_consts(tcfg, ranks, sp, device=dev)
    var = tb.draw_variates(gen, C, T, torch.float32, dev)
    yt = torch.as_tensor(y, dtype=torch.float32, device=dev)
    return (tcfg, state.feature, state.cut, state.leaf_idx, state.tree_fit,
            yt.expand(C, n).contiguous(), torch.full((C,), 0.81, device=dev),
            state.sigma_mu ** 2, var[0], var[1], consts)


@pytest.mark.cuda
def test_cuda_tiled_kernel_matches_plain_and_batch_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    # several tiles of the kernel, n not a multiple of the tile
    args = _cuda_inputs(12_345, 6)
    k = tk.sweep_tiled_cuda(*args)
    p = tk.sweep_plain(*args)
    torch.cuda.synchronize()
    for i in (0, 1, 3):
        assert torch.equal(k[i], p[i])
    torch.testing.assert_close(k[2], p[2], **LV_TOL)
    torch.testing.assert_close(k[4], p[4], **FIT_TOL)
    torch.testing.assert_close(k[5], p[5], **FIT_TOL)
    # where both kernels run they take every sum in the same order
    args = _cuda_inputs(3_000, 7)
    k = tk.sweep_tiled_cuda(*args, cluster=1)
    b = tk.sweep_cuda(*args, cluster=1)
    torch.cuda.synchronize()
    for x, y in zip(k, b):
        assert torch.equal(x, y)
