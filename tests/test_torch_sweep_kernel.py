"""The port's whole-sweep kernel wrapper against the JAX package's.

On a CPU tensor ``stan4bart_torch...bart_sweep_fused_batch`` runs its plain
PyTorch version; it is held here against the JAX package's
``bart_sweep_fused_batch`` (the chain-blocked Pallas kernel, interpreted
on the CPU) in float32 on shared variates.  Tolerances are those of the
JAX package's own kernel-vs-XLA test (tests/test_sweep_kernel.py): the two
sum the same float32 terms in another order.  The CUDA kernel itself is
checked against the plain version on the card (marker ``cuda``; skipped
without a GPU) and by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stan4bart_torch.convert import bart_state_from_numpy
from stan4bart_torch.ops import bart as tb
from stan4bart_torch.ops import bart_sweep_kernel as tk
from stan4bart_tpu.ops import bart as jb
from stan4bart_tpu.ops import bart_sweep_kernel as jk

torch.set_num_threads(2)

N, P, T, C = 200, 5, 10, 4
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
def test_plain_sweep_matches_interpreted_tpu_kernel(weighted):
    cfg, tcfg, y, ranks, sp, js = _setup(3 if weighted else 4)
    ts = bart_state_from_numpy(js, dtype=torch.float32, device="cpu")
    jc = jk.make_sweep_consts(cfg, ranks, sp)
    tc = tk.make_sweep_consts(tcfg, ranks, sp, device="cpu")
    rng = np.random.default_rng(11)
    w = (rng.uniform(0.5, 2.0, N).astype(np.float32) if weighted
         else None)
    sigma = np.array([0.6, 0.8, 1.0, 1.2], np.float32)
    yb = np.broadcast_to(y, (C, N))
    for sweep in range(3):
        u = rng.uniform(size=(C, T, 8)).astype(np.float32)
        zn = rng.normal(size=(C, T, 128)).astype(np.float32)
        js, jvc = jk.bart_sweep_fused_batch(
            cfg, js, jnp.asarray(yb), jc, jnp.asarray(sigma), None,
            chain_block=2, weights=None if w is None else jnp.asarray(w),
            variates=(jnp.asarray(u), jnp.asarray(zn)), interpret=True)
        ts, tvc = tk.bart_sweep_fused_batch(
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
    # the fit invariant: allfit is the sum of the cached tree fits
    np.testing.assert_allclose(ts.tree_fit.sum(1).numpy(), ts.allfit.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_kernel_limits_raise():
    tcfg = tb.BartConfig(num_trees=2)
    ranks = np.zeros((10_400, 3), np.int32)
    consts = tk.make_sweep_consts(tcfg, ranks, np.full(3, 1 / 3),
                                  device="cpu")
    assert consts.npad > tk.MAX_NPAD
    # past npad 10368 only the obs-tiled kernel takes the sweep
    with pytest.raises(ValueError, match="bart_sweep_fused_batch_tiled"):
        tk.check_kernel_supports(consts, torch.float32)
    tk.check_kernel_supports(consts, torch.float32, "bart_sweep_tiled")
    # float32 and float64 state (each its own build), no other type
    for kernel in ("bart_sweep_batch", "bart_sweep_tiled"):
        tk.check_kernel_supports(consts._replace(npad=128), torch.float64,
                                 kernel)
        with pytest.raises(ValueError, match="float32 or float64"):
            tk.check_kernel_supports(consts._replace(npad=128),
                                     torch.float16, kernel)
    tk.check_kernel_supports(consts._replace(npad=tk.MAX_NPAD),
                             torch.float32)
    # deeper trees: any depth on the CPU and on the card (zn rows of
    # node_pad normals): the static builds' 512- and 1024-slot heaps, past
    # them the heap builds, each build's own shared memory setting its
    # single-pass ceiling (past 10368)
    for depth, pad in ((7, 512), (8, 512), (9, 1024), (10, 2048)):
        deep = tk.make_sweep_consts(tb.BartConfig(num_trees=2,
                                                  max_depth=depth),
                                    ranks, np.full(3, 1 / 3), device="cpu")
        assert deep.node_pad == pad
        assert tk.heap_build(pad) == (pad not in tb.HEAP_PADS)
        tk.check_kernel_supports(deep._replace(npad=128), torch.float32)
    for pad in (512, 1024, 2048):
        single, chain = tk.on_chip_ceilings(pad, 2)
        assert tk.MAX_NPAD < single < tk.MAX_N_CHAIN < chain
        tk.check_kernel_supports(deep._replace(node_pad=pad), torch.float32)
        with pytest.raises(ValueError, match="bart_sweep_fused_batch_tiled"):
            tk.check_kernel_supports(
                deep._replace(node_pad=pad, npad=single + 128),
                torch.float32)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    cfg, tcfg, y, ranks, sp, js = _setup(5)
    state = bart_state_from_numpy(js, dtype=torch.float32, device=dev)
    consts = tk.make_sweep_consts(tcfg, ranks, sp, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    var = tb.draw_variates(gen, C, T, torch.float32, dev)
    args = (tcfg, state.feature, state.cut, state.leaf_idx, state.tree_fit,
            torch.as_tensor(y, device=dev).expand(C, N).contiguous(),
            torch.full((C,), 0.81, device=dev), state.sigma_mu ** 2,
            var[0], var[1], consts)
    k = tk.sweep_cuda(*args)
    p = tk.sweep_plain(*args)
    torch.cuda.synchronize()
    for a, b in zip(k[:2], p[:2]):
        assert torch.equal(a, b)
    assert torch.equal(k[3], p[3])
    torch.testing.assert_close(k[2], p[2], **LV_TOL)
    torch.testing.assert_close(k[5], p[5], **FIT_TOL)
