"""The port's in-sweep subtree-regrow move in the observation-sharded
sweep against the JAX package's ``bart_sweep`` with ``axis_name``, on
the same randomness (tests/test_torch_regrow_sweep.py's replayed keys).

Two shards of the plain sweep (``_sharded_sweep``: two threads of this
process, the reduce hook a sum over the shards) with ``p_regrow = 1``,
unweighted and weighted.  Tolerance: forests identical, float64 values
within 1e-9 (the same arithmetic, per-node sums taken in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stan4bart_torch.ops import bart as tb
from stan4bart_tpu.ops import bart as jb
from test_torch_regrow_sweep import (
    CUTS,
    C,
    DEPTH,
    N,
    T,
    TOL,
    VALUES,
    _assert_same,
    _forest,
    _jax_sweep,
    _replayed,
    _sharded_sweep,
)

torch.set_num_threads(2)


def _jax_sharded_sweep(p, state, y_target, ranks, sp, sigma, w, keys,
                       shards=2):
    """The JAX sweep with ``axis_name="data"`` over ``shards`` shards: an
    outer vmap over the shards carries the axis name, an inner vmap the
    chains; the keys are the same on every shard."""
    jcfg = jb.BartConfig(num_trees=T, max_depth=DEPTH, n_cuts=CUTS,
                         p_regrow=p)
    split = lambda a: jnp.asarray(np.stack(np.split(a, shards, -1)))  # noqa: E731
    rep = lambda a: jnp.asarray(np.broadcast_to(a, (shards,) + a.shape))  # noqa: E731
    st = {k: getattr(state, k).numpy() for k in state._fields}
    js = jb.BartState(**{k: split(v) if k in ("leaf_idx", "allfit",
                                               "tree_fit") else rep(v)
                         for k, v in st.items()})
    ranks_sh = jnp.asarray(np.stack(np.split(ranks, shards, 0)))
    w_sh = split(w) if w is not None else jnp.zeros((shards, N // shards))

    def one_shard(s, y_s, rk_s, w_s):
        return jax.vmap(lambda sc, yc, sg, k: jb.bart_sweep(
            jcfg, sc, yc, rk_s, sp, sg, k,
            weights=None if w is None else w_s, axis_name="data")[0])(
                s, y_s, jnp.asarray(sigma.numpy()), keys)

    return jax.jit(jax.vmap(one_shard, axis_name="data"))(
        js, split(y_target.numpy()), ranks_sh, w_sh)


@pytest.mark.parametrize("weights", [False, True])
def test_sharded_in_sweep_regrow_matches_reference(weights):
    """Two shards of the plain sweep with p_regrow = 1 against the JAX
    package's sharded sweep on the same shards and keys: identical
    forests on both shards, values within 1e-9; one reduction per tree
    update and one per tree whose regrow gate opens in some chain; and
    against the unsharded sweep (port and JAX).  Weighted, this data has
    a change move whose right child is empty: the sharded sweep sums the
    proposed-right pair, so its weight is 0 there as in the unsharded
    sweep, where a difference of per-node sums could leave a rounding
    residue that passes the move's non-empty check."""
    cfg, state, y_target, ranks, sp, sigma, w = _forest(weights)
    cfg = cfg._replace(p_regrow=1.0)
    keys = jax.random.split(jax.random.PRNGKey(13), C)
    variates, _ = _replayed(keys, cfg.max_nodes)
    ref = _jax_sharded_sweep(1.0, state, y_target, ranks, sp, sigma, w,
                             keys)
    shards, calls = _sharded_sweep(cfg, state, y_target, ranks, sp, sigma,
                                   w, variates)
    assert calls == [2 * T, 2 * T]
    n = N // 2
    for d, part in enumerate(shards):
        for name in ("feature", "cut"):
            np.testing.assert_array_equal(np.asarray(getattr(ref, name))[d],
                                          getattr(part, name).numpy())
        np.testing.assert_array_equal(np.asarray(ref.leaf_idx)[d],
                                      part.leaf_idx.numpy())
        for name in VALUES:
            np.testing.assert_allclose(np.asarray(getattr(ref, name))[d],
                                       getattr(part, name).numpy(), **TOL,
                                       err_msg=name)
    assert not torch.equal(shards[0].feature, state.feature)
    whole, _ = tb.bart_sweep(cfg, state, y_target, torch.as_tensor(ranks),
                             sp, sigma, weights=w, variates=variates)
    _assert_same(_jax_sweep(1.0, 0, state, y_target, ranks, sp, sigma, w,
                            keys), whole, state)
    for d, part in enumerate(shards):
        sl = slice(d * n, (d + 1) * n)
        for name in ("feature", "cut"):
            assert torch.equal(getattr(part, name), getattr(whole, name))
        assert torch.equal(part.leaf_idx, whole.leaf_idx[..., sl])
        torch.testing.assert_close(part.leaf_value, whole.leaf_value, **TOL)
        torch.testing.assert_close(part.tree_fit, whole.tree_fit[..., sl],
                                   **TOL)
