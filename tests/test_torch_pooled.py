"""Cross-chain pooled NUTS adaptation of the port (NutsConfig.pooled).

``pooled_welford_variance`` reduces over the chain dimension where the JAX
package's reduces over a vmapped axis with collectives; it is held against
the JAX function run under ``jax.vmap(axis_name=...)`` in float64.  Then
the structural contract of tests/test_pooled_adaptation.py:95-127 on the
port's Gibbs program (n = 150, 5 trees, 60 warmup iterations, 4 chains,
treedepth capped at 5): pooling "both" leaves one shared stepsize and
metric, "metric" a shared metric with per-chain stepsizes, and unpooled
chains adapt apart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stan4bart_torch.formula.design import build_model_frame
from stan4bart_torch.gibbs import GibbsProgram
from stan4bart_torch.models.assemble import build_parametric_model
from stan4bart_torch.ops.bart import BartConfig
from stan4bart_torch.ops.nuts import (
    NutsConfig,
    WelfordState,
    pooled_welford_variance,
)
from stan4bart_torch.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)
from stan4bart_tpu.ops import nuts as jn

torch.set_num_threads(2)


@pytest.mark.parametrize("between", [False, True])
def test_pooled_welford_variance_matches_reference(between):
    rng = np.random.default_rng(3)
    C, D, n = 4, 6, 9.0
    xs = rng.normal(size=(C, int(n), D)) * rng.uniform(0.5, 2.0, (C, 1, D))
    mean = xs.mean(1)
    m2 = ((xs - mean[:, None]) ** 2).sum(1)
    count = np.full(C, n)
    ref = jax.vmap(lambda w: jn.pooled_welford_variance(
        w, "chains", include_between=between), axis_name="chains")(
        jn.WelfordState(jnp.asarray(count), jnp.asarray(mean),
                        jnp.asarray(m2)))
    out = pooled_welford_variance(
        WelfordState(torch.as_tensor(count), torch.as_tensor(mean),
                     torch.as_tensor(m2)), include_between=between)
    assert out.shape == (C, D) and out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)
    # one pooled row for every chain
    assert torch.equal(out, out[:1].expand(C, D))


def _warm_states(nuts_cfg, chains=4, n=150, warmup=60):
    d = generate_friedman_data(n, ranef=True, causal=True)
    mf = build_model_frame(
        "y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 | g.1)",
        friedman_dataframe(d))
    pm, _, _ = build_parametric_model(mf, "gaussian", {},
                                      dtype=torch.float64, device="cpu")
    prog = GibbsProgram(pm, BartConfig(num_trees=5), mf.y, mf.bart_X,
                        warmup=warmup, iterations=5,
                        nuts_cfg=nuts_cfg._replace(max_treedepth=5),
                        dtype=torch.float64, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    states = prog.init_state(gen, chains)
    for it in range(warmup):
        states, _ = prog.step_batched(states, it, True, gen)
    return prog, states


def test_pooled_shares_stepsize_and_metric_across_chains():
    _, states = _warm_states(NutsConfig(pooled=True, pooled_parts="both"))
    # pooled DA consumes the chains' mean accept signal every iteration
    # and restarts from a consensus stepsize at window ends, so chain
    # stepsizes collapse to one value; same for the pooled metric
    log_eps = states.nuts.da.log_eps.numpy()
    np.testing.assert_allclose(log_eps, log_eps[0], rtol=1e-10)
    inv_mass = states.nuts.inv_mass.numpy()
    assert np.allclose(inv_mass, inv_mass[0:1], rtol=1e-10)
    assert np.all(np.isfinite(inv_mass)) and np.all(inv_mass > 0)


def test_pooled_metric_only_keeps_per_chain_stepsize():
    prog, states = _warm_states(NutsConfig(pooled=True))
    assert prog.nuts_cfg.pooled_parts == "metric"
    inv_mass = states.nuts.inv_mass.numpy()
    assert np.allclose(inv_mass, inv_mass[0:1], rtol=1e-10)
    assert np.ptp(states.nuts.da.log_eps.numpy()) > 0


def test_unpooled_chains_differ():
    _, states = _warm_states(NutsConfig())
    assert np.ptp(states.nuts.da.log_eps.numpy()) > 0
    assert np.ptp(states.nuts.inv_mass.numpy(), axis=0).max() > 0
