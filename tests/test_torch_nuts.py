"""The port's batched NUTS against the JAX package's, on replayed draws.

The JAX transition draws its momentum and both uniform tables from
``jax.random`` key splits (ops/nuts.py:308-316); the test replays them and
hands them to the port's ``nuts_transition``.  From the same state on the
same (Gram-anchored) flagship log-density, every chain must build the same
trajectory: treedepth and n_leapfrog equal, q / lp / accept_stat /
stepsize equal within float64 round-off (1e-9 relative; the gradients are
the same arithmetic in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stan4bart_torch.convert import nuts_state_from_numpy
from stan4bart_torch.formula import build_model_frame as port_mf
from stan4bart_torch.models.assemble import build_parametric_model as port_pm
from stan4bart_torch.ops import nuts as tn
from stan4bart_tpu.formula import build_model_frame as ref_mf
from stan4bart_tpu.models.assemble import build_parametric_model as ref_pm
from stan4bart_tpu.ops import nuts as jn
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")
C = 4
MAX_DEPTH = 4
TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(scope="module")
def problem():
    d = generate_friedman_data(120, ranef=True, causal=True)
    df = friedman_dataframe(d)
    rmf, pmf = ref_mf(FLAGSHIP, df), port_mf(FLAGSHIP, df)
    rpm, _, _ = ref_pm(rmf, "gaussian", {})
    ppm, _, _ = port_pm(pmf, "gaussian", {}, device="cpu")
    rpm.enable_gram()
    ppm.enable_gram()
    rng = np.random.default_rng(0)
    U = rng.uniform(-0.5, 0.5, size=(C, rpm.num_upars))
    off = d["mu_bart"][None] + rng.normal(scale=0.1, size=(C, rmf.N))
    y = np.asarray(rmf.y)
    inv = np.array(rpm.initial_inv_mass(float(np.std(y, ddof=1)), rmf.N))
    # per-chain anchors, vmapped: the reference runs one compiled
    # transition over all chains
    ref_anchor = jax.vmap(lambda u, o: rpm.gram_anchor(u, o, jnp.asarray(y)))(
        jnp.asarray(U), jnp.asarray(off))
    anchor = ppm.gram_anchor(torch.as_tensor(U), torch.as_tensor(off),
                             torch.as_tensor(y))
    return (U, inv, rpm.log_prob_gram, ref_anchor,
            lambda u: ppm.log_prob_gram(u, anchor))


@pytest.mark.parametrize("flags", [(True, True, True), (False, False, False)])
def test_transition_matches_on_replayed_draws(problem, flags):
    """A warmup transition that adapts the stepsize, collects the metric
    and ends a metric window (stepsize re-search off, so the window end
    is deterministic), and a sampling transition at the frozen
    stepsize."""
    U, inv, ref_lpg, ref_anchor, port_logp = problem
    cfg = jn.NutsConfig(max_treedepth=MAX_DEPTH, window_end_research=False)
    tcfg = tn.NutsConfig(max_treedepth=MAX_DEPTH, window_end_research=False)

    def init(u):
        st = jn.nuts_init(None, u, stepsize=0.05)
        return st._replace(
            inv_mass=jnp.asarray(inv),
            welford=jn.WelfordState(jnp.asarray(8.0), u * 0.5,
                                    jnp.abs(u) + 0.1),
            da=st.da._replace(count=jnp.asarray(3.0),
                              log_eps_bar=jnp.asarray(np.log(0.04))))

    states = jax.vmap(init)(jnp.asarray(U))
    keys = jax.random.split(jax.random.PRNGKey(100), C)
    ref_state, ref_info = jax.tree_util.tree_map(np.asarray, jax.jit(
        jax.vmap(lambda st, k, a: jn.nuts_transition(
            lambda u: ref_lpg(u, a), st, k, cfg, *flags)))(
                states, keys, ref_anchor))

    def replay(key):
        _, r_mom, _, r_traj = jax.random.split(key, 4)
        return (jax.random.normal(r_mom, (len(inv),), jnp.float64),
                jax.random.uniform(r_traj, (2 ** MAX_DEPTH + 1,),
                                   jnp.float64),
                jax.random.uniform(jax.random.fold_in(r_traj, 1),
                                   (MAX_DEPTH, 2), jnp.float64))

    mom, u_leaf, u_depth = (torch.as_tensor(np.array(x))
                            for x in jax.vmap(replay)(keys))
    new, info = tn.nuts_transition(port_logp,
                                   nuts_state_from_numpy(states, device="cpu"),
                                   None, tcfg, *flags, momentum=mom,
                                   u_leaf=u_leaf, u_depth=u_depth)
    for name in ("treedepth", "n_leapfrog", "divergent"):
        np.testing.assert_array_equal(getattr(ref_info, name),
                                      getattr(info, name).numpy(), name)
    for name in ("lp", "accept_stat", "stepsize", "energy"):
        np.testing.assert_allclose(getattr(ref_info, name),
                                   getattr(info, name).numpy(), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(ref_state.q, new.q.numpy(), **TOL)
    np.testing.assert_allclose(ref_state.inv_mass, new.inv_mass.numpy(),
                               **TOL)
    for name in ("log_eps", "log_eps_bar", "h_bar", "mu", "count"):
        np.testing.assert_allclose(getattr(ref_state.da, name),
                                   getattr(new.da, name).numpy(), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(ref_state.welford.m2, new.welford.m2.numpy(),
                               **TOL)
    assert info.n_leapfrog.min() >= 1


def test_init_stepsize_matches(problem):
    U, inv, ref_lpg, ref_anchor, port_logp = problem
    keys = jax.random.split(jax.random.PRNGKey(7), C)
    ref = jax.jit(jax.vmap(lambda u, k, a: jn.init_stepsize(
        lambda x: ref_lpg(x, a), u, jnp.asarray(inv), 1.0, k)))(
            jnp.asarray(U), keys, ref_anchor)
    mom = jax.vmap(lambda k: jax.random.normal(k, (len(inv),),
                                               jnp.float64))(keys)
    port = tn.init_stepsize(port_logp, torch.as_tensor(U),
                            torch.as_tensor(inv).expand(C, -1), 1.0, None,
                            momentum=torch.as_tensor(np.array(mom)))
    np.testing.assert_allclose(np.asarray(ref), port.numpy(), **TOL)
    assert len(set(np.asarray(ref).round(12))) > 1


@pytest.mark.parametrize("num_warmup", [10, 60, 150, 1000])
def test_adapt_schedule_matches(num_warmup):
    ref = jn.make_adapt_schedule(num_warmup)
    port = tn.make_adapt_schedule(num_warmup)
    for k in ref:
        np.testing.assert_array_equal(ref[k], port[k])
