"""``GibbsProgram`` with one response per chain, a (C, N) ``y``, which the
SBC harness (``stan4bart_torch/utils/sbc.py``) runs its reps as, on the
CPU in float64.

- A (C, N) y that repeats one y in every chain gives draws equal to the
  bit to the (N,) program's, gaussian (with the interweave, the leaf
  block and the sigma slice draw) and probit, through ``step_batched``
  and the per-chain ``step``.
- ``gram_anchor``, the linear refresh and the initial inverse metric on
  a (C, N) y equal a loop of single-y calls (1e-12).
- A y whose rows do not match the chain count raises.
- A tiny probit ``run_cell`` returns ranks in [0, L] and finite p."""

import numpy as np
import pytest
import torch

from stan4bart_torch.gibbs import GibbsProgram
from stan4bart_torch.ops.nuts import NutsConfig
from stan4bart_torch.utils import sbc

torch.set_num_threads(2)

C = 4


def _program(cell, y, **kw):
    """``sbc.build_cell``'s program for ``cell`` on the CPU, rebuilt with
    response ``y`` and ``kw`` (warmup 6, 6 iterations, NUTS trees of
    depth at most 5 to keep the identities cheap)."""
    mf, pm, prog, cfg = sbc.build_cell(sbc.CELLS[cell], seed=0,
                                       device="cpu", warmup=6, iters=6)
    args = dict(weights=prog.weights, warmup=6, iterations=6,
                dtype=torch.float64, device="cpu",
                linear_gibbs=prog.linear_gibbs, level_gibbs=prog.level_gibbs,
                leaf_block=prog.leaf_block,
                nuts_cfg=NutsConfig(max_treedepth=5))
    args.update(kw)
    return pm, GibbsProgram(pm, cfg, y, mf.bart_X, **args)


def _responses(cell, n):
    _, pm, prog, _ = sbc.build_cell(sbc.CELLS[cell], seed=0, device="cpu")
    _, _, y = sbc.simulate(pm, prog, sbc.CELLS[cell]["binary"],
                           np.random.default_rng(2), n)
    return y.numpy()


def _run(prog, per_chain):
    gen = torch.Generator()
    gen.manual_seed(9)
    states, draws, _ = prog.run_chains_chunked(gen, C, per_chain=per_chain)
    return states, draws


@pytest.mark.parametrize("cell,kw", [
    ("leaf_block", {"sigma_gibbs": True}),
    ("probit", {}),
])
@pytest.mark.parametrize("per_chain", [False, True])
def test_repeated_y_equals_single_y_to_the_bit(cell, kw, per_chain):
    y = _responses(cell, 1)[0]
    _, one = _program(cell, y, **kw)
    _, rep = _program(cell, np.tile(y, (C, 1)), **kw)
    assert rep.y.shape == (C, one.N) and rep.N == one.N
    s1, d1 = _run(one, per_chain)
    s2, d2 = _run(rep, per_chain)
    for name in ("stan", "bart_train", "varcount", "k"):
        np.testing.assert_array_equal(getattr(d1, name), getattr(d2, name),
                                      err_msg=name)
    torch.testing.assert_close(s1.nuts.inv_mass, s2.nuts.inv_mass,
                               rtol=0, atol=0)
    torch.testing.assert_close(s1.latents, s2.latents, rtol=0, atol=0)


def test_gram_anchor_and_linear_refresh_per_chain_y():
    ys = torch.as_tensor(_responses("interweave", C))
    pm, prog = _program("interweave", ys.numpy())
    rng = np.random.default_rng(4)
    u = torch.as_tensor(rng.normal(size=(C, pm.num_upars)) * 0.5)
    off = torch.as_tensor(rng.normal(size=(C, prog.N)))
    z = torch.as_tensor(rng.standard_normal((C, pm.gram_G.shape[0])))
    batch = pm.gram_anchor(u, off, ys)
    refresh = pm.linear_gibbs_refresh(u, off, ys, z=z)
    for c in range(C):
        one = pm.gram_anchor(u[c:c + 1], off[c:c + 1], ys[c])
        for a, b in zip(batch, one):
            torch.testing.assert_close(a[c:c + 1], b, rtol=0, atol=1e-12)
        torch.testing.assert_close(
            refresh[c:c + 1],
            pm.linear_gibbs_refresh(u[c:c + 1], off[c:c + 1], ys[c],
                                    z=z[c:c + 1]),
            rtol=0, atol=1e-12)


def test_initial_inverse_metric_per_chain_y():
    ys = _responses("qr", C)
    pm, prog = _program("qr", ys)
    gen = torch.Generator()
    gen.manual_seed(1)
    inv_mass = prog.init_state(gen, C).nuts.inv_mass
    for c in range(C):
        _, one = _program("qr", ys[c])
        gen.manual_seed(1)
        want = one.init_state(gen, 1).nuts.inv_mass
        torch.testing.assert_close(inv_mass[c:c + 1], want, rtol=0,
                                   atol=1e-12)
    # the chains' metrics differ where their y do
    assert not torch.equal(inv_mass[0], inv_mass[1])


def test_per_chain_y_must_match_the_chains():
    _, prog = _program("continuous", _responses("continuous", C))
    with pytest.raises(ValueError, match="per-chain y"):
        prog.init_state(torch.Generator(), C + 1)


def test_tiny_probit_run_cell():
    out = sbc.run_cell("probit", sbc.CELLS["probit"], 8, seed=1,
                       device="cpu", warmup=10, iters=45, verbose=False)
    assert out["L"] == 9 and out["reps"] == 8
    assert "aux.1" not in out["quantities"]
    assert list(out["quantities"])[-3:] == ["f.0", "f.1", "f.mean"]
    for q in out["quantities"].values():
        assert len(q["counts"]) == 10 and sum(q["counts"]) == 8
        assert np.isfinite(q["p"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["kernel_f32", "probit"])
def test_cuda_graphed_gram_logp_matches_eager(cell):
    """On the card the Gram log-density's value and gradient at (C, D)
    points replay one CUDA graph (``models/parametric.py`` ``GramGraph``);
    they equal the eager evaluation's to the bit, and a new anchor binds
    the same graph."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from stan4bart_torch.ops.nuts import value_and_grad

    spec = sbc.CELLS[cell]
    _, pm, prog, _ = sbc.build_cell(spec, seed=0, device="cuda")
    _, _, y = sbc.simulate(pm, prog, spec["binary"],
                           np.random.default_rng(3), 16)
    prog.y = y
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    st = prog.init_state(gen, 16)
    y_stan = st.latents if prog.is_binary else prog.y
    logp = prog._logp(st.nuts.q, st.stan_offset, y_stan)
    for k in range(3):
        q = st.nuts.q + 0.1 * k * torch.randn(
            st.nuts.q.shape, generator=gen, dtype=prog.dtype, device="cuda")
        got = logp.replay(q)
        want = value_and_grad(lambda u: logp(u), q)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(value_and_grad(logp, q)[1], want[1])
    newer = prog._logp(st.nuts.q + 0.5, st.stan_offset, y_stan)
    assert newer is logp
    got = newer.replay(st.nuts.q)
    want = value_and_grad(lambda u: newer(u), st.nuts.q)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
