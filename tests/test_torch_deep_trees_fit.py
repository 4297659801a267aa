"""A fit with trees deeper than 6 (``bart_args={"max_depth": 8}``): the
port on the CPU against the JAX package, whose XLA sweep takes any depth.

One fit of each package at the sizes of tests/test_torch_fit.py (n = 200,
20 trees, 2 chains, 70 iterations of which 50 warmup, treedepth capped
at 6), with ``keep_trees``, the reference's in a thread beside the
port's.  The samplers share no random stream, so the posteriors are
compared as there: cor(posterior-mean BART fits) >= 0.95, sigma within
0.5, fixed effects within 3 posterior sd.  Over seeds 3-7 at 70
iterations: cor 0.960-0.977, sigma differences 0.03-0.20 (sd 0.14, so
0.5 is more than three of them), fixed effects within 1.3 sd; at 100
iterations cor 0.966-0.981 and sd 0.10.  On the reference's own stored
depth-8 forests of its last 5 iterations, carried into the port
(``convert.draws_from_numpy``), ``predict`` equals the reference's to
1e-12 and ``trees()`` and the ``print_trees`` text are identical; the
reference's final state (``convert.state_from_numpy``) has the
reference's last lp__ under the port's model and sweeps on.  The port's
fit stores (chains, iterations, trees, 511) forests, and ``save`` /
``load`` gives it back to the bit."""

from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import pytest
import torch

import stan4bart_torch
import stan4bart_tpu
from stan4bart_torch.convert import draws_from_numpy, state_from_numpy
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")
N, CHAINS, ITER, WARMUP = 200, 2, 70, 50
KW = dict(treatment="z", chains=CHAINS, iter=ITER, warmup=WARMUP, verbose=-1,
          stan_args={"max_treedepth": 6},
          bart_args={"n.trees": 20, "max_depth": 8, "keep_trees": True})


@pytest.fixture(scope="module")
def fits():
    d = generate_friedman_data(N, ranef=True, causal=True)
    df = friedman_dataframe(d)
    # the reference compiles and runs in a thread beside the port's fit
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(stan4bart_tpu.stan4bart, FLAGSHIP, df, seed=3,
                          **KW)
        port = stan4bart_torch.stan4bart(FLAGSHIP, df, seed=3, device="cpu",
                                         dtype=torch.float64, **KW)
        ref = ref.result()
    return d, df, ref, port


@pytest.fixture(scope="module")
def carried(fits):
    """The port's fit object over the reference's stored forests."""
    _, _, ref, port = fits
    np.testing.assert_array_equal(port.prog.cuts, ref.prog.cuts)
    return replace(port, draws=draws_from_numpy(ref.draws),
                   warmup=ref.warmup)


def test_deep_fit_posteriors_agree(fits):
    d, _, ref, port = fits
    assert port.prog.bart_cfg.max_depth == 8
    assert port.prog.sweep_consts.node_pad == 512
    assert port.draws.tree_feature.shape == (CHAINS, ITER, 20, 511)
    for name in ("stan", "bart_train", "bart_test", "varcount", "k"):
        assert np.all(np.isfinite(getattr(port.draws, name))), name
    bp, br = port.fitted("indiv.bart"), ref.fitted("indiv.bart")
    cor = np.corrcoef(bp - bp.mean(), br - br.mean())[0, 1]
    assert cor >= 0.95, f"cor(port bart, reference bart) = {cor}"
    s_p, s_r = float(port.fitted("sigma")), float(ref.fitted("sigma"))
    assert abs(s_p - s_r) < 0.5, (s_p, s_r)
    fx_p, fx_r = port.fitted("fixef"), ref.fitted("fixef")
    sd = port.extract("fixef").std(axis=-1)
    assert np.all(np.abs(fx_p - fx_r) < 3 * sd), (fx_p, fx_r, sd)


def test_deep_save_load_roundtrip(fits, tmp_path):
    _, df, _, port = fits
    path = str(tmp_path / "deep.pkl")
    port.save(path)
    back = stan4bart_torch.Stan4bartFit.load(path, device="cpu")
    assert back.prog.bart_cfg.max_depth == 8
    for name in ("stan", "bart_train", "tree_feature", "tree_cut",
                 "tree_leaf_value"):
        np.testing.assert_array_equal(getattr(back.draws, name),
                                      getattr(port.draws, name), name)
    assert torch.equal(back.final_states.bart.feature,
                       port.final_states.bart.feature)
    np.testing.assert_array_equal(back.predict(df, type="indiv.bart"),
                                  port.predict(df, type="indiv.bart"))


def test_deep_forests_predict_and_print_as_reference(fits, carried, capsys):
    """The reference's depth-8 forests of its last 5 iterations (both
    fit objects read the draws after ``warmup``) walked by the port:
    ``predict`` to 1e-12, identical ``trees()`` and ``print_trees``."""
    _, df, ref, _ = fits
    assert ref.draws.tree_feature.shape[-1] == 511
    last = dict(warmup=ITER - 5)
    ref, carried = replace(ref, **last), replace(carried, **last)
    for type_ in ("indiv.bart", "ev"):
        want = ref.predict(df, type=type_, sample_new_levels=False)
        got = carried.predict(df, type=type_, sample_new_levels=False)
        assert got.shape == (N, 5 * CHAINS)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    want, got = ref.trees(), carried.trees()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for fit in (ref, carried):
        fit.print_trees(chains=1, samples=[0, 5], max_print=3)
    out = capsys.readouterr().out
    half = len(out) // 2
    assert out[:half] == out[half:] and "leaf" in out


def test_deep_reference_state_carries_into_the_port(fits):
    _, _, ref, port = fits
    state = state_from_numpy(ref.final_states, device="cpu")
    assert state.bart.feature.shape == (CHAINS, 20, 511)
    lp = port.pm.log_prob(state.nuts.q, state.stan_offset, port.prog.y)
    np.testing.assert_allclose(lp.numpy(), ref.draws.stan[:, -1, 0],
                               rtol=1e-9)
    gen = torch.Generator()
    gen.manual_seed(0)
    new, draw = port.prog.step_batched(state, 0, False, gen)
    assert torch.isfinite(draw.stan).all()
    assert torch.isfinite(new.bart.allfit).all()
    assert new.bart.feature.shape == (CHAINS, 20, 511)
