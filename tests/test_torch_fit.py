"""The port's default fit against the JAX package's, end to end on the CPU.

One small fit of each package on the same Friedman data (n = 200, 20 trees,
2 chains, 100 iterations, treedepth capped at 6): the draw-row layout
must match, and the posteriors must agree within Monte-Carlo error —
the two samplers share no random stream, so agreement is statistical:

* cor(posterior-mean BART fit of the port, of the reference) >= 0.95;
* posterior-mean sigma within 0.5 of each other: at 50 warmup
  iterations both are still relaxing from above, and over seeds 3-6 the
  difference ran 0.09-0.22 (seed-to-seed sd of the difference about 0.16,
  so 0.5 is three of them);
* posterior-mean fixed effects within 3 posterior standard deviations.

A probit fit of the port at the same size checks shapes and finiteness,
and the entry points must refuse to run without CUDA unless asked for
the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import stan4bart_torch
import stan4bart_tpu
from stan4bart_torch.convert import state_from_numpy
from stan4bart_torch.ops.bart import BartConfig, bart_init
from stan4bart_torch.ops.bart_sweep_kernel import make_sweep_consts
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")
N, CHAINS, ITER, WARMUP = 200, 2, 100, 50
KW = dict(treatment="z", chains=CHAINS, iter=ITER, warmup=WARMUP, verbose=-1,
          stan_args={"max_treedepth": 6}, bart_args={"n.trees": 20})


@pytest.fixture(scope="module")
def fits():
    d = generate_friedman_data(N, ranef=True, causal=True)
    df = friedman_dataframe(d)
    ref = stan4bart_tpu.stan4bart(FLAGSHIP, df, seed=3, **KW)
    port = stan4bart_torch.stan4bart(FLAGSHIP, df, seed=3, device="cpu",
                                     dtype=torch.float64, **KW)
    return d, ref, port


def test_draw_layout_matches(fits):
    d, ref, port = fits
    assert port.stan_names == ref.stan_names
    kept = ITER - WARMUP
    for typ in ("stan", "ev", "indiv.bart", "indiv.fixef", "indiv.ranef",
                "fixef", "sigma", "varcount", "k"):
        assert port.extract(typ).shape == ref.extract(typ).shape, typ
    assert port.extract("ev", sample="test").shape == (N, kept * CHAINS)
    assert port.extract("stan", include_warmup=True).shape[-1] == \
        ITER * CHAINS
    assert port.extract("ranef").keys() == ref.extract("ranef").keys()
    for name in ("stan", "bart_train", "bart_test", "varcount", "k"):
        assert np.all(np.isfinite(getattr(port.draws, name))), name
    s = port.summary()
    assert s["names"] == ref.summary()["names"]
    assert np.all(np.isfinite(s["rhat"])) and np.all(s["ess"] > 0)


def test_posteriors_agree(fits):
    d, ref, port = fits
    bp, br = port.fitted("indiv.bart"), ref.fitted("indiv.bart")
    cor = np.corrcoef(bp - bp.mean(), br - br.mean())[0, 1]
    assert cor >= 0.95, f"cor(port bart, reference bart) = {cor}"
    truth = d["mu_bart"] - d["mu_bart"].mean()
    assert np.corrcoef(bp - bp.mean(), truth)[0, 1] >= 0.9
    s_p, s_r = float(port.fitted("sigma")), float(ref.fitted("sigma"))
    assert abs(s_p - s_r) < 0.5, (s_p, s_r)
    fx_p, fx_r = port.fitted("fixef"), ref.fitted("fixef")
    sd = port.extract("fixef").std(axis=-1)
    assert np.all(np.abs(fx_p - fx_r) < 3 * sd), (fx_p, fx_r, sd)
    ev = port.fitted("ev")
    parts = (port.fitted("indiv.bart") + port.fitted("indiv.fixef")
             + port.fitted("indiv.ranef"))
    np.testing.assert_allclose(ev, parts, atol=1e-8)


def test_port_continues_from_reference_state(fits):
    """A final sampler state of the JAX fit carried into the port
    (convert.state_from_numpy): the port's log-density at it equals the
    reference's last lp__, and the port runs on from it."""
    d, ref, port = fits
    state = state_from_numpy(ref.final_states, device="cpu")
    lp = port.pm.log_prob(state.nuts.q, state.stan_offset, port.prog.y)
    np.testing.assert_allclose(lp.numpy(), ref.draws.stan[:, -1, 0],
                               rtol=1e-9)
    gen = torch.Generator()
    gen.manual_seed(0)
    new, draw = port.prog.step_batched(state, 0, False, gen)
    assert draw.stan.shape == (CHAINS, len(port.stan_names))
    assert torch.isfinite(draw.stan).all()
    assert torch.isfinite(new.bart.allfit).all()


def test_probit_fit_runs():
    d = generate_friedman_data(N, ranef=True, causal=True, binary=True)
    df = friedman_dataframe(d)
    fit = stan4bart_torch.stan4bart(
        FLAGSHIP, df, chains=2, iter=30, warmup=15, seed=1, verbose=-1,
        bart_args={"n.trees": 10}, stan_args={"max_treedepth": 5},
        device="cpu")
    assert fit.family == "binomial"
    assert "aux.1" not in fit.stan_names
    ev = fit.extract("ev")
    assert ev.shape == (N, 15 * 2)
    assert np.all((ev >= 0) & (ev <= 1))
    for name in ("stan", "bart_train", "varcount"):
        assert np.all(np.isfinite(getattr(fit.draws, name))), name
    with pytest.raises(ValueError):
        fit.extract("sigma")


def test_entry_points_need_cuda_or_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    df = friedman_dataframe(generate_friedman_data(50, ranef=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stan4bart_torch.stan4bart("y ~ bart(X1 + X2) + X4", df, iter=4)
    # the constructors below stan4bart() default to the card as well
    cfg = BartConfig(num_trees=2)
    ranks = np.zeros((50, 2), np.int32)
    for build in (lambda: bart_init(cfg, 2, 50),
                  lambda: make_sweep_consts(cfg, ranks, [0.5, 0.5]),
                  lambda: state_from_numpy(None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    # what stays unported names its ROADMAP queue item
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        stan4bart_torch.stan4bart("y ~ bart(X1 + X2) + X4", df, iter=4,
                                  device="cpu",
                                  bart_args={"p_regrow": 0.2})
    # obs_shards is ported: outside a world of several ranks it is the
    # JAX package's device-count error
    with pytest.raises(ValueError, match="must divide the global device"):
        stan4bart_torch.stan4bart("y ~ bart(X1 + X2) + X4", df, iter=4,
                                  device="cpu", stan_args={"obs_shards": 2})


def test_port_imports_without_jax():
    """The port never imports jax, nor anything of the JAX package."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', "
        "'stan4bart_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import stan4bart_torch, stan4bart_torch.convert\n"
        "import stan4bart_torch.ops.cuda_build\n"
        "import stan4bart_torch.ops.advi, stan4bart_torch.ops.smc\n"
        "import stan4bart_torch.ops.nuts_driver\n"
        "import stan4bart_torch.parallel.mesh\n"
        "import stan4bart_torch.parallel._mh_worker\n"
        "assert not any(m.split('.')[0] in ('jax', 'stan4bart_tpu') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
