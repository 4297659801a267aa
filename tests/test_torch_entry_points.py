"""The port's entry points on the CPU: a probit fit of the flagship model
(shapes and finiteness), every entry point's refusal to run without CUDA
unless asked for the CPU (the standalone samplers too, and their refusal
of a generator on another device), and the port importing no JAX.  The
default fit against the JAX package's is tests/test_torch_fit.py."""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.convert import state_from_numpy
from stan4bart_torch.ops.advi import advi
from stan4bart_torch.ops.bart import BartConfig, bart_init
from stan4bart_torch.ops.bart_sweep_kernel import make_sweep_consts
from stan4bart_torch.ops.nuts_driver import nuts_sample
from stan4bart_torch.ops.smc import smc_sample
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")
N = 200


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
    # so do the standalone samplers, and each refuses a generator on
    # another device than its own (a CUDA generator's stand-in here)
    def logp(q):
        return -0.5 * (q * q).sum(-1)

    gen = torch.Generator()
    cuda_gen = SimpleNamespace(device=torch.device("cuda", 0))
    for run in (lambda g, **kw: advi(logp, 2, g, max_iters=50, **kw),
                lambda g, **kw: smc_sample(logp, 2, 64, g, **kw),
                lambda g, **kw: nuts_sample(logp, np.zeros(2), g, 2, 2,
                                            **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run(gen)
        with pytest.raises(RuntimeError,
                           match="generator is on cuda:0, the sampler on "
                                 "cpu"):
            run(cuda_gen, device="cpu")
    # p_regrow is ported: with device="cpu" it runs the plain sweep
    fit = stan4bart_torch.stan4bart("y ~ bart(X1 + X2) + X4", df, iter=4,
                                    chains=1, device="cpu", verbose=-1,
                                    bart_args={"p_regrow": 0.2})
    assert fit.prog.bart_cfg.p_regrow == 0.2
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
        "import stan4bart_torch.utils.ihdp, stan4bart_torch.utils.profiling\n"
        "assert not any(m.split('.')[0] in ('jax', 'stan4bart_tpu') "
        "for m in sys.modules)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
