"""``cores`` in the port, as the JAX package reads it (stan4bart_tpu/fit.py:
chains spread over cores only where there is more than one device).

On one device (the CPU here, or one visible card) ``cores > 1`` runs the
single-device path and gives the draws of ``cores=None``; with more than
one visible CUDA device it hands the fit to ``parallel.mesh.
fit_on_devices``, one NCCL rank per card on min(cores, cards, chains)
cards (tests/test_torch_multihost.py runs that function on CPU ranks);
``cores <= 0`` is the reference's ValueError.  The fit is sized as
tests/test_cores_skip.py sizes its own: n = 100, 4 chains, 20 iterations,
4 trees."""

import inspect

import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = "y ~ bart(X1+X2) + X4 + (1 | g.2)"
KW = dict(chains=4, warmup=8, iter=20, seed=3, verbose=-1,
          bart_args={"n.trees": 4})


def _df():
    return friedman_dataframe(generate_friedman_data(100, ranef=True))


def test_cores_on_the_cpu_runs_the_single_device_path():
    df = _df()
    one = stan4bart_torch.stan4bart(FORMULA, df, device="cpu", **KW)
    four = stan4bart_torch.stan4bart(FORMULA, df, device="cpu", cores=4,
                                     **KW)
    assert four.draws.stan.shape[0] == 4
    for name in ("stan", "bart_train", "k"):
        a, b = getattr(one.draws, name), getattr(four.draws, name)
        assert np.all(np.isfinite(b)), name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("cores", [2, 4])
def test_cores_with_several_cuda_devices_is_not_ported(monkeypatch, cores):
    """Several visible cards: one spawned NCCL rank per card (no longer a
    NotImplementedError), on min(cores, cards, chains) of them, before any
    device work of this process."""
    from stan4bart_torch.parallel import mesh

    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(mesh, "fit_on_devices",
                        lambda *a: calls.append(a) or "fit")
    assert stan4bart_torch.stan4bart(FORMULA, _df(), device="cuda",
                                     cores=cores, **KW) == "fit"
    (devices, backend, formula, _, kwargs), = calls
    assert devices == ["cuda:0", "cuda:1"] and backend.endswith("nccl")
    assert formula == FORMULA and kwargs["chains"] == 4
    assert "cores" not in kwargs and "device" not in kwargs
    # every other argument of stan4bart reaches the ranks
    params = inspect.signature(stan4bart_torch.stan4bart).parameters
    assert set(kwargs) == set(params) - {"formula", "data", "cores",
                                         "device", "_progress"}


def test_cores_with_one_cuda_device_takes_the_single_device_path(
        monkeypatch):
    # one visible card: no multi-device refusal; with no card present the
    # single-device path then stops at resolve_device
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the fit would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stan4bart_torch.stan4bart(FORMULA, _df(), device="cuda", cores=4,
                                  **KW)


@pytest.mark.parametrize("cores", [0, -1])
def test_cores_must_be_positive(cores):
    with pytest.raises(ValueError, match="'cores'"):
        stan4bart_torch.stan4bart(FORMULA, _df(), device="cpu", cores=cores,
                                  **KW)
