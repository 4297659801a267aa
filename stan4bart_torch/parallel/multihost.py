"""Multi-process chain execution on ``torch.distributed``.

Counterpart of ``stan4bart_tpu/parallel/multihost.py``.  Every process
(rank) of an initialized world runs the same ``stan4bart`` call; each
takes a contiguous block of the chains, runs it on its own device with
its own generator, and the draws are all-gathered to full numpy arrays
on every rank at the end.  There is no communication between chains
while they run, except the pooled adaptation of ``stan_args
pooled_adaptation``, which pools over every chain of every rank by one
all-reduce where the JAX package takes a global ``pmean``.

* ``initialize`` wraps ``torch.distributed.init_process_group``: the
  ``env://`` rendezvous that ``torchrun`` sets by default, NCCL between
  cards (with gloo beside it for host tensors) and gloo on the CPU;
* ``rank_seed`` is the seed of a chain group's generator.  The JAX
  package keys each chain, so its sharded draws equal its unsharded ones;
  the port has one generator per program, so each chain group draws from
  its own, ``numpy.random.SeedSequence(seed).spawn(n_groups)[group]``:
  a rank's chains are those of a single-process fit of its chain count
  with that seed;
* ``gather`` all-gathers numpy arrays (or a tree of them) along an axis;
* ``run_chains_multihost`` runs a program's chains sharded over the
  world (``stan4bart`` calls it inside a world of size > 1);
* ``sharded_diagnostics`` gives split-R-hat and ESS of the gathered
  draws, as ``parallel/diagnostics.py`` computes them.
"""

from __future__ import annotations

import datetime
import time

import numpy as np
import torch
import torch.distributed as dist


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               timeout_s: float = 600.0):
    """Join the process group of this run; a no-op when already joined.

    backend: None picks NCCL for CUDA tensors with gloo for host tensors
    when a card is visible, else gloo; any ``torch.distributed`` backend
    string is passed on.  init_method: default ``env://`` (``torchrun``'s
    MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK); ``tcp://host:port``
    with ``world_size`` and ``rank`` for a hand-made cluster.
    timeout_s bounds every collective: a rank that stops makes the others
    raise after it, never run on alone."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = ("cpu:gloo,cuda:nccl" if torch.cuda.is_available()
                   else "gloo")
    kw = {}
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://",
        timeout=datetime.timedelta(seconds=float(timeout_s)), **kw)


def world() -> tuple[int, int]:
    """(world size, rank) of this process; (1, 0) outside a world."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def rank_seed(seed: int, group: int, n_groups: int) -> int:
    """The generator seed of chain group ``group`` of ``n_groups``."""
    child = np.random.SeedSequence(int(seed)).spawn(int(n_groups))[group]
    return int(child.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def _comm_device(group, device) -> torch.device:
    """Where a collective of ``group`` takes a tensor that lies on
    ``device``: where it lies (NCCL takes card tensors, gloo both), but
    on this rank's card for a host tensor when the backend has no gloo."""
    device = torch.device(device)
    if device.type == "cpu" and "gloo" not in str(dist.get_backend(group)):
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _gather_array(a, group, axis: int):
    a = np.ascontiguousarray(a)
    t = torch.from_numpy(a).to(_comm_device(group, "cpu"))
    n = dist.get_world_size(group)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return np.concatenate([p.cpu().numpy() for p in parts], axis=axis)


def gather(tree, group=None, axis: int = 0):
    """All-gather a tree (dict / tuple / NamedTuple) of numpy arrays along
    ``axis`` over ``group`` (default: the world), in rank order; every
    rank's arrays must have one shape.  None leaves stay None."""
    from stan4bart_torch.gibbs import tree_map

    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return tree_map(np.asarray, tree)
    return tree_map(lambda a: _gather_array(a, group, axis), tree)


class ChainPool:
    """Pooled adaptation over every chain of every rank: ``mean(x)``
    takes the mean over the chains of x (C, ...) -> (1, ...) by one
    all-reduce of the local sums."""

    def __init__(self, n_chains: int):
        self.n_chains = int(n_chains)

    def mean(self, x):
        s = x.sum(0, keepdim=True)
        t = s.to(_comm_device(None, s.device), copy=True)
        dist.all_reduce(t)
        return t.to(s.device) / self.n_chains


def run_chains_multihost(prog, seed: int, chains: int,
                         chunk_size: int | None = None,
                         bart_offset_init=None, sigma_init: float = 1.0,
                         keep_warmup: bool = True, callback=None,
                         verbose: int = 0, refresh: int | None = None,
                         progress=None):
    """Run ``chains`` chains of ``prog`` sharded over the world: rank r
    runs chains [r C / W, (r + 1) C / W) with the generator of
    ``rank_seed(seed, r, W)`` through ``prog.run_chains_chunked``, and the
    draws (or the callback's outputs) are gathered to every rank.  With
    ``prog.nuts_cfg.pooled`` the adaptation pools over every chain of
    every rank.  Returns (None, draws, info): the final states stay on
    their ranks and are not returned; info is the rank's
    ``run_chains_chunked`` info with the layout."""
    W, r = world()
    if chains % W != 0:
        raise ValueError(
            f"chains ({chains}) must be a multiple of the global device "
            f"count ({W})")
    gen = torch.Generator(device=prog.device)
    gen.manual_seed(rank_seed(seed, r, W))
    if prog.nuts_cfg.pooled:
        prog.chain_pool = ChainPool(chains)
    t0 = time.perf_counter()
    states, draws, info = prog.run_chains_chunked(
        gen, chains // W, chunk_size, bart_offset_init=bart_offset_init,
        sigma_init=sigma_init, keep_warmup=keep_warmup, callback=callback,
        verbose=verbose if r == 0 else 0, refresh=refresh,
        progress=progress if r == 0 else None)
    t1 = time.perf_counter()
    draws = gather(draws)
    info.update(world_size=W, rank=r, chain_groups=W, obs_shards=1,
                backend=str(dist.get_backend()), run_s=t1 - t0,
                gather_s=time.perf_counter() - t1,
                rng_state=gen.get_state())
    return None, draws, info


def sharded_diagnostics(draws_stan, param_idx, group=None):
    """Split-R-hat and ESS of the columns ``param_idx`` of the (chains,
    iterations, P) draws, after gathering each rank's block of chains
    over ``group`` (pass the gathered draws with no world, or the rank's
    own block inside one).  Returns dict(rhat=(k,), ess=(k,)), equal to
    ``parallel/diagnostics.split_rhat`` / ``ess`` of the gathered draws."""
    from stan4bart_torch.parallel.diagnostics import ess, split_rhat

    sel = np.asarray(draws_stan)[..., list(param_idx)]
    sel = gather(sel, group)
    return {"rhat": np.asarray(split_rhat(sel)),
            "ess": np.asarray([ess(sel[..., j])
                               for j in range(sel.shape[-1])])}
