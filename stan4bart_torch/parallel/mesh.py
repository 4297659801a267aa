"""Chain sharding and observation sharding over processes.

Counterpart of ``stan4bart_tpu/parallel/mesh.py``.  The JAX package lays
its devices out as a mesh and runs one ``shard_map`` program over it; the
port runs one process (rank) per device in a ``torch.distributed`` world
and lays the ranks out the same way:

* ``chain_data_groups(n_chain, n_data)`` lays the first n_chain x n_data
  ranks of the world out as chain groups of n_data ranks each, the data
  axis innermost (rank = chain group x n_data + data index), as
  ``chain_data_mesh`` does: a data group's ranks are neighbours, and only
  the final gather crosses the chain axis.  Where the world's chain
  groups do not divide the chains, ``stan4bart`` shrinks their count as
  the JAX package shrinks its chain mesh, and the ranks past the layout
  sit out the run and receive the gathered draws;
* chain sharding alone is ``multihost.run_chains_multihost``, which
  serves both of the JAX package's chain drivers (``run_chains_sharded``
  and ``run_chains_batched_sharded``): each rank runs its chains through
  ``GibbsProgram.run_chains_chunked``, batched or per chain as the fit
  asks;
* ``run_chains_obs_sharded`` shards the chains over the chain groups and
  each group's observations over its ranks: every rank holds one padded
  shard of the observations (``_obs_shard_inputs``) through
  ``GibbsProgram.local_view``, and every sufficient statistic is one
  all-reduce over the data group (``DataAxis``): the per-tree
  (C, 2, M + 2) block of the sweep, the Gram anchor of the NUTS
  likelihood, the linear and level refreshes, the leaf draws and the
  leaf-scale range.  All ranks of a data group draw from their chain
  group's generator, so the tree structures, the NUTS states and every
  draw replicate across the data axis; the sampled chains equal the
  unsharded ones up to the rounding of the sums;
* ``spawn`` starts one process per device with ``torch.multiprocessing``
  (spawn start method), joins them under a timeout and raises if any rank
  raised or timed out; ``fit_on_devices`` runs ``stan4bart`` that way and
  returns rank 0's fit (``cores`` over several cards).

The obs-sharded driver refuses what the JAX package refuses: a model
without the Gram likelihood, pooled adaptation, and (in ``stan4bart``) a
callback or ``keep_fits=False``.
"""

from __future__ import annotations

import os
import queue
import socket
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from stan4bart_torch.parallel import multihost


def chain_data_groups(n_chain: int, n_data: int):
    """The 2-D layout of the first n_chain x n_data ranks of the world as
    process groups, data innermost.  Every rank must call it, in the same
    order.  Returns (data_group, chain_group, g, d): this rank's data
    group (the n_data ranks of its chain group), the group of the n_chain
    ranks that hold its data shard in every chain group (the gather
    axis), its chain group index g and its data index d; all None for a
    rank past the layout."""
    W, r = multihost.world()
    L = n_chain * n_data
    if W < L:
        raise ValueError(f"a {n_chain} x {n_data} layout needs {L} ranks, "
                         f"the world has {W}")
    data_groups = [dist.new_group(list(range(g * n_data, (g + 1) * n_data)))
                   for g in range(n_chain)]
    chain_groups = [dist.new_group(list(range(d, L, n_data)))
                    for d in range(n_data)]
    if r >= L:
        return None, None, None, None
    g, d = divmod(r, n_data)
    return data_groups[g], chain_groups[d], g, d


class DataAxis:
    """The data group's all-reduces (the JAX package's ``psum`` /
    ``pmax`` over the "data" mesh axis): ``sum(x)`` and ``max(x)`` return
    new tensors on x's device; ``calls`` counts them."""

    def __init__(self, group=None):
        self.group = group
        self.calls = 0

    def _reduce(self, x, op):
        self.calls += 1
        t = x.detach().to(multihost._comm_device(self.group, x.device),
                          copy=True).contiguous()
        dist.all_reduce(t, op=op, group=self.group)
        return t.to(x.device)

    def sum(self, x):
        return self._reduce(x, dist.ReduceOp.SUM)

    def max(self, x):
        return self._reduce(x, dist.ReduceOp.MAX)


def _obs_shard_inputs(prog, n_shards: int, bart_offset_init=None):
    """Every obs-sized member of ``prog`` padded to a multiple of
    ``n_shards`` rows, as tensors on its device (``bart_offset_init`` as
    float64 numpy).  Padding replicates row 0
    with likelihood weight 0, an exactly equivalent model (w = 1 products
    are exact, w = 0 rows add nothing to any sufficient statistic, and the
    normalizing constants keep the true N), so an unweighted model becomes
    weighted only where padding occurs.  Returns (inputs, meta): meta
    holds the padded count ``Np`` and the initial metric ``inv_mass0``
    from the global data."""
    pm, N = prog.pm, prog.N
    pad = (-N) % n_shards
    dev = prog.device

    def pad0(a):
        a = torch.as_tensor(a, device=dev)
        if pad == 0:
            return a
        return torch.cat([a, a[:1].expand((pad,) + tuple(a.shape[1:]))])

    def pad_zero(a):
        return a if pad == 0 else torch.cat(
            [a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    inputs = {"y": pad0(prog.y), "ranks": pad0(prog.ranks), "X": pad0(pm.X),
              "z_structs": [(pad0(lhs), pad0(gidx))
                            for lhs, gidx in pm.z_structs]}
    if prog.use_gram:
        inputs["gram_A"] = pad0(pm.gram_A)
        inputs["gram_AW"] = pad_zero(pm.gram_AW)
    if prog.weights is not None or pad > 0:
        w = (prog.weights if prog.weights is not None
             else torch.ones(N, dtype=prog.dtype, device=dev))
        inputs["weights"] = pad_zero(w)
    if prog.user_offset is not None:
        inputs["user_offset"] = pad0(prog.user_offset)
    if bart_offset_init is not None:
        boi = np.asarray(bart_offset_init, np.float64)
        inputs["bart_offset_init"] = np.concatenate(
            [boi, np.repeat(boi[:1], pad)])
    scale_y = (1.0 if prog.is_binary
               else float(np.std(prog.y.double().cpu().numpy(), ddof=1)))
    meta = {"Np": N + pad,
            "inv_mass0": np.asarray(pm.initial_inv_mass(scale_y, N))}
    return inputs, meta


def _shard(inputs: dict, n_shards: int, d: int) -> dict:
    """Shard ``d`` of ``n_shards`` of every padded input (rows
    [d Np / n, (d + 1) Np / n)); the cut ranks as numpy."""
    from stan4bart_torch.gibbs import tree_map

    n = inputs["y"].shape[0] // n_shards
    local = tree_map(lambda a: (a[d * n: (d + 1) * n].contiguous()
                                if torch.is_tensor(a)
                                else a[d * n: (d + 1) * n]), inputs)
    local["ranks"] = local["ranks"].cpu().numpy()
    return local


def run_chains_obs_sharded(prog, seed: int, chains: int, n_chain: int,
                           n_data: int, chunk_size: int | None = None,
                           bart_offset_init=None, sigma_init: float = 1.0,
                           keep_warmup: bool = True, verbose: int = 0,
                           refresh: int | None = None, progress=None):
    """The whole fit (warmup, adaptation disengage, sampling, chunked) on
    the chains x data layout of the world's first n_chain x n_data ranks:
    chain group g runs chains [g C / n_chain, (g + 1) C / n_chain) with
    the generator of ``rank_seed(seed, g, n_chain)``, each of its n_data
    ranks on one padded shard of the observations (``prog.local_view``).
    The draws' per-observation fits are gathered over the data group with
    the pad rows sliced off, then every draw over the chain axis, and
    where the world has ranks past the layout, rank 0 broadcasts the
    draws and its info to them; so every rank returns the full draws.
    Returns (None, draws, info): the final states stay on their ranks;
    info is the rank's ``run_chains_chunked`` info (rank 0's on a rank
    past the layout) with the layout, the data group's all-reduce count
    and the gather seconds."""
    if chains % n_chain != 0:
        raise ValueError(
            f"chains ({chains}) must be a multiple of the chain-mesh "
            f"size ({n_chain})")
    data_group, chain_group, g, d = chain_data_groups(n_chain, n_data)
    W, r = multihost.world()
    if g is None:
        # past the layout: the run's draws and info from rank 0
        draws, info = _from_rank0(None)
        info.update(rank=r, chain_group=None, data_index=None,
                    all_reduces=0)
        return None, draws, info
    inputs, meta = _obs_shard_inputs(prog, n_data, bart_offset_init)
    local = _shard(inputs, n_data, d)
    axis = DataAxis(data_group)
    lprog = prog.local_view(local, axis, meta["inv_mass0"], meta["Np"],
                            d * local["y"].shape[0])
    gen = torch.Generator(device=prog.device)
    gen.manual_seed(multihost.rank_seed(seed, g, n_chain))
    lead = g == 0 and d == 0
    t0 = time.perf_counter()
    _, draws, info = lprog.run_chains_chunked(
        gen, chains // n_chain, chunk_size,
        bart_offset_init=local.get("bart_offset_init"),
        sigma_init=sigma_init, keep_warmup=keep_warmup,
        verbose=verbose if lead else 0, refresh=refresh,
        progress=progress if lead else None)
    t1 = time.perf_counter()
    draws = draws._replace(bart_train=multihost.gather(
        draws.bart_train, data_group, axis=-1)[..., :prog.N])
    draws = multihost.gather(draws, chain_group)
    info.update(world_size=W, rank=r, chain_groups=n_chain,
                obs_shards=n_data, chain_group=g, data_index=d,
                backend=str(dist.get_backend()), run_s=t1 - t0,
                gather_s=time.perf_counter() - t1,
                all_reduces=axis.calls, rng_state=gen.get_state())
    if W > n_chain * n_data:
        _from_rank0((draws, info) if r == 0 else None)
    return None, draws, info


def _from_rank0(obj):
    """``obj`` of rank 0, broadcast to every rank of the world (pickled,
    over the host-tensor backend)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, device=torch.device("cpu"))
    return box[0]


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, device, fn, args, out_q,
               timeout_s):
    """One spawned rank: join the world, run ``fn(rank, world, device,
    *args)``, send (rank, ok, result or traceback) to the parent."""
    ok, payload = True, None
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            if dev.index is not None:
                torch.cuda.set_device(dev)
            # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        else:
            torch.set_num_threads(1)
        multihost.initialize(backend, f"tcp://localhost:{port}", world,
                             rank, timeout_s)
        payload = fn(rank, world, device, *args)
    except Exception:   # reported to the parent, which stops every rank
        ok, payload = False, traceback.format_exc()
    out_q.put((rank, ok, payload))
    if dist.is_initialized() and ok:
        dist.destroy_process_group()
    # a rank that raised exits at once: its peers may be blocked in a
    # collective it will never join
    out_q.close()
    out_q.join_thread()
    os._exit(0 if ok else 1)


def spawn(fn, devices, backend: str | None = None, args=(),
          timeout_s: float = 600.0):
    """Run ``fn(rank, world_size, device, *args)`` in one new process per
    entry of ``devices`` (e.g. ``["cuda:0", "cuda:1"]`` or ``["cpu",
    "cpu"]``), joined as one ``torch.distributed`` world over
    ``tcp://localhost`` with ``backend`` (None: NCCL with gloo for host
    tensors on cards, gloo on the CPU).  ``fn`` must be importable by
    name (the spawn start method) and return something picklable.

    Returns the ranks' results in rank order.  Raises RuntimeError with
    the rank's traceback as soon as a rank raises, and TimeoutError when
    not every rank has finished within ``timeout_s`` (which also bounds
    each collective); either way every rank is stopped first, so no rank
    runs on alone."""
    ctx = torch.multiprocessing.get_context("spawn")
    world = len(devices)
    out_q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, backend, str(dev), fn,
                               tuple(args), out_q, timeout_s),
                         daemon=True)
             for r, dev in enumerate(devices)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout_s

    def stop():
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(5)

    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn: {world - len(results)} of {world} ranks did "
                    f"not finish within {timeout_s} s")
            try:
                rank, ok, payload = out_q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"spawn: rank {dead[0]} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} raised:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        stop()
    return [results[r] for r in range(world)]


def _fit_rank(rank, world, device, formula, data, kwargs, path):
    """One rank of ``fit_on_devices``: the fit in the world; rank 0 writes
    it to ``path``."""
    from stan4bart_torch.fit import stan4bart

    fit = stan4bart(formula, data, device=device, **kwargs)
    if rank == 0:
        fit.save(path)
    return fit.timings


def fit_on_devices(devices, backend, formula, data, kwargs: dict):
    """``stan4bart(formula, data, **kwargs)`` with its chains sharded over
    one spawned rank per entry of ``devices``; returns rank 0's fit (every
    rank holds the same gathered draws), loaded on ``devices[0]``."""
    from stan4bart_torch.results import Stan4bartFit

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.pkl")
        spawn(_fit_rank, devices, backend,
              args=(formula, data, dict(kwargs), path))
        return Stan4bartFit.load(path, device=devices[0])
