"""Wall time of a quality fit alone on the card and with copies of it
side by side, each in a process of its own.

Each run fits ``quality.gaussian_case(variant)`` at a cut budget;
``--procs P`` starts P such processes at once.  Every run prints its
wall, its fit seconds, the lock-step leapfrogs of its sampling draws
(the sum over iterations of the most any chain took) and a digest of its
draws, which agree across runs (the fits are deterministic on the card).
P runs that take about as long as one share nothing; P runs that take P
times as long share one resource whole.

Usage: python -m stan4bart_torch.utils.side_by_side [--variant weighted]
[--iter 80] [--warmup 40] [--procs 1,1,4] [--out FILE.json]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing as mp
import time

import numpy as np

from stan4bart_torch.utils.device import card


def digest(fit) -> str:
    h = hashlib.sha256()
    for name in ("stan", "bart_train", "k"):
        h.update(np.ascontiguousarray(getattr(fit.draws, name)).tobytes())
    return h.hexdigest()[:16]


def one_fit(variant, iters, warmup, device="cuda") -> dict:
    """One fit of ``variant`` at ``iters`` iterations, ``warmup`` of them
    warmup: its wall, fit seconds, lock-step leapfrogs and digest."""
    import stan4bart_torch
    from stan4bart_torch.utils import quality

    _, formula, df, kw = quality.gaussian_case(variant)
    kw.update(iter=iters, warmup=warmup)
    t0 = time.perf_counter()
    fit = stan4bart_torch.stan4bart(formula, df, device=device, **kw)
    wall = time.perf_counter() - t0
    cols = {n: i for i, n in enumerate(fit.prog.stan_names())}
    leap = np.asarray(fit.draws.stan)[:, :, cols["n_leapfrog__"]]
    return {"wall_s": wall,
            "fit_s": {k: round(float(v), 2) for k, v in fit.timings.items()},
            "leapfrogs_lockstep": int(leap.max(0).sum()),
            "digest": digest(fit)}


def _child(out_q, args):
    out_q.put(one_fit(*args))


def side_by_side(procs, variant, iters, warmup) -> list[dict]:
    """``procs`` processes, each one ``one_fit``, started together."""
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    kids = [ctx.Process(target=_child, args=(out_q, (variant, iters, warmup)))
            for _ in range(procs)]
    for k in kids:
        k.start()
    recs = [out_q.get() for _ in kids]
    for k in kids:
        k.join()
    return recs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="weighted")
    ap.add_argument("--iter", type=int, default=80)
    ap.add_argument("--warmup", type=int, default=40)
    ap.add_argument("--procs", default="1,1,4")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from stan4bart_torch.ops import cuda_build

    cuda_build.build(["bart_sweep_batch"])
    rows = []
    for procs in map(int, args.procs.split(",")):
        t0 = time.perf_counter()
        recs = side_by_side(procs, args.variant, args.iter, args.warmup)
        row = {"procs": procs, "group_wall_s": time.perf_counter() - t0,
               "runs": recs}
        rows.append(row)
        print(json.dumps(row), flush=True)
    digests = {r["digest"] for row in rows for r in row["runs"]}
    out = {"variant": args.variant, "iter": args.iter,
           "warmup": args.warmup, "card": card(), "rows": rows,
           "draws_equal": len(digests) == 1}
    print(json.dumps({k: out[k] for k in ("card", "draws_equal")}),
          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if len(digests) != 1:
        raise SystemExit(f"the runs' draws differ: {sorted(digests)}")


if __name__ == "__main__":
    main()
