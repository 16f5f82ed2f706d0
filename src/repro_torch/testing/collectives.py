"""Jobs for the ranks of a local world (``testing.world.World.run``) that
record the collectives one rank runs (``launch.cost_analysis
.record_collectives``), for the tests that hold the dry run's analytic
counts to them.  Each returns ``CollectiveStats.as_dict()`` of its rank.

    with World(4) as w:
        outs = w.run("repro_torch.testing.collectives:train_step", cfg,
                     MeshSpec((2, 2), ("data", "model")), batch=8, seq=16)
"""
from __future__ import annotations

import torch

__all__ = ["train_step", "pald_body", "psum"]


def train_step(cfg, mesh, *, batch: int, seq: int, microbatches: int = 1,
               seed: int = 0, counted: bool = False) -> dict:
    """One sharded train step (``train_step.make_train_step(mesh=...)``)
    on the rank's rows of SyntheticTokens' first batch, recorded;
    ``counted``: run under ``cost_analysis.count`` too, its flops added
    as "flops"."""
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.launch.cost_analysis import count, record_collectives
    from repro_torch.sharding import partition
    from repro_torch.train import train_step as ts

    dev = torch.device("cpu")
    spec = partition.batch_pspec(mesh, batch)
    state = ts.init_state(cfg, seed, dev, mesh=mesh)
    data = SyntheticTokens(cfg.vocab_size, seq, batch, seed=seed,
                           device=dev, mesh=mesh, batch_spec=spec)
    step = ts.make_train_step(cfg, microbatches=microbatches, mesh=mesh,
                              batch_spec=spec)
    rows = data.batch_at(0)
    with record_collectives() as stats:
        if counted:
            flops = count(step, state, rows).flops
        else:
            step(state, rows)
    out = stats.as_dict()
    if counted:
        out["flops"] = flops
    return out


def pald_body(mesh, *, n: int, strategy: str, seed: int = 0) -> dict:
    """One dense shard body of ``core/distributed.py`` ("allgather",
    "ring", "2d", "2d+stream": the pod stream over the mesh's ``pod``
    dimension) on the rank's block of a random (n, n) D, recorded."""
    import numpy as np

    from repro_torch.core import distributed as D
    from repro_torch.core import engine
    from repro_torch.launch.cost_analysis import record_collectives

    Dg = torch.as_tensor(np.random.default_rng(seed).random((n, n)),
                         dtype=torch.float32)
    names = D._names(mesh)
    row_axes, col = names[:-1], names[-1]
    if strategy in ("allgather", "ring"):
        spec = D.P(names, None)
        p = D._axis_size(mesh, names)
        plan = engine.plan_local(n // p, device="cpu")
        if strategy == "allgather":
            body = lambda x: D._allgather_body(  # noqa: E731
                x, mesh=mesh, axis=names, n_valid=None, plan=plan)
        else:
            body = lambda x: D._ring_body(  # noqa: E731
                x, mesh=mesh, axis=names, p=p, n_valid=None, plan=plan)
    else:
        spec = D.P(row_axes, col)
        plan = engine.plan_local(n // D._axis_size(mesh, row_axes),
                                 device="cpu")
        stream = "pod" if strategy == "2d+stream" else None
        body = lambda x: D._2d_body(  # noqa: E731
            x, mesh=mesh, row_axes=row_axes, col_axis=col,
            stream_axis=stream, n_valid=None, plan=plan)
    local = D._local_block(Dg, mesh, spec)
    with record_collectives() as stats:
        body(local)
    return stats.as_dict()


def psum(mesh, *, rows: int, cols: int) -> dict:
    """The column sums of a (rows, cols) float32 array sharded by rows
    over every mesh dimension: each rank sums its rows, then one
    ``jax.lax.psum`` (``distributed._all_reduce``) of the (cols,)
    partial sums, recorded; with the sums under "sums"."""
    from repro_torch.core import distributed as D
    from repro_torch.launch.cost_analysis import record_collectives

    names = D._names(mesh)
    x = torch.arange(rows * cols, dtype=torch.float32).reshape(rows, cols)
    local = D._local_block(x, mesh, D.P(names, None))
    with record_collectives() as stats:
        sums = D._all_reduce(local.sum(0), mesh, names)
    return dict(stats.as_dict(), sums=sums)
