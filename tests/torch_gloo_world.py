"""Helpers for the port's multi-rank tests: a gloo world of W processes
and the JAX package's SPMD twin on W CPU devices.

``start_world(fn, W, *args, env=None, local_size=None)`` spawns W processes
(``torch.multiprocessing``, ``spawn``) that rendezvous through the JAX
launcher's variables, set the variables of ``env`` (a dict), number
ranks into nodes of ``local_size`` (default: one node of W), call
``basics.init("cpu")``, run ``fn(rank, W, *args)`` (a module-level function,
so that it pickles by reference) and write its result; the returned
``join()`` waits and gives the results in rank order, so the caller can run
the JAX side meanwhile.  ``jax_spmd(fn, W, *stacked)`` runs ``fn`` under
``shard_map`` over ``Mesh(jax.devices()[:W], ("hvd",))``, each argument
and output with a leading rank axis: row r is rank r.
"""

from __future__ import annotations

import os
import pickle
import socket
import tempfile
import time

import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, port, out_dir, args, env, local_size):
    os.environ.update(env or {})
    local = world if local_size is None else local_size
    os.environ.update(
        HOROVOD_TPU_PROCESS_ID=str(rank), HOROVOD_TPU_NUM_PROCESSES=str(world),
        HOROVOD_TPU_COORDINATOR=f"127.0.0.1:{port}",
        HOROVOD_TPU_LOCAL_RANK=str(rank % local),
        HOROVOD_TPU_LOCAL_SIZE=str(local))
    from horovod_tpu_torch import basics

    basics.init("cpu")
    try:
        result = fn(rank, world, *args)
    finally:
        basics.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def start_world(fn, world: int, *args, env=None, local_size=None):
    out_dir = tempfile.mkdtemp(prefix=f"gloo{world}_")
    ctx = mp.start_processes(_entry, args=(fn, world, free_port(), out_dir,
                                           args, env, local_size),
                             nprocs=world, join=False, start_method="spawn")

    def join(timeout: float | None = None) -> list:
        """Every rank's result; with ``timeout`` (seconds), a world still
        running then is killed and ``TimeoutError`` raised."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(None if deadline is None
                           else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"gloo world of {world} still running "
                                   f"after {timeout} s")
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results

    return join


def jax_spmd(fn, world: int, *stacked):
    """``fn(*per_rank_args)`` on each of ``world`` mesh devices; every
    argument and output leaf carries a leading rank axis."""
    import jax
    import numpy as np
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:world]), ("hvd",))

    def body(*xs):
        xs = jax.tree.map(lambda x: x[0], xs)
        return jax.tree.map(lambda y: y[None], fn(*xs))

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("hvd"),
                              out_specs=P("hvd"), check_vma=False))
    return jax.tree.map(np.asarray, f(*stacked))
