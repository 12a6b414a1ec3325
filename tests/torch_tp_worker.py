"""The ranks of ``tests/test_torch_serving_tp.py``'s gloo worlds.

Each function runs on every rank of a world (``torch_gloo_world.start_world``)
and builds the port's tensor-parallel engines from the JAX weights (an
``.npz`` file of numpy leaves, read by :func:`load_params` and carried in
by ``params_from_jax``): rank 0 leads and records what the test compares,
the others follow.  The weights go by file because a spawned process's
arguments are written to its pipe before the next process starts, so
large arguments serialise the world's start-up.  This module imports
torch and the port only, so a spawned rank starts without JAX.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.device_telemetry import DeviceTelemetry
from horovod_tpu_torch.models import llama
from horovod_tpu_torch.models.convert import params_from_jax
from horovod_tpu_torch.parallel.mesh import make_mesh, tensor_parallel_mesh
from horovod_tpu_torch.router import LocalReplica
from horovod_tpu_torch.serving import Request
from horovod_tpu_torch.serving_scheduler import (ServeEngine,
                                                 measure_tp_throughput)
from horovod_tpu_torch.supervisor import clone_engine

# prefix cache x speculation, the parity grid
COMBOS = ((False, False), (False, True), (True, False), (True, True))


def config():
    # n_kv_heads=4 (llama_tiny has 2) so the KV-head axis splits at tp=4
    return llama.llama_tiny(dtype=torch.float32, n_kv_heads=4)


def requests():
    # a shared 9-token stem (2+ cache blocks at block_size=4) and short
    # tails: prefix-cache hits and drafter-friendly
    stem = list(range(2, 11))
    return [Request(prompt=stem + [40 + i], max_new_tokens=5)
            for i in range(3)]


def preempt_requests():
    return [Request(prompt=[5, 17, 42], max_new_tokens=13),
            Request(prompt=[7, 8], max_new_tokens=6)]


def save_params(path: str, tree: dict) -> None:
    """A nested dict of numpy leaves as one ``.npz`` (keys ``a/b``)."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk(tree, "")
    np.savez(path, **flat)


def load_params(path: str) -> dict:
    """The port's parameters, on the CPU, from :func:`save_params`."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return params_from_jax(tree, device="cpu")


def _tokens(results) -> list[list[int]]:
    return [[int(t) for t in r] for r in results]


def _stepwise(eng, reqs) -> tuple[list, list]:
    """Serve ``reqs`` a step at a time: the results and, after each step,
    the last logits of every slot still decoding."""
    ids = [eng.submit(r) for r in reqs]
    logits = []
    while eng.pending():
        eng.step()
        rows = [i for i, s in enumerate(eng._slots) if s.state == "decode"]
        logits.append({i: eng.last_logits[i].clone().numpy() for i in rows})
    return [eng.results[i] for i in ids], logits


def _serve(eng, fn):
    """``fn(eng)`` on the leader, then close; ``follow()`` elsewhere."""
    if not eng.is_leader:
        eng.follow()
        return None
    try:
        return fn(eng)
    finally:
        eng.close()


def _parity(params, cfg, tp: int, combos=COMBOS) -> dict:
    out = {}
    for pc, sp in combos:
        eng = ServeEngine(params, cfg, n_slots=2, max_len=32, chunk=4,
                          tp_size=tp, prefix_cache=pc, spec=sp, draft_k=3,
                          metrics=tmetrics.NULL, sampler=False)

        def run(e):
            res, logits = _stepwise(e, requests())
            assert all(r.ok for r in res), [r.status for r in res]
            return {"tokens": _tokens(res), "logits": logits,
                    "sizes": e.compile_cache_sizes()}

        res = _serve(eng, run)
        out[(pc, sp)] = (res if res is not None
                         else {"sizes": eng.compile_cache_sizes()})
    return out


def _gauges_and_clone(params, cfg) -> dict | None:
    reg = tmetrics.MetricsRegistry(event_log=None)
    eng = ServeEngine(params, cfg, n_slots=2, max_len=32, chunk=4,
                      tp_size=2, prefix_cache=True, metrics=reg,
                      sampler=False)

    def run(e):
        for _ in range(2):
            res = e.run(requests())
            assert all(r.ok for r in res)
        snap = e.metrics_snapshot()
        clone = clone_engine(e)
        try:
            got = clone.run([requests()[0]])[0]
            clone_out = {"tp_size": clone.tp_size, "tokens": _tokens([got]),
                         "status": got.status,
                         "shares_weights": clone.params is e.params}
        finally:
            clone.close()
        return {"sizes": e.compile_cache_sizes(),
                "retrace": snap["counters"].get("serve.retrace", 0),
                "gauges": snap["gauges"], "kv": snap["memory"]["kv"],
                "n_blocks": int(e.pcache.k.shape[1]),
                "pool_heads": int(e.pcache.k.shape[3]),
                "clone": clone_out}

    return _serve(eng, run)


def _preempt(params, cfg) -> dict | None:
    eng = ServeEngine(params, cfg, n_slots=2, max_len=16, chunk=4,
                      block_size=4, n_blocks=6, preempt_after=2, tp_size=2,
                      metrics=tmetrics.NULL, sampler=False)

    def run(e):
        res = e.run(preempt_requests())
        return {"tokens": _tokens(res), "statuses": [r.status for r in res],
                "preemptions": e.counters["preemptions"],
                "sizes": e.compile_cache_sizes(),
                "free_blocks": e.free_block_count()}

    return _serve(eng, run)


def _local_replica(params, cfg) -> dict | None:
    eng = ServeEngine(params, cfg, n_slots=2, max_len=32, chunk=4,
                      tp_size=2, metrics=tmetrics.NULL, sampler=False)

    def run(e):
        rep = LocalReplica(e, name="tp2")
        try:
            done = threading.Event()
            box = {}
            rep.submit(requests()[0],
                       lambda res: (box.update(res=res), done.set()))
            assert done.wait(timeout=60), "sharded replica never answered"
            res = box["res"]
            return {"ok": res is not None and res.ok,
                    "tokens": _tokens([res]), "probe": rep.probe()}
        finally:
            rep.stop()

    return _serve(eng, run)


def _device_plane(params, cfg, n: int) -> dict:
    """The device plane of a tp=n engine against a tp=1 engine's."""
    planes = {}
    for tp in (1, n):
        if tp == 1 and dist.get_rank() != 0:
            continue
        dev = DeviceTelemetry(tmetrics.MetricsRegistry(event_log=None),
                              n_devices=tp, peak_flops=1e12)
        eng = ServeEngine(params, cfg, n_slots=2, max_len=32, chunk=4,
                          tp_size=tp, spec=True, draft_k=3,
                          metrics=tmetrics.NULL, sampler=False,
                          device_telemetry=dev)

        def run(e, dev=dev):
            e.run(requests())
            rep = dev.report()
            return {"n_devices": rep["n_devices"],
                    "peak_flops": rep["peak_flops"],
                    "flops": {k: v["flops"]
                              for k, v in rep["programs"].items()},
                    "param_bytes": dev.param_bytes,
                    "kv_total_bytes": dev.kv_total_bytes,
                    "sizes": e.compile_cache_sizes()}

        planes[tp] = _serve(eng, run)
    return planes


def _meshes() -> dict:
    tpm = tensor_parallel_mesh(2)
    full = make_mesh(dp=1, tp=2)
    return {"tp": (tpm.axis_names, tpm.ranks.shape, tpm.coordinate("tp"),
                   dist.get_world_size(tpm.group("tp")),
                   dist.get_world_size(tpm.host_group("tp"))),
            "cached": tensor_parallel_mesh(2) is tpm,
            "full": (full.axis_names, full.shape, full.coordinate("tp"),
                     full.coordinate("dp"),
                     dist.get_world_size(full.group("tp")),
                     dist.get_world_size(full.group("dp")))}


def tp2_world(rank: int, world: int, params_path: str) -> dict:
    """A world of two, with ``HVD_TORCH_TP=2`` set (the env path)."""
    torch.set_num_threads(1)     # tiny programs; threads only contend
    cfg = config()
    params = load_params(params_path)
    out = {"meshes": _meshes()}
    out["parity"] = _parity(params, cfg, 2)
    if rank == 0:
        eng = ServeEngine(params, cfg, n_slots=2, max_len=32, chunk=4,
                          tp_size=1, prefix_cache=True, spec=True,
                          draft_k=3, metrics=tmetrics.NULL, sampler=False)
        out["tp1"] = _tokens(eng.run(requests()))
    out["gauges"] = _gauges_and_clone(params, cfg)
    out["preempt"] = _preempt(params, cfg)
    out["replica"] = _local_replica(params, cfg)
    out["measure"] = measure_tp_throughput(
        params, cfg, requests(), n_slots=2, max_len=32, chunk=4,
        tp_sizes=(1, 2, 16))
    # the env knob: tp_size unset reads HVD_TORCH_TP=2, from a shard
    shard = llama.shard_params(params, llama.param_partition_specs(cfg),
                               rank, 2)
    env_eng = ServeEngine(shard, cfg, n_slots=2, max_len=32, chunk=4,
                          prefix_cache=True, spec=True, draft_k=3,
                          metrics=tmetrics.NULL, sampler=False)
    refused = None
    if not env_eng.is_leader:
        try:
            env_eng.submit(requests()[0])
        except RuntimeError as e:
            refused = str(e)
    out["env"] = {"tp_size": env_eng.tp_size,
                  "same_shard": env_eng.params is shard,
                  "follower_refuses_submit": refused,
                  "run": _serve(env_eng, lambda e: {
                      "tokens": _tokens(e.run(requests())),
                      "sizes": e.compile_cache_sizes()})}
    return out


def tp4_world(rank: int, world: int, params_path: str) -> dict:
    """A world of four: one tp=4 engine through the parity stream."""
    torch.set_num_threads(1)
    cfg = config()
    params = load_params(params_path)
    res = _parity(params, cfg, 4, combos=((True, True), (False, False)))
    return {"parity": res, "device": _device_plane(params, cfg, 4)}
