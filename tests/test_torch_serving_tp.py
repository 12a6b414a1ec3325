"""Port parity: tensor-parallel serving (``ServeEngine(tp_size > 1)``).

Mirrors tests/test_serving_tp.py.  The JAX engine shards over a ``('tp',)``
mesh of the conftest's faked CPU devices, one controller driving both
shards; the port runs one process per rank, so its tp = 2 and tp = 4
engines run in gloo worlds of two and four processes
(``tests/torch_tp_worker.py``): rank 0 leads, the others follow its
commands.  Both load the same weights (``llama_tiny`` in f32 with four KV
heads, ``PRNGKey(11)``), and the oracles are:

* tokens equal across the JAX tp = 2 engine, the port's tp = 2 and tp = 4
  engines (prefix cache on/off × speculation on/off, and through a
  preempt-replay), the port's tp = 1 engine and the port's solo
  ``generate``;
* the leader's logits after every step, for every decoding row, within
  1e-5 of the JAX tp = 2 engine's (f32);
* one argument signature a program, ``kv.shard_*`` × ``tp.size`` =
  ``kv.*``, ``clone_engine`` serving solo-exact tokens, ``LocalReplica``'s
  probe reporting ``tp_size`` 2, ``measure_tp_throughput``'s keys and
  skips, and the ``HVD_TORCH_TP`` knob.

One world runs each group of scenarios (two worlds for the file), started
together while the JAX side runs.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_tp_worker as worker
from horovod_tpu import metrics as jmetrics
from horovod_tpu.models import llama as jl
from horovod_tpu.serving import Request as JRequest
from horovod_tpu.serving_scheduler import ServeEngine as JaxEngine
from horovod_tpu_torch import metrics as tmetrics
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.parallel.mesh import (data_parallel_mesh, make_mesh,
                                             tensor_parallel_mesh)
from horovod_tpu_torch.serving_scheduler import ServeEngine
from torch_gloo_world import start_world

ROOT = Path(__file__).resolve().parent.parent
LOGITS_ATOL = 1e-5
PROGRAMS = {"tick": 1, "chunk": 1, "set_row": 1}
SPEC_PROGRAMS = {"tick": 0, "chunk": 1, "set_row": 1, "spec_tick": 1}


def _jax_stepwise(eng, reqs):
    """The JAX twin of ``worker._stepwise``."""
    ids = [eng.submit(JRequest(prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens))
           for r in reqs]
    logits = []
    while eng.pending():
        eng.step()
        rows = [i for i, s in enumerate(eng._slots) if s.state == "decode"]
        host = np.asarray(eng.last_logits)
        logits.append({i: host[i] for i in rows})
    return [[int(t) for t in eng.results[i]] for i in ids], logits


@pytest.fixture(scope="module")
def example():
    """``llama_serving --tp 2`` on the CPU, started at once so that its two
    ranks start up beside the worlds'."""
    return subprocess.Popen(
        [sys.executable, "-m", "horovod_tpu_torch.examples.llama_serving",
         "--requests", "3", "--slots", "2", "--new-tokens", "4",
         "--tp", "2", "--device", "cpu"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def world(tmp_path_factory, example):
    jcfg = jl.llama_tiny(dtype=jnp.float32, n_kv_heads=4)
    jp = jl.init_params(jcfg, jax.random.PRNGKey(11))
    path = str(tmp_path_factory.mktemp("tp") / "params.npz")
    worker.save_params(path, jax.tree_util.tree_map(np.asarray, jp))
    joins = {2: start_world(worker.tp2_world, 2, path,
                            env={"HVD_TORCH_TP": "2"}),
             4: start_world(worker.tp4_world, 4, path)}
    tcfg = worker.config()
    tp = worker.load_params(path)
    jax_runs = {}
    for pc, sp in ((False, False), (True, True)):
        eng = JaxEngine(jp, jcfg, n_slots=2, max_len=32, chunk=4,
                        tp_size=2, prefix_cache=pc, spec=sp, draft_k=3,
                        metrics=jmetrics.NULL, monitor=False, sampler=False)
        jax_runs[(pc, sp)] = _jax_stepwise(eng, worker.requests())

    def solo(prompt, n_new, max_len=32):
        return tl.generate(tp, torch.tensor([prompt]), tcfg,
                           max_new_tokens=n_new,
                           max_len=max_len)[0].tolist()

    results = {n: join(timeout=150) for n, join in joins.items()}
    return {"cfg": tcfg, "params": tp, "jax": jax_runs, "solo": solo,
            "tp2": results[2], "tp4": results[4]}


def _solo_tokens(world, reqs, max_len=32):
    return [world["solo"](r.prompt, r.max_new_tokens, max_len) for r in reqs]


# -- mesh construction error paths (no process group needed) ---------------


def test_make_mesh_rank_count_error():
    with pytest.raises(ValueError) as e:
        make_mesh(dp=3, ranks=range(8))     # 8 ranks, the axes need 3
    assert "need 3 ranks" in str(e.value) and "have 8" in str(e.value)


def test_make_mesh_axis_size_error():
    with pytest.raises(ValueError) as e:
        make_mesh(dp=0)
    assert "'dp' must be >= 1" in str(e.value)


def test_data_parallel_mesh_empty_ranks_error():
    with pytest.raises(ValueError) as e:
        data_parallel_mesh([])
    assert "non-empty" in str(e.value) and "0 ranks" in str(e.value)


def test_tensor_parallel_mesh_errors():
    with pytest.raises(ValueError) as e:
        tensor_parallel_mesh(16, ranks=range(8))
    assert "needs 16" in str(e.value) and "have 8" in str(e.value)
    with pytest.raises(ValueError):
        tensor_parallel_mesh(0)


def test_meshes_over_a_world_of_two(world):
    """``tensor_parallel_mesh(2)``: one ``('tp',)`` axis of two ranks, a
    tensor group and a gloo host group of two, cached; ``make_mesh`` keeps
    the reference's axis order with ``tp`` innermost."""
    for rank, out in enumerate(world["tp2"]):
        m = out["meshes"]
        assert m["tp"] == (("tp",), (2,), rank, 2, 2)
        assert m["cached"]
        names, shape, tp_coord, dp_coord, tp_n, dp_n = m["full"]
        assert names == ("pp", "dp", "ep", "sp", "tp")
        assert shape == {"pp": 1, "dp": 1, "ep": 1, "sp": 1, "tp": 2}
        assert (tp_coord, dp_coord, tp_n, dp_n) == (rank, 0, 2, 1)


# -- the layout tables -------------------------------------------------------


def test_partition_specs_match_the_reference():
    jcfg = jl.llama_tiny()
    jspecs = jl.param_partition_specs(jcfg, tp_axis="tp")
    tspecs = tl.param_partition_specs(tl.llama_tiny(), tp_axis="tp")
    flat_j = jax.tree_util.tree_leaves_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(flat_j) == 12
    for path, spec in flat_j:
        node = tspecs
        for k in path:
            node = node[k.key]
        assert tuple(spec) == node, (path, spec, node)
    jc = jl.paged_cache_partition_specs(tp_axis="tp")
    tc = tl.paged_cache_partition_specs(tp_axis="tp")
    for name in ("k", "v", "block_table", "length"):
        assert tuple(getattr(jc, name)) == getattr(tc, name), name


def test_shard_params_slices_and_copies(world):
    """The shards concatenate back to the full tree along each leaf's
    split axis; replicated leaves are equal copies, never the same
    storage."""
    cfg, params = world["cfg"], world["params"]
    specs = tl.param_partition_specs(cfg)
    shards = [tl.shard_params(params, specs, r, 2) for r in range(2)]
    for name, spec in [("embed", specs["embed"]),
                       ("lm_head", specs["lm_head"]),
                       ("final_norm", specs["final_norm"])] + [
            (("layers", k), v) for k, v in specs["layers"].items()]:
        get = ((lambda t, n=name: t[n[0]][n[1]]) if isinstance(name, tuple)
               else (lambda t, n=name: t[n]))
        full = get(params)
        parts = [get(s) for s in shards]
        assert all(p.data_ptr() != full.data_ptr() for p in parts)
        dims = [i for i, a in enumerate(spec) if a is not None]
        if dims:
            assert torch.equal(torch.cat(parts, dims[0]), full), name
        else:
            assert all(torch.equal(p, full) for p in parts), name
    with pytest.raises(ValueError, match="does not split"):
        tl.shard_params(params, specs, 0, 3)


# -- ServeEngine knob validation + tp_size=1 unchanged ----------------------


def test_engine_tp_validation(world):
    cfg, params = world["cfg"], world["params"]
    kw = dict(n_slots=2, max_len=16, chunk=4, metrics=tmetrics.NULL,
              sampler=False)
    with pytest.raises(ValueError, match="tp_size must be >= 1"):
        ServeEngine(params, cfg, tp_size=0, **kw)
    with pytest.raises(ValueError, match="does not divide"):
        ServeEngine(params, cfg, tp_size=3, **kw)   # n_heads=4 % 3
    # every sharded axis divides 16 here, so a world of one rank hits the
    # mesh's rank-count error
    wide = tl.llama_tiny(dtype=torch.float32, n_heads=16, n_kv_heads=16)
    wide_params = tl.init_params(wide, 0, device="cpu")
    with pytest.raises(ValueError, match="needs 16"):
        ServeEngine(wide_params, wide, tp_size=16, **kw)


def test_tp1_default_unsharded(world):
    cfg, params = world["cfg"], world["params"]
    reg = tmetrics.MetricsRegistry(event_log=None)
    eng = ServeEngine(params, cfg, n_slots=2, max_len=16, chunk=4,
                      metrics=reg, sampler=False)
    assert eng.tp_size == 1 and eng.mesh is None and eng.is_leader
    assert eng.params is params
    g = eng.metrics_snapshot()["gauges"]
    assert g["tp.size"] == 1
    assert g["kv.shard_total_bytes"] == g["kv.total_bytes"]
    assert g["kv.shard_block_bytes"] == g["kv.block_bytes"]
    eng.close()                                      # a no-op at tp=1
    with pytest.raises(RuntimeError, match="follower"):
        eng.follow()


# -- sharded parity / frozen signatures / shard accounting -------------------


@pytest.mark.tp
@pytest.mark.parametrize("prefix_cache", [False, True])
@pytest.mark.parametrize("spec", [False, True])
def test_sharded_token_parity(world, prefix_cache, spec):
    """tp = 2 tokens equal the JAX tp = 2 engine's, the port's tp = 1
    engine's and solo ``generate``'s, with one signature a program on
    the leader and on the follower."""
    leader, follower = world["tp2"]
    run = leader["parity"][(prefix_cache, spec)]
    want_sizes = SPEC_PROGRAMS if spec else PROGRAMS
    assert run["sizes"] == want_sizes
    assert follower["parity"][(prefix_cache, spec)]["sizes"] == want_sizes
    assert run["tokens"] == world["jax"][(False, False)][0]
    assert run["tokens"] == leader["tp1"]
    assert run["tokens"] == _solo_tokens(world, worker.requests())


@pytest.mark.tp
@pytest.mark.parametrize("combo", [(False, False), (True, True)])
def test_sharded_logits_match_jax(world, combo):
    """After every step, the leader's logits of every decoding row are the
    JAX tp = 2 engine's within 1e-5 (the same rows decode at each step)."""
    got = world["tp2"][0]["parity"][combo]["logits"]
    want = world["jax"][combo][1]
    assert len(got) == len(want) > 0
    n = 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for row in g:
            np.testing.assert_allclose(g[row], w[row], rtol=0,
                                       atol=LOGITS_ATOL)
            n += 1
    assert n > 0


@pytest.mark.tp
def test_sharded_compile_frozen_and_shard_gauges(world):
    """Two serve passes on one sharded engine: one signature a program,
    no retrace, the per-shard KV gauges × tp = the logical pool; the
    clone (supervisor respawn) carries the degree and the weights and
    serves solo-exact tokens."""
    out = world["tp2"][0]["gauges"]
    assert out["sizes"] == PROGRAMS
    assert out["retrace"] == 0
    assert out["pool_heads"] == 2                  # 4 KV heads over 2 ranks
    g = out["gauges"]
    assert g["tp.size"] == 2
    assert g["kv.shard_total_bytes"] * 2 == g["kv.total_bytes"]
    assert g["kv.shard_block_bytes"] * 2 == g["kv.block_bytes"]
    for state in ("free", "referenced", "cached"):
        assert (g[f"kv.shard_{state}_bytes"] * 2
                == g[f"kv.{state}_bytes"]), state
    kv = out["kv"]
    assert kv["tp_size"] == 2
    assert kv["shard_total_bytes"] * 2 == kv["total_bytes"]
    assert (kv["free_blocks"] + kv["referenced_blocks"]
            + kv["cached_blocks"]) == out["n_blocks"] - 1
    clone = out["clone"]
    assert clone["tp_size"] == 2 and clone["status"] == "OK"
    assert clone["shares_weights"]
    assert clone["tokens"] == _solo_tokens(world, worker.requests()[:1])
    assert world["tp2"][1]["gauges"] is None       # the follower followed


@pytest.mark.tp
def test_sharded_preempt_replay_parity(world):
    out = world["tp2"][0]["preempt"]
    assert out["preemptions"] >= 1
    assert out["statuses"] == ["OK", "OK"]
    assert out["tokens"] == _solo_tokens(world, worker.preempt_requests(),
                                         max_len=16)
    assert out["sizes"] == PROGRAMS
    assert out["free_blocks"] == 5


@pytest.mark.tp
def test_sharded_engine_under_local_replica(world):
    out = world["tp2"][0]["replica"]
    assert out["ok"]
    assert out["tokens"] == _solo_tokens(world, worker.requests()[:1])
    assert out["probe"]["tp_size"] == 2


@pytest.mark.tp
def test_measure_tp_throughput_smoke(world):
    out = world["tp2"][0]["measure"]
    assert out["serve_tp_sizes"] == [1, 2]
    assert out["serve_tp_skipped"] == [16]
    assert out["serve_tp1_tokens_per_sec"] > 0
    assert out["serve_tp2_tokens_per_sec"] > 0
    assert out["serve_tp1_scaling_eff"] == 1.0
    assert out["serve_tp2_scaling_eff"] > 0
    assert out["tokens"] == sum(r.max_new_tokens for r in worker.requests())
    assert world["tp2"][1]["measure"] is None      # followers return None


@pytest.mark.tp
def test_tp_env_knob_and_shard_input(world):
    """``tp_size`` unset reads ``HVD_TORCH_TP=2``; an engine given a
    rank's ``shard_params`` output keeps it as its weights."""
    leader, follower = world["tp2"]
    for out in (leader["env"], follower["env"]):
        assert out["tp_size"] == 2 and out["same_shard"]
    assert "follow()" in follower["env"]["follower_refuses_submit"]
    run = leader["env"]["run"]
    assert run["sizes"] == SPEC_PROGRAMS
    assert run["tokens"] == _solo_tokens(world, worker.requests())


@pytest.mark.tp
def test_sharded_device_plane_counts_the_whole_program(world):
    """The leader counts its shard of each program, recorded tp times:
    the FLOPs of a tp = 4 engine equal the tp = 1 engine's exactly; the
    peak is the card's × tp and the HBM reconciliation holds one rank's
    shard."""
    planes = world["tp4"][0]["device"]
    one, four = planes[1], planes[4]
    assert four["n_devices"] == 4 and one["n_devices"] == 1
    assert four["peak_flops"] == 4e12 and one["peak_flops"] == 1e12
    assert four["flops"] == one["flops"]
    assert set(four["flops"]) == {"tick", "chunk", "set_row", "spec_tick"}
    assert four["flops"]["tick"] > 0
    assert four["kv_total_bytes"] * 4 == one["kv_total_bytes"]
    assert four["param_bytes"] < one["param_bytes"]
    assert four["sizes"] == SPEC_PROGRAMS


@pytest.mark.tp
@pytest.mark.parametrize("combo", [(True, True), (False, False)])
def test_tp4_world(world, combo):
    """tp = 4 over a world of four (one KV head a rank): tokens and
    logits as tp = 2's."""
    leader = world["tp4"][0]["parity"][combo]
    assert leader["tokens"] == _solo_tokens(world, worker.requests())
    assert leader["sizes"] == (SPEC_PROGRAMS if combo[1] else PROGRAMS)
    want = world["jax"][combo][1]
    assert len(leader["logits"]) == len(want)
    for g, w in zip(leader["logits"], want):
        assert set(g) == set(w)
        for row in g:
            np.testing.assert_allclose(g[row], w[row], rtol=0,
                                       atol=LOGITS_ATOL)
    for follower in world["tp4"][1:]:
        assert follower["parity"][combo]["sizes"] == leader["sizes"]


def test_llama_serving_example_tp2_on_cpu(example):
    """``llama_serving --tp 2``: two ranks serve through the leader /
    follower protocol, tokens equal to a tp = 1 engine's."""
    stdout, stderr = example.communicate(timeout=120)
    assert example.returncode == 0, stderr
    lines = stdout.splitlines()
    assert lines[-1] == "tp engine == tp=1 engine: True", lines
    assert lines[-2].startswith("tp engine: 2 ranks, 3 requests, 12 tokens")
