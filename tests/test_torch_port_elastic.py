"""The port's elastic training (``horovod_tpu_torch/elastic.py`` and
``torch_elastic.py``) against the JAX package's.

Mirrors ``tests/test_elastic.py`` (State commit / restore / sync and the
``run`` retry loop) on a CPU world of one in this process, the four
scenarios of ``tests/torch_elastic_worker.py`` (rollback, durable, api,
load-failure agreement) on a 2-rank gloo world, an in-process reinit of
that world and of the hook-driven optimizer, the JAX frontend's commit
format in both directions, and the gang relaunch of
``tests/test_multiprocess.py``'s elastic drill through
``python -m horovod_tpu.launch --restarts``.  The engine fault is raised at
the engine's own site: its shutdown flag set under a live world.

Tolerance: none.  Commits, restores and replays move values exactly, so
every comparison is bit for bit.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import warnings
import zipfile

import numpy as np
import pytest
import torch

from torch_gloo_world import start_world

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
ENV = {"HVD_TORCH_NATIVE_CONTROLLER": "off"}


@pytest.fixture()
def hvd():
    from horovod_tpu_torch import basics
    from horovod_tpu_torch import torch_frontend

    basics.init("cpu")
    yield torch_frontend
    basics.shutdown()


def _mk_state(**kw):
    from horovod_tpu_torch import elastic

    return elastic.State(
        params={"w": torch.arange(4.0), "b": torch.zeros(2)},
        epoch=0, batch=0, **kw)


# -- tests/test_elastic.py, on the port's State -------------------------------


def test_state_field_access_and_unknown_field(hvd):
    s = _mk_state()
    assert s.epoch == 0
    s.epoch = 3
    assert s.epoch == 3
    assert torch.equal(s.params["w"], torch.arange(4.0))
    with pytest.raises(AttributeError, match="unknown state field"):
        s.momentum = 1.0
    with pytest.raises(AttributeError):
        _ = s.nope


def test_state_requires_fields_and_rejects_reserved_names(hvd):
    from horovod_tpu_torch import elastic

    with pytest.raises(ValueError, match="at least one field"):
        elastic.State()
    with pytest.raises(ValueError, match="reserved"):
        elastic.State(_private=1)


def test_commit_restore_rolls_back_in_memory(hvd):
    s = _mk_state()
    s.epoch = 2
    s.params = {"w": torch.full((4,), 7.0), "b": torch.ones(2)}
    s.commit()
    assert s.commit_step == 1
    s.epoch = 9
    s.params = {"w": torch.zeros(4), "b": torch.zeros(2)}
    s.restore()
    assert s.epoch == 2 and s.commit_step == 1
    assert torch.equal(s.params["w"], torch.full((4,), 7.0))
    assert type(s.epoch) is int


def test_restore_without_commit_syncs_initial_values(hvd):
    s = _mk_state()
    s.restore()
    assert s.epoch == 0 and s.commit_step == 0
    assert torch.equal(s.params["w"], torch.arange(4.0))


def test_durable_commit_survives_a_fresh_state(hvd, tmp_path):
    d = str(tmp_path / "ck")
    s = _mk_state(ckpt_dir=d, sync_commits=True)
    s.epoch, s.batch = 1, 5
    s.commit()
    s.batch = 6
    s.commit()
    fresh = _mk_state(ckpt_dir=d)
    fresh.restore()
    assert (fresh.epoch, fresh.batch) == (1, 6)
    assert fresh.commit_step == 2


def test_async_commit_lands_before_restore(hvd, tmp_path):
    import horovod_tpu_torch as port

    d = str(tmp_path / "ck")
    s = _mk_state(ckpt_dir=d)           # background writes
    s.batch = 3
    s.commit()
    fresh = _mk_state(ckpt_dir=d)
    fresh.restore()                     # waits for the write in flight
    assert fresh.batch == 3
    port.wait_for_checkpoints()


def test_restore_walks_past_a_torn_checkpoint(hvd, tmp_path):
    d = str(tmp_path / "ck")
    s = _mk_state(ckpt_dir=d, sync_commits=True)
    s.batch = 4
    s.commit()
    os.makedirs(os.path.join(d, "step_99"))         # a torn newer commit
    with open(os.path.join(d, "step_98"), "wb") as f:
        f.write(b"PK\x03\x04truncated")
    fresh = _mk_state(ckpt_dir=d)
    fresh.restore()
    assert fresh.batch == 4 and fresh.commit_step == 1


def test_list_checkpoints_newest_first(hvd, tmp_path):
    import horovod_tpu_torch as port

    d = str(tmp_path / "ck")
    s = _mk_state(ckpt_dir=d, sync_commits=True)
    for _ in range(3):
        s.commit()
    assert port.latest_checkpoint(d).endswith("step_3")
    names = [os.path.basename(p) for p in port.list_checkpoints(d)]
    assert names == ["step_3", "step_2", "step_1"]


def test_run_retries_internal_error_and_restores(hvd, monkeypatch):
    from horovod_tpu_torch import elastic

    monkeypatch.setenv("HVD_TORCH_ELASTIC_RETRIES", "3")
    s = _mk_state()
    attempts = []

    @elastic.run
    def train(state):
        attempts.append(state.batch)
        if state.batch == 0:
            state.batch = 1
            state.commit()
        state.batch += 100
        if len(attempts) < 3:
            raise hvd.HorovodInternalError("synthetic collective failure")
        return state.batch

    assert train(s) == 101
    assert attempts == [0, 1, 1]
    assert hvd.size() >= 1


def test_run_exhausts_retries(hvd, monkeypatch):
    from horovod_tpu_torch import elastic

    monkeypatch.setenv("HVD_TORCH_ELASTIC_RETRIES", "1")
    s = _mk_state()

    @elastic.run
    def always_fails(state):
        raise hvd.HorovodInternalError("down forever")

    with pytest.raises(hvd.HorovodInternalError, match="down forever"):
        always_fails(s)


def test_retry_budget_resets_when_commits_advance(hvd, monkeypatch):
    from horovod_tpu_torch import elastic

    monkeypatch.setenv("HVD_TORCH_ELASTIC_RETRIES", "1")
    s = _mk_state()
    seen = []

    @elastic.run
    def train(state):
        seen.append(state.batch)
        if state.batch < 3:         # progress, then a failure: 3 times
            state.batch += 1
            state.commit()
            raise hvd.HorovodInternalError("transient")
        return state.batch

    assert train(s) == 3
    assert seen == [0, 1, 2, 3]


def test_run_propagates_user_errors_without_retry(hvd):
    from horovod_tpu_torch import elastic

    s = _mk_state()
    calls = []

    @elastic.run
    def buggy(state):
        calls.append(1)
        raise ValueError("a caller mistake, not environmental")

    with pytest.raises(ValueError):
        buggy(s)
    assert calls == [1]


def test_reinit_keeps_a_cpu_world_a_cpu_world(hvd, monkeypatch):
    """The port's counterpart of test_reinit_replays_a_device_subset_world:
    a bare init() would try the card; run() replays the recorded device."""
    from horovod_tpu_torch import basics, elastic

    monkeypatch.setenv("HVD_TORCH_ELASTIC_RETRIES", "2")
    s = elastic.State(epoch=0)
    seen = []

    @elastic.run
    def train(state):
        seen.append((str(basics.device()), hvd.size(),
                     basics._state.generation))
        if len(seen) == 1:
            raise hvd.HorovodInternalError("synthetic failure")
        return hvd.size()

    assert train(s) == 1
    assert [d for d, _, _ in seen] == ["cpu", "cpu"]
    assert seen[1][2] == seen[0][2] + 1     # a fresh init, the same world


def test_restore_failure_consumes_a_retry(hvd, monkeypatch):
    from horovod_tpu_torch import elastic

    monkeypatch.setenv("HVD_TORCH_ELASTIC_RETRIES", "3")
    s = _mk_state()
    orig_restore = elastic.State.restore
    fails = {"left": 2}

    def flaky_restore(self):
        if fails["left"] > 0:
            fails["left"] -= 1
            raise hvd.HorovodInternalError("collective died mid-restore")
        orig_restore(self)

    monkeypatch.setattr(elastic.State, "restore", flaky_restore)
    runs = []

    @elastic.run
    def train(state):
        runs.append(1)
        return "done"

    assert train(s) == "done"
    assert runs == [1] and fails["left"] == 0


def test_restore_failure_exhausts_the_budget(hvd, monkeypatch):
    from horovod_tpu_torch import elastic

    monkeypatch.setenv("HVD_TORCH_ELASTIC_RETRIES", "1")
    s = _mk_state()

    def always_fails(self):
        raise hvd.HorovodInternalError("restore down forever")

    monkeypatch.setattr(elastic.State, "restore", always_fails)

    @elastic.run
    def train(state):
        raise AssertionError("fn must never run")

    with pytest.raises(hvd.HorovodInternalError, match="down forever"):
        train(s)


def test_internal_error_during_durable_restore_is_not_a_torn_commit(
        hvd, tmp_path, monkeypatch):
    """A collective that fails mid-restore propagates: falling back to an
    older commit would resume from the wrong step."""
    from horovod_tpu_torch import checkpoint, elastic

    d = str(tmp_path / "ck")
    s = _mk_state(ckpt_dir=d, sync_commits=True)
    for b in (1, 2):
        s.batch = b
        s.commit()
    calls = []

    def broken(path, template=None):
        calls.append(os.path.basename(path))
        raise hvd.HorovodInternalError("collective died")

    monkeypatch.setattr(checkpoint, "restore_checkpoint", broken)
    with pytest.raises(hvd.HorovodInternalError):
        _mk_state(ckpt_dir=d).restore()
    assert calls == ["step_2"]
    assert isinstance(elastic.HorovodInternalError("x"), RuntimeError)


def test_adopt_drift_warns_and_yields_writable_leaves(hvd):
    from horovod_tpu_torch import elastic

    s = elastic.State(params={"w": torch.zeros(2)}, epoch=0)
    ro = np.arange(3.0)
    ro.setflags(write=False)
    drifted = {"params": {"w": torch.arange(3.0), "extra_new_leaf": ro},
               "epoch": 1}
    with pytest.warns(UserWarning, match="structure"):
        s._adopt(drifted)
    assert s.epoch == 1 and type(s.epoch) is int
    assert set(s.params) == {"w", "extra_new_leaf"}
    s.params["extra_new_leaf"][0] = 5.0
    assert s.params["extra_new_leaf"][0] == 5.0
    s.params["w"][0] = 9.0                  # a fresh tensor, not the input
    assert drifted["params"]["w"][0] == 0.0


def test_adopt_matched_path_makes_readonly_arrays_writable(hvd):
    from horovod_tpu_torch import elastic

    s = elastic.State(buf=np.zeros(3), epoch=0)
    ro = np.arange(3.0)
    ro.setflags(write=False)
    s._adopt({"buf": ro, "epoch": 2})
    assert s.epoch == 2
    s.buf[0] = 9.0
    assert s.buf[0] == 9.0


def test_commit_snapshot_never_aliases_live_fields(hvd):
    from horovod_tpu_torch import elastic

    s = elastic.State(buf=np.zeros(3), t=torch.zeros(3), epoch=0)
    s.buf[0] = 1.0
    s.t[0] = 1.0
    s.commit()
    s.buf[0] = 99.0                 # in-place changes after the commit
    s.t[0] = 99.0
    s.restore()
    assert s.buf[0] == 1.0 and s.t[0] == 1.0
    s.buf[1] = 5.0
    s.t[1] = 5.0
    s.restore()                     # the restored fields alias nothing
    assert s.buf[1] == 0.0 and s.t[1] == 0.0


def test_init_records_its_arguments_through_shutdown(hvd):
    """The port's counterpart of test_init_devices_iterator_materialized:
    ``init`` records the resolved device and the launcher environment, and
    they survive ``shutdown()`` for the replay."""
    from horovod_tpu_torch import basics

    dev, env = basics._state.last_init_args
    assert dev == torch.device("cpu") and env is None
    basics.shutdown()
    assert basics._state.last_init_args == (dev, env)
    basics.init("cpu")


def test_run_rejects_non_state_first_arg(hvd):
    from horovod_tpu_torch import elastic

    @elastic.run
    def train(state):
        return 1

    with pytest.raises(TypeError, match="elastic.State"):
        train({"params": 1})


def test_engine_shutdown_raises_internal_error(hvd):
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops import eager

    x = torch.ones(2)
    eng = eager._engine()
    eng._shutdown.set()             # a shutdown racing the caller's enqueue
    with pytest.raises(hvd.HorovodInternalError):
        hvd.allreduce_async(x, name="el.shutdown.race")
    basics.shutdown()
    with pytest.raises(basics.NotInitializedError):
        hvd.allreduce(x)
    basics.init("cpu")
    assert issubclass(hvd.HorovodInternalError, RuntimeError)


def test_hook_optimizer_survives_an_engine_failure_mid_backward(hvd):
    """The hook route inside run(): the engine dies between two steps, the
    next backward's first hook raises HorovodInternalError, and the replay
    from the last commit ends on the uninterrupted run's parameters."""
    from horovod_tpu_torch import torch_elastic
    from horovod_tpu_torch.ops import eager

    def train_run(fail_at):
        torch.manual_seed(0)
        m = torch.nn.Linear(4, 3)
        opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
        dopt = hvd.DistributedOptimizer(opt, m.named_parameters())
        st = torch_elastic.TorchState(model=m, optimizer=opt, step=0)
        data = torch.randn(8, 5, 4, generator=torch.Generator().manual_seed(1))
        entries = []

        @hvd.elastic.run
        def loop(state):
            entries.append(state.step)
            while state.step < 8:
                if state.step == fail_at and len(entries) == 1:
                    eager._engine()._shutdown.set()
                dopt.zero_grad()
                m(data[state.step]).square().mean().backward()
                dopt.step()
                state.step += 1
                if state.step % 2 == 0:
                    state.commit()
            return entries

        out = loop(st)
        dopt.remove_hooks()
        return {k: v.clone() for k, v in m.state_dict().items()}, out

    clean, entries = train_run(fail_at=-1)
    assert entries == [0]
    resumed, entries = train_run(fail_at=5)
    assert entries == [0, 4]
    for k in clean:
        assert torch.equal(clean[k], resumed[k]), k


def test_torch_frontend_exposes_elastic(hvd):
    from horovod_tpu_torch import torch_elastic

    assert hvd.elastic is torch_elastic
    assert hvd.elastic.run is torch_elastic.run


# -- tests/torch_elastic_worker.py, on a 2-rank gloo world --------------------


def _expect_raises(exc, match, fn):
    try:
        fn()
    except exc as e:
        assert match in str(e), (match, e)
        return
    raise AssertionError(f"expected {exc.__name__}({match!r})")


def _model_and_opt(rank):
    torch.manual_seed(0)
    m = torch.nn.Linear(4, 2)
    opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
    torch.manual_seed(10 + rank)            # ranks diverge from here
    m(torch.randn(3, 4)).sum().backward()
    opt.step()
    return m, opt


def _scenarios(rank, world, shared):
    import horovod_tpu_torch.torch_frontend as hvdt

    done = []
    # rollback: commit/restore rolls model, optimizer and scalars back
    m, opt = _model_and_opt(rank)
    st = hvdt.elastic.TorchState(model=m, optimizer=opt, epoch=0)
    st.epoch = 1
    st.commit()
    root = [t.clone() for t in hvdt.broadcast(
        torch.cat([v.reshape(-1) for v in m.state_dict().values()]), 0,
        name="root.params").split([v.numel() for v in
                                   m.state_dict().values()])]
    for _ in range(3):
        m(torch.randn(3, 4)).sum().backward()
        opt.step()
    st.epoch = 7
    st.restore()
    assert st.epoch == 1 and st.commit_step == 1
    for v, want in zip(m.state_dict().values(), root):
        assert torch.equal(v.reshape(-1), want)   # the root's commit
    assert len(opt.state_dict()["state"]) > 0
    done.append("rollback ok")

    # durable: a fresh TorchState adopts the root's durable commit
    d = os.path.join(shared, "durable")
    m, opt = _model_and_opt(rank)
    st = hvdt.elastic.TorchState(model=m, optimizer=opt, ckpt_dir=d,
                                 epoch=0)
    st.epoch = 2
    st.commit()
    want = {k: v.clone() for k, v in m.state_dict().items()}
    want = {k: hvdt.broadcast(v, 0, name=f"want.{k}") for k, v in
            want.items()}
    m2, opt2 = _model_and_opt(rank + 5)
    fresh = hvdt.elastic.TorchState(model=m2, optimizer=opt2, ckpt_dir=d,
                                    epoch=0)
    fresh.restore()
    assert fresh.epoch == 2 and fresh.commit_step == 1
    for k, v in want.items():
        assert torch.equal(m2.state_dict()[k], v), k
    hvdt.barrier()
    if rank == 0:
        with open(os.path.join(d, "step_99.pt"), "wb") as f:
            f.write(b"not a torch file")
    hvdt.barrier()
    fresh2 = hvdt.elastic.TorchState(model=m2, optimizer=opt2, ckpt_dir=d,
                                     epoch=0)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fresh2.restore()
    if rank == 0:
        assert any("skipping unreadable checkpoint" in str(x.message)
                   for x in rec), [str(x.message) for x in rec]
    assert fresh2.epoch == 2 and fresh2.commit_step == 1
    hvdt.barrier()
    if rank == 0:
        with zipfile.ZipFile(os.path.join(d, "step_100.pt"), "w") as z:
            z.writestr("data", "not a checkpoint")
    hvdt.barrier()
    fresh3 = hvdt.elastic.TorchState(model=m2, optimizer=opt2, ckpt_dir=d,
                                     epoch=0)
    _expect_raises(RuntimeError, "elastic restore failed on root",
                   fresh3.restore)
    hvdt.barrier()
    if rank == 0:
        os.remove(os.path.join(d, "step_100.pt"))
        assert not [f for f in os.listdir(d) if f.endswith(".tmp")]
    done.append("durable ok")

    # api: scalar fields, reserved names, run() acceptance
    m, opt = _model_and_opt(rank)
    st = hvdt.elastic.TorchState(model=m, epoch=0, best_acc=0.0)
    st.best_acc = 0.5
    assert st.best_acc == 0.5
    _expect_raises(AttributeError, "unknown state field",
                   lambda: setattr(st, "lr", 0.1))
    _expect_raises(ValueError, "reserved",
                   lambda: hvdt.elastic.TorchState(model=m, _x=1))
    _expect_raises(ValueError, "needs a model",
                   lambda: hvdt.elastic.TorchState())
    st2 = hvdt.elastic.TorchState(model=m, optimizer=opt, epoch=0)

    @hvdt.elastic.run
    def train(state):
        state.epoch += 1
        return state.epoch

    assert train(st2) == 1
    done.append("api ok")

    # load-failure agreement: a commit from changed model code fails
    # restore() on every rank through the agreed outcome
    d = os.path.join(shared, "changed")
    st_old = hvdt.elastic.TorchState(model=torch.nn.Linear(4, 2),
                                     ckpt_dir=d, epoch=0)
    st_old.commit()
    st_new = hvdt.elastic.TorchState(model=torch.nn.Linear(8, 2),
                                     ckpt_dir=d, epoch=0)
    _expect_raises(RuntimeError, "elastic restore failed on root",
                   st_new.restore)
    done.append("load-failure agreement ok")
    return done


def _reinit_world(rank, world):
    """run() reinitialises the launched world (the same rank, world and
    rendezvous) after the engine fails under both ranks."""
    from horovod_tpu_torch import basics, elastic
    from horovod_tpu_torch import torch_frontend as hvd
    from horovod_tpu_torch.ops import eager

    st = elastic.State(acc=torch.zeros(3), batch=0)
    entries = []

    @elastic.run
    def train(state):
        entries.append(state.batch)
        while state.batch < 6:
            b = state.batch
            state.acc = state.acc + hvd.allreduce(
                torch.full((3,), float(rank + b)), average=False,
                name=f"b{b}")
            state.batch = b + 1
            if state.batch % 2 == 0:
                state.commit()
            if state.batch == 3 and len(entries) == 1:
                eager._engine()._shutdown.set()
        return state.acc

    acc = train(st)
    return {"acc": acc.tolist(), "entries": entries, "size": hvd.size(),
            "rank": hvd.rank(), "device": str(basics.device()),
            "env": basics._state.last_init_args[1]}


@pytest.fixture(scope="module")
def gloo2():
    shared = tempfile.mkdtemp(prefix="port_elastic_")
    scen = start_world(_scenarios, 2, shared, env=ENV)
    reinit = start_world(_reinit_world, 2, env=ENV)
    return scen(timeout=150), reinit(timeout=150)


@pytest.mark.parametrize("marker", ["rollback ok", "durable ok", "api ok",
                                    "load-failure agreement ok"])
def test_torch_state_scenarios_on_two_ranks(gloo2, marker):
    scen, _ = gloo2
    for done in scen:
        assert marker in done


def test_run_reinitialises_the_same_launched_world(gloo2):
    _, reinit = gloo2
    want = float(sum(2 * b + 1 for b in range(6)))
    for r, res in enumerate(reinit):
        assert res["acc"] == [want] * 3
        assert res["entries"] == [0, 2]     # replayed from the batch-2 commit
        assert (res["size"], res["rank"], res["device"]) == (2, r, "cpu")
        assert res["env"]["world"] == 2 and res["env"]["rank"] == r


# -- the JAX frontend's commit format, both ways ------------------------------


def _linear_and_sgd(seed):
    torch.manual_seed(seed)
    m = torch.nn.Linear(4, 2)
    opt = torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9)
    m(torch.randn(3, 4)).sum().backward()
    opt.step()
    return m, opt


def test_commits_cross_between_the_jax_frontend_and_the_port(hvd, tmp_path):
    """A ``step_N.pt`` written by the JAX frontend's TorchState restores
    into the port's with equal state_dicts and scalars, and one the port
    wrote loads into the JAX frontend's."""
    from horovod_tpu import torch_elastic as jte
    from horovod_tpu_torch import torch_elastic as pte

    jm, jopt = _linear_and_sgd(0)
    jst = jte.TorchState(model=jm, optimizer=jopt, ckpt_dir=str(tmp_path),
                         epoch=0, best=0.0)
    jst.epoch, jst.best = 3, 0.25
    object.__setattr__(jst, "_commit_step", 4)
    jst._write_file(str(tmp_path / "step_4.pt"), jst._snapshot())

    pm, popt = _linear_and_sgd(1)
    pst = pte.TorchState(model=pm, optimizer=popt, ckpt_dir=str(tmp_path),
                         epoch=0, best=0.0)
    pst.restore()
    assert (pst.epoch, pst.best, pst.commit_step) == (3, 0.25, 4)
    for k, v in jm.state_dict().items():
        assert torch.equal(pm.state_dict()[k], v), k
    js, ps = jopt.state_dict(), popt.state_dict()
    assert js["param_groups"] == ps["param_groups"]
    for i in js["state"]:
        assert torch.equal(js["state"][i]["momentum_buffer"],
                           ps["state"][i]["momentum_buffer"])

    pst.epoch = 5
    pst.commit()                    # the port writes step_5.pt
    qm, qopt = _linear_and_sgd(2)
    qst = jte.TorchState(model=qm, optimizer=qopt, epoch=0, best=0.0)
    qst._load_local(qst._read_file(str(tmp_path / "step_5.pt")))
    assert (qst.epoch, qst.best, qst.commit_step) == (5, 0.25, 5)
    for k, v in pm.state_dict().items():
        assert torch.equal(qm.state_dict()[k], v), k
    assert qopt.state_dict()["param_groups"] == \
        popt.state_dict()["param_groups"]


# -- the gang relaunch through the JAX package's launcher ---------------------


def test_gang_relaunch_resumes_from_the_durable_commit(tmp_path):
    """The twin of tests/test_multiprocess.py's elastic drill: rank 1 dies
    at batch 5, the launcher relaunches the gang, and the port's run()
    resumes from the batch-4 commit to the uninterrupted result."""
    env = dict(os.environ)
    env.update(HVD_TORCH_NATIVE_CONTROLLER="off",
               ELASTIC_MARKER=str(tmp_path / "elastic.died"),
               ELASTIC_CKPT=str(tmp_path / "elastic_ck"))
    r = subprocess.run(
        [sys.executable, "-m", "horovod_tpu.launch", "--nproc", "2",
         "--cpu", "--restarts", "2", "--", sys.executable,
         os.path.join(HERE, "torch_port_elastic_gang_worker.py")],
        env=env, capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert r.returncode == 0, (r.returncode, r.stdout[-4000:],
                               r.stderr[-4000:])
    assert "ELASTIC-KILL rank 1 dying mid-run" in r.stdout
    assert "restarting (1/2)" in r.stderr, r.stderr[-2000:]
    assert "ELASTIC-RESUMED batch=4" in r.stdout, r.stdout[-4000:]
    assert r.stdout.count("ELASTIC_OK") == 2, r.stdout[-4000:]


def test_pytorch_elastic_example_resumes_past_the_end(tmp_path):
    """The example twin on a CPU world of one: a second run against the
    same commit directory restores epoch == epochs and trains nothing."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.examples import pytorch_elastic

    args = ["--epochs", "1", "--samples", "128", "--batch-size", "16",
            "--ckpt-dir", str(tmp_path / "ck"), "--device", "cpu"]
    loss = pytorch_elastic.main(args)
    assert loss is not None and np.isfinite(loss)
    assert (tmp_path / "ck" / "step_1.pt").exists()
    assert pytorch_elastic.main(args) is None      # resumed past the end
    assert not basics.is_initialized()
