"""Gang-relaunch drill for the port: ``elastic.run`` with durable commits
through ``python -m horovod_tpu.launch --restarts``.

The port's twin of ``tests/multiprocess_elastic_worker.py``.  Attempt 1: a
2-rank gloo gang accumulates rank-summed vectors under ``elastic.run``,
committing durably every 2 batches; rank 1 dies (``os._exit``) at batch 5.
The launcher tears the gang down and relaunches it.  Attempt 2 (marker
present): ``run()`` restores the newest durable commit, batch 4, and the
loop finishes.  The final accumulator must equal the uninterrupted run's
on every rank.

Launched by tests/test_torch_port_elastic.py.
"""

import faulthandler
import json
import os
import sys

faulthandler.enable()
faulthandler.dump_traceback_later(120, exit=False)

BATCHES = 8


def main() -> None:
    sys.path.insert(
        0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from horovod_tpu_torch import basics, elastic
    from horovod_tpu_torch import torch_frontend as hvd

    basics.init("cpu")
    n, me = hvd.size(), hvd.rank()
    assert n == 2, f"this worker expects a 2-rank world, got {n}"
    marker = os.environ["ELASTIC_MARKER"]
    first_attempt = not os.path.exists(marker)

    state = elastic.State(ckpt_dir=os.environ["ELASTIC_CKPT"],
                          sync_commits=True, acc=torch.zeros(4), batch=0)
    if not first_attempt:
        state.restore()     # a probe; run() restores again, idempotently
        print(f"ELASTIC-RESUMED batch={state.batch}", flush=True)
        assert state.batch == 4, state.batch

    @elastic.run
    def train(state):
        while state.batch < BATCHES:
            b = state.batch
            red = hvd.allreduce(torch.full((4,), float(me + b)),
                                average=False, name=f"el.{b}")
            state.acc = state.acc + red
            state.batch = b + 1
            if state.batch % 2 == 0:
                state.commit()
            if state.batch == 5 and me == 1 and first_attempt:
                with open(marker, "w") as f:
                    f.write("died at batch 5")
                print("ELASTIC-KILL rank 1 dying mid-run", flush=True)
                os._exit(17)
        return state.acc

    acc = train(state)
    want = float(sum(n * b + n * (n - 1) // 2 for b in range(BATCHES)))
    assert torch.allclose(acc, torch.full((4,), want)), (acc, want)
    assert str(basics.device()) == "cpu"
    hvd.shutdown()
    print("ELASTIC_OK " + json.dumps({"rank": me, "acc": float(acc[0])}),
          flush=True)


if __name__ == "__main__":
    main()
