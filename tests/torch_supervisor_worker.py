"""Replica-hosting worker for the port's supervisor SIGKILL test
(tests/test_torch_supervisor.py).

The port's twin of ``tests/multiprocess_supervisor_worker.py``: this
process IS a replica backend, a single-engine
:class:`~horovod_tpu_torch.router.RouterServer` bound to ``REPLICA_PORT``,
which the test fronts with an :class:`~horovod_tpu_torch.router.HttpReplica`.
The test SIGKILLs it mid-stream and its supervisor relaunches a fresh copy
on the same port out of band.  The weights are ``llama_tiny`` in f32 from
seed 11 (``llama.init_params``), the test's own.

Prints ``WORKER_READY <port>`` once serving, then blocks until killed.
"""

import faulthandler
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:        # launched by script path, not -m
    sys.path.insert(0, REPO)

faulthandler.enable()
faulthandler.dump_traceback_later(300, exit=False)


def main() -> None:
    port = int(os.environ["REPLICA_PORT"])
    import torch

    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.router import RouterServer
    from horovod_tpu_torch.serving import Request
    from horovod_tpu_torch.serving_scheduler import ServeEngine

    cfg = llama.llama_tiny(dtype=torch.float32)
    params = llama.init_params(cfg, 11, device="cpu")
    eng = ServeEngine(params, cfg, n_slots=2, max_len=64, chunk=8,
                      prefix_cache=True, monitor=False, sampler=False)
    warm = eng.run([Request(prompt=[1] * 9, max_new_tokens=2)])
    assert all(r.ok for r in warm)
    router = RouterServer([eng], policy="round_robin", port=port,
                          sampler=False).start()
    print(f"WORKER_READY {router.port}", flush=True)
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()
