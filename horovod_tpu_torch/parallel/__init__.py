"""Parallelism strategies of the port: data parallelism (``optim/``), and
sequence parallelism (ring and Ulysses attention), pipeline parallelism and
expert parallelism (``models/moe.py``) over the differentiable collectives
of ``_collectives.py``, and the rank meshes (``mesh.py``) that tensor-parallel
serving shards over.  (``flash_attention`` stays a module here: its
kernels' counters are read as ``parallel.flash_attention.launches``.)"""

from horovod_tpu_torch.parallel.attention import (  # noqa: F401
    blockwise_attention,
    dense_attention,
    ring_attention,
    ulysses_attention,
    zigzag_positions,
    zigzag_shard,
    zigzag_unshard,
)
from horovod_tpu_torch.parallel.mesh import (  # noqa: F401
    data_parallel_mesh,
    make_mesh,
    tensor_parallel_mesh,
)
from horovod_tpu_torch.parallel.pipeline import (  # noqa: F401
    pipeline_forward,
    pipeline_loss_fn,
    stack_stage_params,
)
