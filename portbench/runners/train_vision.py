"""Runner ``train_vision``: Horovod's synthetic benchmark on the port.

The loop of the reference's ``pytorch_synthetic_benchmark.py`` on the
port's torch frontend: ``hvd.init``, ``hvd.broadcast_parameters``,
``hvd.DistributedOptimizer(SGD(lr 0.01·size, momentum 0.9),
named_parameters=…)``, then ``zero_grad``, forward, ``loss.backward()``
(each gradient's allreduce enqueued from its hook, through the eager
engine) and ``step()``.  The model is the port's ResNet (bf16 compute,
f32 parameters, ``channels_last``), cuDNN autotune on; each rank takes its
own rows of every step (:func:`..inputs.image_batch`).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from portbench import inputs

# The faults the calibration reads on the chip (Program's ``fault``);
# ``no_exchange`` only where there is more than one rank.
FAULTS = ("half_batch", "frozen_branch", "no_exchange")
# The leaves ``frozen_branch`` leaves out of the update: each block's 3×3
# convolution, inside its residual branch.
BRANCH = ".Conv_1.weight"


def work_per_step(config: dict, traffic: dict) -> int:
    """Images a rank trains on in one step."""
    return traffic["images_per_card"]


class Program:
    """One training run of the port, driven from the seed.  ``fault``
    breaks the step underneath for the checks that must fail: None,
    ``"unchanged"`` (the update never happens), ``"half_batch"`` (the
    step sees only the first half of each batch), ``"frozen_branch"``
    (each block's 3×3 convolution gets a zero gradient) or
    ``"no_exchange"`` (the gradients are not reduced over the ranks)."""

    def __init__(self, config: dict, traffic: dict, optim: dict, seed: int,
                 device: str | None = None, fault: str | None = None):
        import horovod_tpu_torch.torch_frontend as hvd
        from horovod_tpu_torch import basics
        from horovod_tpu_torch.models.resnet import ResNet

        hvd.init(device)
        self.dev = basics.device()
        self.rank, self.world = hvd.rank(), hvd.size()
        self.config, self.traffic, self.seed = config, traffic, seed
        self.optim, self.fault = optim, fault
        if self.dev.type == "cuda":
            torch.backends.cudnn.benchmark = True
        model = ResNet(stage_sizes=tuple(config["stage_sizes"]),
                       num_classes=config["num_classes"],
                       width=config["width"], dtype=torch.bfloat16,
                       device=self.dev)
        model.load_state_dict(inputs.resnet_state(config, seed, self.dev))
        hvd.broadcast_parameters(model.state_dict(), root_rank=0)
        self.model = model
        self.opt = hvd.DistributedOptimizer(
            torch.optim.SGD(model.parameters(),
                            lr=optim["lr_per_card"] * hvd.size(),
                            momentum=optim["momentum"]),
            named_parameters=model.named_parameters())
        if fault == "unchanged":
            self.opt.optimizer.step = lambda closure=None: None
        elif fault == "frozen_branch":
            frozen = [t for k, t in model.named_parameters()
                      if k.endswith(BRANCH)]
            inner = self.opt.optimizer.step

            def step(closure=None):
                for t in frozen:
                    t.grad.zero_()
                return inner(closure)
            self.opt.optimizer.step = step
        elif fault == "no_exchange":
            self.opt.local = True
        self.steps = 0

    def batch(self, step: int):
        b = self.traffic["images_per_card"]
        c = self.config
        x, y = inputs.image_batch(self.seed, self.rank, step, b,
                                  c["image_size"], c["in_channels"],
                                  c["num_classes"], self.dev)
        if self.fault == "half_batch":
            x, y = x[:b // 2], y[:b // 2]
        return x, y

    def step(self) -> torch.Tensor:
        """One step on the next rows; this rank's loss."""
        x, y = self.batch(self.steps)
        self.opt.zero_grad()
        loss = F.cross_entropy(self.model(x), y)
        loss.backward()
        self.opt.step()
        self.steps += 1
        return loss.detach()

    def first_steps(self, n: int) -> dict:
        """Steps 1..n with the comparison's readings: the losses averaged
        over the ranks, the first gradient from SGD's momentum buffer after
        step 1 (the first buffer is the gradient), and each leaf's change
        after step n (rank 0's parameters)."""
        named = dict(self.model.named_parameters())
        start = {k: t.detach().clone() for k, t in named.items()}
        losses, grad = [], {}
        for i in range(n):
            losses.append(self.step())
            if i == 0:
                state = self.opt.optimizer.state
                grad = {k: (float(state[t]["momentum_buffer"].norm())
                            if "momentum_buffer" in state.get(t, {}) else 0.0)
                        for k, t in named.items()}
        with torch.no_grad():
            change = {k: float((t - start[k]).norm())
                      for k, t in named.items()}
            mean = torch.stack(losses)
            if self.world > 1:
                torch.distributed.all_reduce(mean)
                mean /= self.world
        return {"losses": [float(x) for x in mean], "grad": grad,
                "change": change}

    @contextlib.contextmanager
    def traced(self):
        yield

    def close(self) -> None:
        from horovod_tpu_torch import basics

        self.model = self.opt = None
        basics.shutdown()


def reference(config: dict, traffic: dict, optim: dict, seed: int,
              world: int, steps: int, device, lowp: bool = False) -> dict:
    from portbench.reference import resnet

    return resnet.readings(config, traffic, optim, seed, world, steps,
                           device, lowp=lowp)
