"""Runner ``train_lm``: data-parallel training of a Llama-block decoder.

The path of the port's ``examples/llama_finetune.py``: ``basics.init``,
``broadcast_parameters``, ``DistributedOptimizer(AdamW)`` with
global-norm clipping after the gradient allreduce, ``make_train_step``
over ``llama.make_loss_fn`` with the flash kernels and per-layer remat.
Each rank takes its own rows of every step (:func:`..inputs.lm_batch`).

The traced segment opens ``portbench.update`` around the optimizer's
``synchronize()`` (the gradient allreduce) and ``step()`` (AdamW).
"""

from __future__ import annotations

import contextlib

import torch

from portbench import inputs

UPDATE_RANGE = "portbench.update"
# The faults the calibration reads on the chip (Program's ``fault``).
FAULTS = ("half_batch",)


def work_per_step(config: dict, traffic: dict) -> int:
    """Tokens a rank trains on in one step."""
    return traffic["sequences_per_card"] * traffic["sequence_length"]


def _llama_config(config: dict, llama):
    m = inputs.llama_dims(config)
    port = config["port"]
    return llama.llama3_8b(
        vocab_size=m["vocab"], dim=m["dim"], n_layers=m["n_layers"],
        n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"],
        ffn_dim=m["ffn_dim"], rope_theta=m["rope_theta"],
        norm_eps=m["norm_eps"],
        max_seq_len=config["max_position_embeddings"],
        attn_impl=port["attn_impl"], remat=port["remat"],
        fused_loss_chunk=port["fused_loss_chunk"])


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


class Program:
    """One training run of the port, driven from the seed.  ``fault``
    breaks the step underneath for the checks that must fail: None,
    ``"unchanged"`` (the update never happens) or ``"half_batch"`` (the
    step sees only the first half of each batch)."""

    def __init__(self, config: dict, traffic: dict, optim: dict, seed: int,
                 device: str | None = None, fault: str | None = None):
        from horovod_tpu_torch import basics
        from horovod_tpu_torch.models import llama
        from horovod_tpu_torch.optim.distributed_optimizer import (
            DistributedOptimizer, broadcast_parameters, make_train_step)

        basics.init(device)
        self.dev = basics.device()
        self.rank, self.world = basics.rank(), basics.size()
        self.config, self.traffic, self.seed = config, traffic, seed
        self.optim, self.fault = optim, fault
        self.cfg = _llama_config(config, llama)
        self.specs = inputs.llama_leaves(config)
        self.named = {name: inputs.llama_leaf(seed, name, shape, fan_in,
                                              self.dev)
                      for name, shape, fan_in in self.specs}
        self.params = broadcast_parameters(_tree(self.named), root_rank=0)
        for t in self.named.values():
            t.requires_grad_()
        adamw = torch.optim.AdamW(
            list(self.named.values()), lr=optim["lr"],
            betas=tuple(optim["betas"]), weight_decay=optim["weight_decay"],
            fused=self.dev.type == "cuda")
        self.opt = DistributedOptimizer(adamw)
        if fault == "unchanged":
            self.opt.optimizer.step = lambda closure=None: None
        self._step = make_train_step(llama.make_loss_fn(self.cfg), self.opt,
                                     max_grad_norm=optim["max_grad_norm"])
        self.steps = 0

    def batch(self, step: int):
        b = self.traffic["sequences_per_card"]
        rows = inputs.lm_batch(self.seed, self.rank, step, b,
                               self.traffic["sequence_length"],
                               self.cfg.vocab_size, self.dev)
        if self.fault == "half_batch":
            rows = rows[:b // 2]
        return rows[:, :-1], rows[:, 1:]

    def step(self) -> torch.Tensor:
        """One step on the next rows; the loss averaged over the world."""
        out = self._step(self.params, self.batch(self.steps))
        self.steps += 1
        return out.loss

    @torch.no_grad()
    def first_steps(self, n: int) -> dict:
        """Steps 1..n with the comparison's readings: the losses, the
        first gradient from AdamW's first moment after step 1
        (m₁ = (1 − β₁)·g₁), and each leaf's change after step n."""
        beta1 = self.optim["betas"][0]
        losses, grad = [], {}
        for i in range(n):
            with torch.enable_grad():
                losses.append(self.step())
            if i == 0:
                state = self.opt.optimizer.state
                grad = {name: (float(state[t]["exp_avg"].norm()) / (1 - beta1)
                               if "exp_avg" in state.get(t, {}) else 0.0)
                        for name, t in self.named.items()}
        change = {}
        for name, shape, fan_in in self.specs:
            start = inputs.llama_leaf(self.seed, name, shape, fan_in,
                                      self.dev)
            change[name] = float((self.named[name] - start).norm())
            del start
        return {"losses": [float(x) for x in losses], "grad": grad,
                "change": change}

    @contextlib.contextmanager
    def traced(self):
        """Open ``portbench.update`` around the optimizer's reduction and
        update while the block runs."""
        sync, step = self.opt.synchronize, self.opt.step

        def wrap(fn):
            def ranged(*a, **k):
                with torch.profiler.record_function(UPDATE_RANGE):
                    return fn(*a, **k)
            return ranged

        self.opt.synchronize, self.opt.step = wrap(sync), wrap(step)
        try:
            yield
        finally:
            del self.opt.synchronize, self.opt.step

    def close(self) -> None:
        from horovod_tpu_torch import basics

        self.params = self.named = self.opt = self._step = None
        basics.shutdown()


def reference(config: dict, traffic: dict, optim: dict, seed: int,
              world: int, steps: int, device, lowp: bool = False) -> dict:
    from portbench.reference import mistral

    return mistral.readings(config, traffic, optim, seed, world, steps,
                            device, lowp=lowp)
