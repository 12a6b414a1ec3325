"""Skip-gram word2vec on the port, with sparse gradient communication.

Twin of ``examples/jax_word2vec.py`` (the reference's
tensorflow_word2vec.py): skip-gram with negative sampling over a synthetic
Zipf-like corpus, two embedding tables, Adagrad at ``lr · size``, and the
tables' gradients reduced from backward hooks by the port's
:class:`~horovod_tpu_torch.optim.eager_optimizer.EagerDistributedOptimizer`:

* dense: the gradients ride the engine's fused allreduce;
* ``--sparse``: the fork's top-k ``sparse_allreduce`` moves only the
  largest ``--sparse-ratio`` of each gradient's entries and their indices.

Every step draws the JAX script's global batch, ``--batch-per-chip ·
size`` centers, contexts and negatives, from one generator seeded alike
on every rank, and each rank trains on its own rows of it, as the JAX
package's rank-major batch is split.  The JAX script seeds that generator
from ``hash("w2v")``, which Python salts per process; the twin takes a
fixed seed (``DATA_SEED``, or ``run``'s ``data_seed``).  Adagrad takes
optax's accumulator start (0.1) and epsilon (1e-7).

    python -m horovod_tpu_torch.examples.word2vec --steps 50 --sparse --device cpu

On the card drop ``--device cpu``.
"""

from __future__ import annotations

import argparse
import zlib

import numpy as np
import torch
import torch.nn.functional as F

import horovod_tpu_torch.torch_frontend as hvd
from horovod_tpu_torch import basics
from horovod_tpu_torch.optim.eager_optimizer import EagerDistributedOptimizer

DATA_SEED = zlib.crc32(b"w2v") % 2 ** 31


def synthetic_corpus(n_tokens=20000, vocab=2000, seed=0) -> np.ndarray:
    """A Zipf-like token stream with local structure (even positions
    predict the next token), so skip-gram has something to learn."""
    rng = np.random.default_rng(seed)
    base = rng.zipf(1.3, size=n_tokens).clip(max=vocab - 1)
    base[1::2] = (base[::2][: len(base[1::2])] * 7 + 1) % vocab
    return base.astype(np.int32)


def skipgram_batches(corpus, batch, window, rng):
    """``batch`` (center, context) pairs at offsets within ``window``."""
    centers = rng.integers(window, len(corpus) - window, size=batch)
    offsets = rng.integers(1, window + 1, size=batch) * rng.choice(
        [-1, 1], size=batch)
    return corpus[centers], corpus[centers + offsets]


class SkipGram(torch.nn.Module):
    """The input and output embedding tables, ``[vocab, dim]`` each: the
    input table normal × 0.05 from ``generator``, the output table zero."""

    def __init__(self, vocab: int, dim: int, generator: torch.Generator,
                 device=None):
        super().__init__()
        self.emb_in = torch.nn.Parameter(torch.randn(
            (vocab, dim), generator=generator, device=device) * 0.05)
        self.emb_out = torch.nn.Parameter(
            torch.zeros((vocab, dim), device=device))

    def forward(self, center, context, negs):
        """The negative-sampling loss, in its stable log-sigmoid form."""
        v = self.emb_in[center]                              # [B, D]
        pos = self.emb_out[context]                          # [B, D]
        neg = self.emb_out[negs]                             # [B, K, D]
        pos_score = (v * pos).sum(-1)
        neg_score = torch.einsum("bd,bkd->bk", v, neg)
        return -(F.logsigmoid(pos_score).mean()
                 + F.logsigmoid(-neg_score).sum(-1).mean())


def run(args, tables=None, data_seed: int = DATA_SEED) -> list[float]:
    """Train ``args.steps`` steps; returns this rank's loss at each step.
    ``tables``: the initial ``(emb_in, emb_out)`` as arrays, in place of
    the seeded draw (the JAX script's ``jax.random`` tables, say);
    ``data_seed`` seeds the batches."""
    basics.init(args.device)
    dev = basics.device()
    n, r = hvd.size(), hvd.rank()
    corpus = synthetic_corpus(vocab=args.vocab)
    rng = np.random.default_rng(data_seed)

    model = SkipGram(args.vocab, args.dim,
                     torch.Generator(device=dev).manual_seed(0), device=dev)
    if tables is not None:
        with torch.no_grad():
            for p, t in zip((model.emb_in, model.emb_out), tables):
                p.copy_(torch.tensor(np.asarray(t, np.float32)))
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    opt = EagerDistributedOptimizer(
        torch.optim.Adagrad(model.parameters(), lr=args.lr * n,
                            initial_accumulator_value=0.1, eps=1e-7),
        model.named_parameters(), is_sparse=args.sparse,
        sparse_ratio=args.sparse_ratio)
    b = args.batch_per_chip
    losses = []
    for step in range(args.steps):
        c, t = skipgram_batches(corpus, b * n, args.window, rng)
        negs = rng.integers(0, args.vocab, size=(len(c), args.negatives))
        mine = slice(r * b, (r + 1) * b)       # this rank's rows
        batch = [torch.as_tensor(a[mine], dtype=torch.int64, device=dev)
                 for a in (c, t, negs)]
        opt.zero_grad()
        loss = model(*batch)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if step % 100 == 0:
            avg = hvd.allreduce(loss.detach().reshape(1), average=True,
                                name="loss")
            if r == 0:
                print(f"step {step}: loss {float(avg[0]):.4f}", flush=True)
    return losses


def parse(argv=None) -> argparse.Namespace:
    """The JAX script's flags and ``--device``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--batch-per-chip", type=int, default=64)
    p.add_argument("--vocab", type=int, default=2000)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--window", type=int, default=2)
    p.add_argument("--negatives", type=int, default=8)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--sparse", action="store_true")
    p.add_argument("--sparse-ratio", type=float, default=0.05)
    p.add_argument("--device", default=None,
                   help="'cpu' for the gloo CPU world; default the card")
    return p.parse_args(argv)


def main(argv=None) -> list[float]:
    try:
        return run(parse(argv))
    finally:
        basics.shutdown()


if __name__ == "__main__":
    main()
