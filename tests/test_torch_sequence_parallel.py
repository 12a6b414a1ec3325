"""The port's differentiable collectives and sequence-parallel attention
against the JAX package's under ``shard_map``, on gloo worlds of 2 and 4.

Mirrors ``tests/test_attention.py`` (ring, causal or not, and its
gradients; Ulysses, with KVH = 2 < n = 4 on the dense and the flash local
engine, and its refusal of indivisible heads; the zig-zag helpers and the
zig-zag ring) and ``tests/test_models.py`` (the ring and ``ulysses_flash``
Llama), with the JAX tests' tolerances.  Rank r's slice of the sequence is
held against row r of the JAX side; inputs come from seeded numpy, the
Llama weights from the JAX ``init_params`` through ``params_from_jax``.
One spawned world per size for the file, plus a world of 4 that runs a
ring backward alone under a 30 s join: the collective-order check.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import params_from_jax
from horovod_tpu_torch.parallel import _collectives as coll
from horovod_tpu_torch.parallel import attention as ta
from horovod_tpu_torch.parallel.flash_attention import flash_attention
from torch_gloo_world import jax_spmd, start_world

WORLDS = (2, 4)
OUT_ATOL = 2e-5          # test_attention.py: outputs
GRAD_ATOL = 5e-5         # test_attention.py: gradients
GQA_ATOL = 3e-5          # test_attention.py: Ulysses with KVH < n
LLAMA_ATOL = 2e-4        # test_models.py: sequence-parallel Llama logits
ORDER_TIMEOUT_S = 30.0
CAUSAL = (True, False)


def _qkv(b=2, l=64, h=4, kvh=4, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*s).astype(np.float32)
                 for s in ((b, l, h, d), (b, l, kvh, d), (b, l, kvh, d)))


def _slices(x, world, axis=1):
    return np.stack(np.split(x, world, axis=axis))


def _mine(arrs, rank, world):
    return tuple(torch.from_numpy(np.ascontiguousarray(
        np.split(a, world, axis=1)[rank])) for a in arrs)


def _grads(fn, *xs):
    xs = [x.clone().requires_grad_() for x in xs]
    out = fn(*xs)
    (out ** 2).sum().backward()
    return [x.grad.numpy() for x in xs]


def _raises(call):
    try:
        call()
    except Exception as e:      # recorded and held by the tests
        return type(e).__name__, str(e)
    return None


def _tiny(impl, **kw):
    return tl.llama_tiny(dtype=torch.float32, attn_impl=impl, **kw)


def _save(path, **trees):
    """Nested dicts of arrays into one ``.npz`` (keys ``tree/a/b``): a spawn
    argument larger than a pipe's buffer would hold the parent until each
    child in turn had imported torch."""
    flat = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(f"{prefix}/{k}", v)
            else:
                flat[f"{prefix}/{k}"] = v

    for name, tree in trees.items():
        walk(name, tree)
    np.savez(path, **flat)


def _load(path, name):
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            first, *rest = key.split("/")
            if first != name:
                continue
            node = out
            for k in rest[:-1]:
                node = node.setdefault(k, {})
            node[rest[-1]] = z[key]
    return out


def _worker(rank, world, path):
    torch.set_num_threads(1)        # W processes share the cores
    weights, weights8 = _load(path, "w"), _load(path, "w8")
    tokens = _load(path, "data")["tokens"]
    seen = {}
    x = torch.from_numpy(np.arange(6, dtype=np.float32) + 10 * rank)
    y = torch.from_numpy(np.arange(4 * world * 3, dtype=np.float32)
                         .reshape(4 * world, 3) + 100 * rank)
    seen["ppermute"] = [t.numpy() for t in coll.ppermute(
        (x, 2 * x), [(i, (i + 1) % world) for i in range(world)])]
    seen["ppermute_partial"] = coll.ppermute((x,), [(0, world - 1)])[0].numpy()
    for name, fn in (("all_to_all", lambda t: coll.all_to_all(t, 0, 1)),
                     ("all_gather", lambda t: coll.all_gather(t, 1)),
                     ("reduce_scatter", lambda t: coll.reduce_scatter(t, 0)),
                     ("psum", coll.psum), ("pmean", coll.pmean)):
        t = y.clone().requires_grad_()
        out = fn(t)
        w = torch.arange(out.numel(), dtype=torch.float32).reshape(out.shape)
        ((out * w).sum() * (rank + 1)).backward()
        seen[name] = (out.detach().numpy(), t.grad.numpy())
    t = x.clone().requires_grad_()
    (a,) = coll.ppermute((t,), [(i, (i + 1) % world) for i in range(world)])
    ((a * torch.arange(6.0)).sum() * (rank + 1)).backward()
    seen["ppermute_grad"] = t.grad.numpy()

    for causal in CAUSAL:
        q, k, v = _mine(_qkv(), rank, world)
        seen[f"ring_{causal}"] = ta.ring_attention(q, k, v,
                                                   causal=causal).numpy()
        q, k, v = _mine(_qkv(h=8, kvh=8), rank, world)
        seen[f"ulysses_{causal}"] = ta.ulysses_attention(
            q, k, v, causal=causal).numpy()
        q, k, v = _mine([ta.zigzag_shard(torch.from_numpy(a), world).numpy()
                         for a in _qkv(seed=5)], rank, world)
        seen[f"zigzag_{causal}"] = ta.ring_attention(
            q, k, v, causal=causal, zigzag=True).numpy()
        if world == 4:
            for impl, l in (("dense", 64), ("flash", 256)):
                q, k, v = _mine(_qkv(l=l, h=8, kvh=2), rank, world)
                seen[f"gqa_{impl}_{causal}"] = ta.ulysses_attention(
                    q, k, v, causal=causal,
                    impl=flash_attention if impl == "flash" else None).numpy()
    q, k, v = _mine(_qkv(b=1, l=32, h=2, kvh=2, d=8), rank, world)
    seen["ring_grads"] = _grads(
        lambda q, k, v: ta.ring_attention(q, k, v, causal=True), q, k, v)
    seen["ulysses_grads"] = _grads(
        lambda q, k, v: ta.ulysses_attention(q, k, v, causal=True),
        *_mine(_qkv(b=1, l=32, h=4, kvh=2, d=8, seed=2), rank, world))
    h_bad = {2: 3, 4: 6}[world]
    seen["indivisible"] = [_raises(lambda: ta.ulysses_attention(*_mine(
        _qkv(b=1, l=16, h=h, kvh=kvh, d=8), rank, world)))
        for h, kvh in ((h_bad, h_bad), (8, 3))]

    lc = tokens.shape[1] // world
    mine = torch.from_numpy(np.ascontiguousarray(
        tokens[:, rank * lc:(rank + 1) * lc]))
    world_group = torch.distributed.group.WORLD
    seen["llama_ring"] = tl.forward(
        params_from_jax(weights, device="cpu"), mine, _tiny("ring"),
        positions_offset=rank * lc, sp_group=world_group).numpy()
    seen["llama_ulysses_flash"] = tl.forward(
        params_from_jax(weights8, device="cpu"), mine,
        _tiny("ulysses_flash", n_heads=8, n_kv_heads=8),
        positions_offset=rank * lc, sp_group=world_group).numpy()
    if world == 2:
        return seen
    # One remat train step's gradients through the ring: the checkpoint
    # recomputes the ring's hops inside the backward.
    p = params_from_jax(weights, device="cpu")
    leaves = [p["layers"]["wq"], p["embed"]]
    for t in leaves:
        t.requires_grad_()
    tl.forward(p, mine, _tiny("ring", remat=True), positions_offset=rank * lc,
               sp_group=world_group).pow(2).mean().backward()
    seen["llama_ring_remat_grads"] = [t.grad.numpy() for t in leaves]
    return seen


def _ring_backward(rank, world):
    """A causal ring's backward on every rank, nothing else."""
    torch.set_num_threads(1)
    return _grads(lambda q, k, v: ta.ring_attention(q, k, v, causal=True),
                  *_mine(_qkv(b=1, l=32, h=2, kvh=2, d=8), rank, world))


def _jax_side(world, jweights, jweights8, tokens):
    """Every JAX counterpart of ``_worker``'s values, in one ``shard_map``
    program (one compile a world)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from horovod_tpu.models import llama as jl
    from horovod_tpu.parallel import attention as ja

    jweights, jweights8 = (jax.tree.map(jnp.asarray, w)
                           for w in (jweights, jweights8))
    ring = [(i, (i + 1) % world) for i in range(world)]
    lc = tokens.shape[1] // world

    def shards(arrs):
        return [jnp.asarray(_slices(a, world)) for a in arrs]

    inputs = {
        "x": jnp.asarray(np.stack([np.arange(6, dtype=np.float32) + 10 * r
                                   for r in range(world)])),
        "y": jnp.asarray(np.stack([np.arange(4 * world * 3, dtype=np.float32)
                                   .reshape(4 * world, 3) + 100 * r
                                   for r in range(world)])),
        "ring": shards(_qkv()), "ulysses": shards(_qkv(h=8, kvh=8)),
        "zigzag": shards([np.asarray(ja.zigzag_shard(a, world))
                          for a in _qkv(seed=5)]),
        "ring_grads": shards(_qkv(b=1, l=32, h=2, kvh=2, d=8)),
        "ulysses_grads": shards(_qkv(b=1, l=32, h=4, kvh=2, d=8, seed=2)),
        "tokens": jnp.asarray(_slices(tokens, world)),
    }
    if world == 4:
        inputs["gqa_dense"] = shards(_qkv(l=64, h=8, kvh=2))
        inputs["gqa_flash"] = shards(_qkv(l=256, h=8, kvh=2))

    def grads(attend, q, k, v):
        return jax.grad(lambda q, k, v: jnp.sum(attend(q, k, v) ** 2),
                        argnums=(0, 1, 2))(q, k, v)

    def body(a):
        me = lax.axis_index("hvd")
        out = {"ppermute": (lax.ppermute(a["x"], "hvd", ring),
                            lax.ppermute(2 * a["x"], "hvd", ring)),
               "ppermute_partial": lax.ppermute(a["x"], "hvd",
                                                [(0, world - 1)]),
               "ppermute_grad": jax.grad(lambda x: jnp.sum(
                   lax.ppermute(x, "hvd", ring) * jnp.arange(6.0))
                   * (me + 1))(a["x"])}
        for name, fn in (
                ("all_to_all", lambda t: lax.all_to_all(t, "hvd", 0, 1,
                                                        tiled=True)),
                ("all_gather", lambda t: lax.all_gather(t, "hvd", axis=1,
                                                        tiled=True)),
                ("reduce_scatter", lambda t: lax.psum_scatter(
                    t, "hvd", scatter_dimension=0, tiled=True)),
                ("psum", lambda t: lax.psum(t, "hvd")),
                ("pmean", lambda t: lax.pmean(t, "hvd"))):
            def loss(t, fn=fn):
                o = fn(t)
                w = jnp.arange(o.size, dtype=jnp.float32).reshape(o.shape)
                return jnp.sum(o * w) * (me + 1)
            out[name] = (fn(a["y"]), jax.grad(loss)(a["y"]))
        for causal in CAUSAL:
            out[f"ring_{causal}"] = ja.ring_attention(
                *a["ring"], axis_name="hvd", causal=causal)
            out[f"ulysses_{causal}"] = ja.ulysses_attention(
                *a["ulysses"], axis_name="hvd", causal=causal)
            out[f"zigzag_{causal}"] = ja.ring_attention(
                *a["zigzag"], axis_name="hvd", causal=causal, zigzag=True)
            if world == 4:
                # Both local engines are held to the JAX dense engine, as
                # the reference's test holds both to dense attention.
                for impl in ("dense", "flash"):
                    out[f"gqa_{impl}_{causal}"] = ja.ulysses_attention(
                        *a[f"gqa_{impl}"], axis_name="hvd", causal=causal)
        out["ring_grads"] = grads(
            lambda q, k, v: ja.ring_attention(q, k, v, axis_name="hvd"),
            *a["ring_grads"])
        out["ulysses_grads"] = grads(
            lambda q, k, v: ja.ulysses_attention(q, k, v, axis_name="hvd"),
            *a["ulysses_grads"])
        for name, params, cfg in (
                ("llama_ring", jweights,
                 jl.llama_tiny(dtype=jnp.float32, attn_impl="ring")),
                ("llama_ulysses_flash", jweights8,
                 jl.llama_tiny(dtype=jnp.float32, attn_impl="ulysses_flash",
                               n_heads=8, n_kv_heads=8))):
            out[name] = jl.forward(params, a["tokens"], cfg,
                                   positions_offset=me * lc, sp_axis="hvd")
        if world == 4:
            rcfg = jl.llama_tiny(dtype=jnp.float32, attn_impl="ring",
                                 remat=True)

            def remat_loss(wq, embed):
                p = dict(jweights, embed=embed,
                         layers=dict(jweights["layers"], wq=wq))
                return jnp.mean(jl.forward(
                    p, a["tokens"], rcfg, sp_axis="hvd",
                    positions_offset=me * lc) ** 2)
            out["llama_ring_remat_grads"] = jax.grad(
                remat_loss, argnums=(0, 1))(jweights["layers"]["wq"],
                                            jweights["embed"])
        return out

    return jax_spmd(body, world, inputs)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    import jax

    from horovod_tpu.models import llama as jl

    def weights(**kw):
        cfg = jl.llama_tiny(dtype=jax.numpy.float32, **kw)
        return jax.tree.map(np.asarray, jax.jit(
            jl.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0)))

    w, w8 = weights(), weights(n_heads=8, n_kv_heads=8)
    tokens = np.random.RandomState(1).randint(0, 256, (2, 64)).astype(
        np.int64)
    path = str(tmp_path_factory.mktemp("sp") / "inputs.npz")
    _save(path, w=w, w8=w8, data={"tokens": tokens})
    order = start_world(_ring_backward, 4)
    joins = {n: start_world(_worker, n, path) for n in WORLDS}
    jx = {n: _jax_side(n, w, w8, tokens.astype(np.int32)) for n in WORLDS}
    out = {n: (joins[n](timeout=300), jx[n]) for n in WORLDS}
    out["order"] = order
    return out


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_and_their_transposes_match_jax(worlds, world):
    """ppermute (a ring of two tensors as one node, a partial permutation
    with zeros where nothing arrives), the tiled all-to-all, all_gather,
    reduce_scatter, psum and pmean: values and per-rank gradients."""
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        _close(seen["ppermute"][0], jx["ppermute"][0][r], 0)
        _close(seen["ppermute"][1], jx["ppermute"][1][r], 0)
        _close(seen["ppermute_partial"], jx["ppermute_partial"][r], 0)
        _close(seen["ppermute_grad"], jx["ppermute_grad"][r], 0)
        for name in ("all_to_all", "all_gather", "reduce_scatter", "psum",
                     "pmean"):
            _close(seen[name][0], jx[name][0][r], 1e-6)
            _close(seen[name][1], jx[name][1][r], 1e-6)


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("world", WORLDS)
def test_ring_attention_matches_jax(worlds, world, causal):
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        _close(seen[f"ring_{causal}"], jx[f"ring_{causal}"][r], OUT_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ring_attention_gradients_match_jax(worlds, world):
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        for g, want in zip(seen["ring_grads"], jx["ring_grads"]):
            _close(g, want[r], GRAD_ATOL)


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_matches_jax(worlds, world, causal):
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        _close(seen[f"ulysses_{causal}"], jx[f"ulysses_{causal}"][r],
               OUT_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_gradients_match_jax(worlds, world):
    """GQA (KVH = 2): at n = 4 the KV heads expand before their a2a."""
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        for g, want in zip(seen["ulysses_grads"], jx["ulysses_grads"]):
            _close(g, want[r], GRAD_ATOL)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("causal", CAUSAL)
def test_ulysses_gqa_fewer_kv_heads_than_ranks(worlds, causal, impl):
    """KVH = 2 < n = 4, with the dense and the flash local engine."""
    ranks, jx = worlds[4]
    for r, seen in enumerate(ranks):
        _close(seen[f"gqa_{impl}_{causal}"], jx[f"gqa_{impl}_{causal}"][r],
               GQA_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_ulysses_rejects_indivisible_heads(worlds, world):
    ranks, _ = worlds[world]
    for seen in ranks:
        assert [e and e[0] for e in seen["indivisible"]] == ["ValueError"] * 2
        assert all("divisible" in e[1] for e in seen["indivisible"])


@pytest.mark.parametrize("causal", CAUSAL)
@pytest.mark.parametrize("world", WORLDS)
def test_zigzag_ring_matches_jax(worlds, world, causal):
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        _close(seen[f"zigzag_{causal}"], jx[f"zigzag_{causal}"][r],
               OUT_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_llama_ring_and_ulysses_flash_match_jax(worlds, world):
    """tests/test_models.py's sequence-parallel Llama, rank by rank."""
    ranks, jx = worlds[world]
    for r, seen in enumerate(ranks):
        _close(seen["llama_ring"], jx["llama_ring"][r], LLAMA_ATOL)
        _close(seen["llama_ulysses_flash"], jx["llama_ulysses_flash"][r],
               LLAMA_ATOL)


def test_llama_ring_remat_gradients_match_jax(worlds):
    """The remat recompute runs the ring's hops again inside the
    backward, in the same order on every rank."""
    ranks, jx = worlds[4]
    for r, seen in enumerate(ranks):
        for g, want in zip(seen["llama_ring_remat_grads"],
                           jx["llama_ring_remat_grads"]):
            _close(g, want[r], GRAD_ATOL)


def test_four_rank_ring_backward_completes(worlds):
    """The collective-order check: every rank's backward reaches the
    ring's hops in the same order, so a world of 4 finishes."""
    got = worlds["order"](timeout=ORDER_TIMEOUT_S)
    jx = worlds[4][1]["ring_grads"]
    for r, grads in enumerate(got):
        for g, want in zip(grads, jx):
            _close(g, want[r], GRAD_ATOL)


def test_zigzag_helpers_match_jax():
    import jax.numpy as jnp

    from horovod_tpu.parallel import attention as ja

    x = np.arange(2 * 48 * 3).reshape(2, 48, 3)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(ta.zigzag_shard(t, 8).numpy(),
                                  np.asarray(ja.zigzag_shard(jnp.asarray(x), 8)))
    np.testing.assert_array_equal(ta.zigzag_unshard(ta.zigzag_shard(t, 8),
                                                    8).numpy(), x)
    n, l = 4, 32
    pos_global = ta.zigzag_shard(torch.arange(l)[None, :, None], n)[0, :, 0]
    for r in range(n):
        got = ta.zigzag_positions(r, n, l // n).numpy()
        np.testing.assert_array_equal(got, pos_global[r * 8:(r + 1) * 8])
        np.testing.assert_array_equal(got, np.asarray(ja.zigzag_positions(
            r, n, l // n)))
    zz = [int((ta.zigzag_positions(r, 8, 16) + 1).sum()) for r in range(8)]
    assert len(set(zz)) == 1, zz
    with pytest.raises(ValueError, match="divisible"):
        ta.zigzag_shard(torch.zeros(1, 12), 4)


def test_sequence_parallel_llama_needs_its_group():
    """ring/ulysses with no group: the reference's 'unbound axis name:
    None'."""
    cfg = _tiny("ring")
    params = tl.init_params(cfg, 0, device="cpu")
    for impl in ("ring", "ulysses", "ulysses_flash"):
        with pytest.raises(ValueError, match="sp_group"):
            tl.forward(params, torch.zeros(1, 8, dtype=torch.long),
                       _tiny(impl))
