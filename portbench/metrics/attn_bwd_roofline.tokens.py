"""``attn_bwd_roofline.tokens``: the attention backward's share of its
roofline.  Each evaluation of the port's attention backward (the autograd
node ``_FlashBackward``, whose range the profiler opens) is held to the
yardstick's least time for the traffic's shape (five products: the
recomputed scores, dP, dV, dQ and dK); the share is that bound times the
calls over the device time of the kernels they launched (Δ, the dQ and
dK/dV kernels, the group sums), in percent (rank 0's trace)."""

from portbench import inputs, yardstick

RANGES = ("autograd::engine::evaluate_function: _FlashBackward",)


def read(run):
    calls = run.traces[0]["ranges"].get(RANGES[0], [])
    busy_us = sum(calls)
    if not calls or busy_us <= 0:
        return None
    m, t = inputs.llama_dims(run.config), run.traffic
    bound_ms, _ = yardstick.attn_bwd_bound(
        t["sequences_per_card"], m["n_heads"], m["n_kv_heads"],
        t["sequence_length"], m["head_dim"], True, 2, "bf16")
    return 100 * len(calls) * bound_ms * 1e3 / busy_us
