"""``attn_fwd_roofline.tokens``: the attention forward's share of its
roofline.  Each call of the port's attention entry (the autograd function
``_Flash``, whose range the profiler opens around its forward, remat's
recomputation included) is held to the yardstick's least time for the
traffic's shape; the share is that bound times the calls over the device
time of the kernels the calls launched, in percent (rank 0's trace)."""

from portbench import inputs, yardstick

RANGES = ("_Flash",)


def read(run):
    calls = run.traces[0]["ranges"].get(RANGES[0], [])
    busy_us = sum(calls)
    if not calls or busy_us <= 0:
        return None
    m, t = inputs.llama_dims(run.config), run.traffic
    bound_ms, _ = yardstick.flash_bound(
        t["sequences_per_card"], m["n_heads"], m["n_kv_heads"],
        t["sequence_length"], m["head_dim"], True, 2, "bf16")
    return 100 * len(calls) * bound_ms * 1e3 / busy_us
