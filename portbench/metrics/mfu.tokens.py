"""``mfu.tokens``: the model FLOPs of the window's train steps (the
yardstick's count from the configuration's shapes, remat not counted) over
the window's length and the chips' bf16 peak, in percent."""

from portbench import inputs, yardstick


def read(run):
    m = inputs.llama_dims(run.config)
    t = run.traffic
    per_step = yardstick.train_flops(
        m["dim"], m["n_layers"], m["n_heads"], m["n_kv_heads"],
        m["ffn_dim"], m["vocab"], t["sequences_per_card"],
        t["sequence_length"])
    flops = per_step * sum(r["window"]["steps"] for r in run.reports)
    return 100 * flops / run.window_s / (run.chips
                                         * yardstick.PEAK_FLOPS["bf16"])
