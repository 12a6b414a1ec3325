"""Tiny versions of the cells for the CPU tests: the same runners, files
and comparison, the widths cut to what a test run can hold.

The limits here are the tiny sizes' own, set from CPU readings of the
sound program and of its faults at these sizes on three seeds (sound
gaps at most 6.5e-4 on the loss, 0.055 on a gradient norm, 0.073 on a
change; half a batch at least 6.1e-3, 0.081 and 0.23; a missing update
or a frozen residual branch 1 on both leaf numbers): the cells' own
limits, set on the chip at full size, are tighter than a tiny bf16 run
can meet.
"""

from __future__ import annotations

from portbench import harness

LIMITS = {"loss_gap": 1e-3, "grad_gap": 0.1, "change_gap": 0.1}
SHRINK = {
    "train_lm": ({"hidden_size": 64, "intermediate_size": 128,
                  "num_attention_heads": 4, "num_key_value_heads": 2,
                  "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 256,
                  "max_position_embeddings": 128},
                 {"sequences_per_card": 2, "sequence_length": 32}),
    "train_vision": ({"stage_sizes": [1, 1], "width": 8, "image_size": 32,
                      "num_classes": 10},
                     {"images_per_card": 8}),
}


def cell(name: str) -> harness.Cell:
    c = harness.Cell(name)
    config, traffic = SHRINK[c.config["runner"]]
    c.config = {**c.config, **config}
    c.traffic = {**c.traffic, **traffic}
    c.spec = {**c.spec, "limits": dict(LIMITS)}
    return c
