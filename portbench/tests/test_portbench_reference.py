"""The plain references against the port at tiny widths on the CPU, in f32.

They must agree to float32 rounding where both compute in float32: the
comparison that decides ``correct`` then measures the program's precision
and faults, not a difference of definitions.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest
import torch

from portbench import inputs
from portbench.reference import lowp, mistral, resnet

TINY_LM = {"hidden_size": 64, "intermediate_size": 96,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 128,
           "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
           "max_position_embeddings": 64}
TINY_RESNET = {"stage_sizes": [1, 1], "width": 8, "image_size": 32,
               "in_channels": 3, "num_classes": 10,
               # Every scale at one here, so the residual branches carry
               # their whole share of the gradient.
               "last_bn_scale": 1.0}


def _tree(flat):
    tree = {"layers": {}}
    for k, v in flat.items():
        if k.startswith("layers."):
            tree["layers"][k[7:]] = v
        else:
            tree[k] = v
    return tree


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_decoder_loss_and_gradients_match_the_port(attn):
    from horovod_tpu_torch.models import llama

    m = inputs.llama_dims(TINY_LM)
    cfg = llama.llama3_8b(
        vocab_size=m["vocab"], dim=m["dim"], n_layers=m["n_layers"],
        n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"],
        ffn_dim=m["ffn_dim"], rope_theta=m["rope_theta"],
        norm_eps=m["norm_eps"], max_seq_len=64, attn_impl=attn,
        remat=False, dtype=torch.float32)
    flat = {n: inputs.llama_leaf(3, n, s, f, "cpu").requires_grad_()
            for n, s, f in inputs.llama_leaves(TINY_LM)}
    rows = inputs.lm_batch(3, 0, 0, 2, 24, m["vocab"], "cpu")
    port = llama.loss_fn(_tree(flat), (rows[:, :-1], rows[:, 1:]), cfg)
    port_g = torch.autograd.grad(port, list(flat.values()))
    ref = mistral.loss(flat, rows, m)
    ref_g = torch.autograd.grad(ref, list(flat.values()))
    assert float(port.detach()) == pytest.approx(float(ref.detach()), rel=1e-5)
    for a, b in zip(port_g, ref_g):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-7


def test_resnet_logits_and_gradients_match_the_port():
    from horovod_tpu_torch.models.resnet import ResNet

    model = ResNet(stage_sizes=tuple(TINY_RESNET["stage_sizes"]),
                   num_classes=10, width=8, dtype=torch.float32,
                   device="cpu")
    state = inputs.resnet_state(TINY_RESNET, 5, "cpu")
    model.load_state_dict(state)
    x, y = inputs.image_batch(5, 0, 0, 6, 32, 3, 10, "cpu")
    port = torch.nn.functional.cross_entropy(model(x), y)
    names = [k for k, _ in model.named_parameters()]
    port_g = torch.autograd.grad(port, [p for _, p in
                                        model.named_parameters()])
    w = {k: state[k].clone().requires_grad_() for k in names}
    ref = torch.nn.functional.cross_entropy(resnet.logits(w, x, TINY_RESNET),
                                            y)
    ref_g = torch.autograd.grad(ref, [w[k] for k in names])
    assert float(port.detach()) == pytest.approx(float(ref.detach()), rel=1e-5)
    for a, b in zip(port_g, ref_g):
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-7


def test_fp8_rounding_keeps_three_mantissa_bits():
    x = torch.tensor([1.0, 1.0625, 1.125, -3.0, 448.0])
    got = lowp.round_fp8(x, lowp.E4M3)
    # One scale maps 448 to e4m3's largest finite value: x itself.
    assert torch.equal(got, torch.tensor([1.0, 1.0, 1.125, -3.0, 448.0]))
    a = torch.randn(8, 16, requires_grad=True)
    b = torch.randn(16, 4, requires_grad=True)
    out = lowp.fp8_matmul(a, b)
    exact = (a @ b).detach()
    assert float((out.detach() - exact).norm() / exact.norm()) < 0.1
    out.sum().backward()
    assert a.grad.shape == a.shape and b.grad.shape == b.shape


def test_the_references_import_nothing_of_the_program():
    for path in Path(mistral.__file__).parent.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "horovod_tpu_torch", "horovod_tpu", "jax", "flax"), \
                    (path.name, n)
