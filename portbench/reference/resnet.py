"""Plain PyTorch reference of a bottleneck ResNet's first training steps.

ResNet v1.5 (He et al. 2015, table 1; the stride of a down-sampling block
on its 3×3 convolution) with flax's SAME padding (a stride-2 3×3
convolution on an even side pads (0, 1)), training-mode batch norm over
each card's own rows (biased variance, epsilon 1e-5), a dense head and
cross-entropy; then ``torch.optim.SGD`` with momentum on the gradient
averaged over the cards, as the configuration states.

Float32 with TF32 off.  It imports nothing of the port and takes nothing
the port made: the weights and the batches are drawn again from the seed
(:mod:`portbench.inputs`).  ``lowp=True`` gives the control: every
convolution's and the head's operands rounded to fp8
(:mod:`portbench.reference.lowp`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench import inputs
from portbench.reference import lowp as lowp_mod

EPS = 1e-5


def _same_pads(size: int, k: int, s: int) -> tuple[int, int]:
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride, conv, explicit=None):
    k = w.shape[-1]
    if explicit is not None:
        return conv(x, w, (stride, stride), (explicit, explicit))
    (top, bottom), (left, right) = (_same_pads(n, k, stride)
                                    for n in x.shape[2:])
    if top != bottom or left != right:
        x = F.pad(x, (left, right, top, bottom))
        top = left = 0
    return conv(x, w, (stride, stride), (top, left))


def _bn(x, w: dict, key: str):
    return F.batch_norm(x, None, None, w[f"{key}.weight"], w[f"{key}.bias"],
                        True, 0.0, EPS)


def logits(w: dict, images: torch.Tensor, config: dict, lowp: bool = False):
    """Logits of NHWC ``images`` under weights ``w`` (the state-dict keys
    of :func:`portbench.inputs.resnet_leaves`)."""
    if lowp:
        conv, mm = lowp_mod.fp8_conv2d, lowp_mod.fp8_matmul
    else:
        def conv(x, wt, stride, padding):
            return F.conv2d(x, wt, None, stride, padding)
        mm = torch.matmul
    x = images.permute(0, 3, 1, 2).contiguous()
    x = F.relu(_bn(_conv(x, w["conv_init.weight"], 2, conv, explicit=3),
                   w, "bn_init"))
    x = F.max_pool2d(x, 3, 2, padding=1)
    width, features, b = config["width"], config["width"], 0
    for i, count in enumerate(config["stage_sizes"]):
        filters = width * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            key = f"BottleneckBlock_{b}"
            y = x
            for n, s in enumerate((1, stride, 1)):
                y = _bn(_conv(y, w[f"{key}.Conv_{n}.weight"], s, conv), w,
                        f"{key}.BatchNorm_{n}")
                if n < 2:
                    y = F.relu(y)
            if features != filters * 4 or stride != 1:
                x = _bn(_conv(x, w[f"{key}.downsample_conv.weight"], stride,
                              conv), w, f"{key}.downsample_bn")
            x = F.relu(y + x)
            features, b = filters * 4, b + 1
    return mm(x.mean((2, 3)), w["head.weight"].t()) + w["head.bias"]


def readings(config: dict, traffic: dict, optim: dict, seed: int,
             world: int, steps: int, device, lowp: bool = False) -> dict:
    """The comparison's readings (:mod:`portbench.compare`) of ``steps``
    steps over every rank's rows: each rank's rows normalised by their own
    batch statistics, the gradients averaged over the ranks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN's heuristics, not its autotune (which the program turned on):
    # a float32 search per shape costs more than the three steps.
    torch.backends.cudnn.benchmark = False
    state = inputs.resnet_state(config, seed, device)
    w = {k: v.clone().requires_grad_() for k, v in state.items()
         if "running_" not in k}
    start = {k: v.detach().clone() for k, v in w.items()}
    del state
    opt = torch.optim.SGD(list(w.values()), lr=optim["lr_per_card"] * world,
                          momentum=optim["momentum"], foreach=False)
    b = traffic["images_per_card"]
    losses, grad = [], {}
    for step in range(steps):
        total = 0.0
        for r in range(world):
            x, y = inputs.image_batch(seed, r, step, b, config["image_size"],
                                      config["in_channels"],
                                      config["num_classes"], device)
            part = F.cross_entropy(logits(w, x, config, lowp), y) / world
            part.backward()
            total += float(part.detach())
        if step == 0:
            grad = {k: float(t.grad.norm()) for k, t in w.items()}
        opt.step()
        opt.zero_grad(set_to_none=True)
        losses.append(total)
    with torch.no_grad():
        change = {k: float((w[k] - start[k]).norm()) for k in w}
    return {"losses": losses, "grad": grad, "change": change}
