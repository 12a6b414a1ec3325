"""``mfu.images``: three times the forward FLOPs of the ResNet's
convolutions and head (the yardstick's count from the published shapes)
for every image of the window, over the window's length and the chips'
bf16 peak, in percent."""

from portbench import yardstick


def read(run):
    c = run.config
    per_image = 3 * yardstick.resnet_forward_flops(
        c["stage_sizes"], c["width"], c["image_size"], c["num_classes"],
        c["in_channels"])
    return 100 * per_image * run.work / run.window_s / (
        run.chips * yardstick.PEAK_FLOPS["bf16"])
