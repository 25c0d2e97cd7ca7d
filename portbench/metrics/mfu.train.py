"""Share of the card's INT8 peak that the window's model FLOPs of training (forward and backward) would fill."""

from portbench import readers


def read(ctx):
    return readers.mfu(ctx, "train_model_flops")
