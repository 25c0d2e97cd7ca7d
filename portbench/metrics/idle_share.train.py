"""Share of the training window with no kernel running on the device."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)
