"""idle_share.resolve (%): the share of the traced calls' wall in which no kernel,
copy or set ran on the device (the union of their intervals)."""

from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
