"""resolve_s (s): a warm re-solve's wall, from the call to the solution on the
host, the mean over the window's re-solves."""

from portbench.readers import mean, walls


def read(ctx):
    return mean(walls(ctx))
