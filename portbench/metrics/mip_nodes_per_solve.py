"""mip_nodes_per_solve (count): the branch and bound's nodes a MIP solve,
the root included (the program's count, ``MipResult.nodes``, which its
``mip`` record keeps too), the mean over the window's solves."""

from portbench.readers import mean


def read(ctx):
    return mean([r["nodes"] for r in ctx.records if "nodes" in r])
