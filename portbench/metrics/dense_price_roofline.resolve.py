"""dense_price_roofline.resolve (%): the least time of the dense_price launches
of the traced re-solves (A and v read once) over their device time."""

from portbench.readers import roofline
from portbench.roofline import dense_price_bytes


def read(ctx):
    return roofline(ctx, {
        "dense_price_kernel": lambda r, e: dense_price_bytes(r["m"], r["n"], e),
    })
