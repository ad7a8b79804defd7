"""update_kernel_share (%): the share of the traced re-solves' dual
iterations whose update ran the program's ``dual_update`` kernel, replayed
or eager: the records' ``update_kernel_steps`` over their ``iterations``.  A
program whose records keep no such counter gives None."""

from portbench.readers import ratio
from portbench.spans import traced_resolves


def read(ctx):
    recs = traced_resolves(ctx)
    if recs is None or any(getattr(r, "update_kernel_steps", None) is None for r in recs):
        return None
    return ratio(sum(r.update_kernel_steps for r in recs), sum(r.iterations for r in recs), 100.0)
