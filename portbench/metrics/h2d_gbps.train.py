"""``h2d_gbps.train``: see ``portbench/spans.py`` ``counter_gbps``, the counter ``speechclip.h2d.bytes`` over the span ``speechclip.fit.h2d``, in the cells of kind ``train``."""

from portbench.spans import counter_gbps


def read(ctx):
    return counter_gbps(ctx, "train", "speechclip.h2d.bytes", "speechclip.fit.h2d")
