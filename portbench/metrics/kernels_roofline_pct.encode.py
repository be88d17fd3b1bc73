"""``kernels_roofline_pct.encode``: see ``portbench/readers.py`` ``kernels_roofline_pct``, in the cells whose driver is the encode one."""

from portbench.readers import kernels_roofline_pct


def read(ctx):
    return kernels_roofline_pct(ctx, "encode")
