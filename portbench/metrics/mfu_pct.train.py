"""``mfu_pct.train``: see ``portbench/readers.py`` ``mfu_pct``, in the cells whose driver is the train one."""

from portbench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "train")
