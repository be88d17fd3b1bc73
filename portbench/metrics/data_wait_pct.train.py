"""``data_wait_pct.train``: see ``portbench/readers.py`` ``data_wait_pct``, in the cells whose driver is the train one."""

from portbench.readers import data_wait_pct


def read(ctx):
    return data_wait_pct(ctx, "train")
