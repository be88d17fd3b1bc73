"""``device_idle_pct.train``: see ``portbench/readers.py`` ``device_idle_pct``, in the cells whose driver is the train one."""

from portbench.readers import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx, "train")
