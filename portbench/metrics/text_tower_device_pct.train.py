"""``text_tower_device_pct.train``: see ``portbench/spans.py`` ``device_pct``, over the span ``speechclip.cascaded.text``, in the cells of kind ``train``."""

from portbench.spans import device_pct


def read(ctx):
    return device_pct(ctx, "train", "speechclip.cascaded.text")
