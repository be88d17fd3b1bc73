"""``layers_device_pct.encode``: see ``portbench/spans.py`` ``device_pct``, over the span ``speechclip.hubert.layers``, in the cells of kind ``encode``."""

from portbench.spans import device_pct


def read(ctx):
    return device_pct(ctx, "encode", "speechclip.hubert.layers")
