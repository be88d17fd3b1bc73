"""``step_host_ms.train``: see ``portbench/spans.py`` ``host_ms_per_call``, over the span ``speechclip.fit.step``, in the cells of kind ``train``."""

from portbench.spans import host_ms_per_call


def read(ctx):
    return host_ms_per_call(ctx, "train", "speechclip.fit.step")
