"""flush.device_ms_per_gbase (ms/Gbase): the device time of the flush's
kernels (sort, compaction, fold: the `flush` patterns of
kernel_layers.json) in the traced window, per Gbase of input."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["bases"] <= 0:
        return None
    dev = tr.device_s("flush")
    if dev <= 0:
        return None
    return dev * 1e3 / (ctx["bases"] / 1e9)
