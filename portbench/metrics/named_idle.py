"""Percent of the requests' device-idle time (the numerator of
``host_ms``) that falls inside one of the program's phase spans
(``lz4t.*.layout``, ``upload``, ``pass``, ``fetch``, ``unpack``,
``lz4t.stream.frame``; torch.profiler)."""

from portbench.phases import named_share


def read(ctx):
    return named_share(ctx)
