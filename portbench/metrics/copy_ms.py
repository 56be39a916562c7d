"""Mean ms a request spends with the device idle inside the program's
upload and fetch spans (``lz4t.*.upload``, ``lz4t.*.fetch``: staging
the rows to the card and the answers back, the fetch's wait for the
pass included; torch.profiler)."""

from portbench.phases import idle_ms


def read(ctx):
    return idle_ms(ctx, ("upload", "fetch"))
