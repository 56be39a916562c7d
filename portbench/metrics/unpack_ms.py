"""Mean ms a request spends with the device idle inside the program's
unpack and stream-framing spans (``lz4t.*.unpack``: payloads cut to
bytes, cap checks, host fallbacks; ``lz4t.stream.frame``: the stream's
copies, varints and writes; torch.profiler)."""

from portbench.phases import idle_ms


def read(ctx):
    return idle_ms(ctx, ("unpack", "frame"))
