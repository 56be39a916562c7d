"""Mean ms a request spends with the device idle inside the program's
layout spans (``lz4t.*.layout``: the input copies and the batch's rows
laid out on the host; torch.profiler)."""

from portbench.phases import idle_ms


def read(ctx):
    return idle_ms(ctx, ("layout",))
