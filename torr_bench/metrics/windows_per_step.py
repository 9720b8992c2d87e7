"""Windows a step dispatched over the window: EngineStats.windows / steps (the async dispatcher's batching)."""
from tbench import readings as rd


def read(ctx):
    n = rd.counter_delta(ctx, "steps")
    return rd.counter_delta(ctx, "windows") / n if n > 0 else None
