"""Mean ms of the dispatcher's dispatch_enqueue span a step (the copies in, compact's host read and the graph replays, under the engine lock), from the engine's span histogram."""
from tbench import readings as rd


def read(ctx):
    return rd.span_mean_ms(ctx, "dispatch_enqueue")
