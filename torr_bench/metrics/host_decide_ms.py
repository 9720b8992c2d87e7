"""Mean ms of the dispatcher's host_decide span (assembly under the engine lock) a step, from the engine's span histogram."""
from tbench import readings as rd


def read(ctx):
    return rd.span_mean_ms(ctx, "host_decide")
