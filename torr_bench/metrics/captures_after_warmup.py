"""CUDA graphs the engine's graph families captured inside the measured window (0 once warmed)."""
from tbench import readings as rd


def read(ctx):
    return ctx.captures[1] - ctx.captures[0]
