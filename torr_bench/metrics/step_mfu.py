"""The whole step's share of the chip's peak: the least time the window's required work needs at published peaks, over the window's length."""
from tbench import readings as rd


def read(ctx):
    return rd.step_mfu_pct(ctx)
