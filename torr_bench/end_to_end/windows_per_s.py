"""Windows delivered inside the measured window, over its seconds (every card's together)."""
from tbench import readings as rd


def read(ctx):
    return len(rd.resolved_in_window(ctx)) / ctx.seconds
