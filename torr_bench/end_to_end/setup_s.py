"""Process start to the first timed window: imports, the kernels' load (their build on a checkout's first run), the inputs from the seed, the engine built and its graphs captured, and the warm-up traffic."""
from tbench import readings as rd


def read(ctx):
    return ctx.setup_s
