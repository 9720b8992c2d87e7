"""Mean ms of the collector's device_step span: its wait for a step's event, from the moment it takes the step off the pipeline's queue (not from the step's dispatch)."""
from tbench import readings as rd


def read(ctx):
    return rd.span_mean_ms(ctx, "device_step")
