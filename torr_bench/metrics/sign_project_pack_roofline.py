"""The encode kernel's device time in the traced slice against its launches' least time (one TF32 product at 495 TFLOP/s, or z, R and the words once at 3.35 TB/s)."""
from tbench import readings as rd


def read(ctx):
    return rd.roofline_pct(ctx, "sign_project_pack")
