"""The full-path scan kernel's device time against its launches' bytes at 3.35 TB/s (its 1-bit product has no published H100 rate)."""
from tbench import readings as rd


def read(ctx):
    return rd.roofline_pct(ctx, "bank_prefix_hamming")
