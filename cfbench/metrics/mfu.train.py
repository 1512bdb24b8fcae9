"""The work the traced window's steps need, counted from shapes
(cfbench/counting.py), over the window times the card's dense bf16 peak
(989 TFLOP/s), in %."""

from cfbench.readers import mfu

UNIT = "%"


def read(run, summary):
    return mfu(run, summary, "train")
