"""Least time of the window's bf16 DCN backwards (cfbench/counting.py:
the op's inputs and outputs once, its two contractions at the bf16 peak)
over the device time of every kernel their autograd node launched, in %. A
frozen step runs none: nothing to read."""

from cfbench.readers import DCN_BWD_OP, dcn_bwd_least, roofline

UNIT = "%"


def read(run, summary):
    if run.counters.get("kind") != "train":
        return None
    return roofline(run, summary, "train", (), dcn_bwd_least(run),
                    op=DCN_BWD_OP)
