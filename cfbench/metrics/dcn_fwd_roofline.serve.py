"""Least time of the window's bf16 DCN forwards (cfbench/counting.py) over
the device time of the dcn_fwd kernels, in %."""

from cfbench.readers import DCN_FWD_KEYS, dcn_fwd_least, roofline

UNIT = "%"


def read(run, summary):
    if run.counters.get("kind") != "serve":
        return None
    return roofline(run, summary, "serve", DCN_FWD_KEYS, dcn_fwd_least(run))
