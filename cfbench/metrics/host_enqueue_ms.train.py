"""Host ms a step from the call of ``train_step`` to its return, before
the sync on its loss (the benchmark's span, traced window)."""

UNIT = "ms"


def read(run, summary):
    if run.counters.get("kind") != "train":
        return None
    t = run.counters.get("enqueue_s")
    return None if not t else 1e3 * sum(t) / len(t)
