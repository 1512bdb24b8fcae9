"""Host ms a batch that the serving consumer spends enqueueing its forward
(``Detector.stage_stats()["dispatch"]``, host clock, traced window)."""

UNIT = "ms"


def read(run, summary):
    st = run.counters.get("stages_ms") if run.counters.get("kind") == "serve" else None
    return None if not st or "dispatch" not in st else st["dispatch"]
