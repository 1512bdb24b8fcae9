"""Host ms a batch of pre-processing: the warp (the device warp's enqueue)
and the radar rasterize rows, per image from ``Detector.stage_stats()``,
times the images of a batch (host clock, summed over the workers)."""

UNIT = "ms"


def read(run, summary):
    c = run.counters
    st = c.get("stages_ms") if c.get("kind") == "serve" else None
    if not st or "warp" not in st:
        return None
    return (st["warp"] + st.get("rasterize", 0.0)) * c["images_a_unit"]
