"""The fused device step (candidate boxes, YOLOv8 and NMS, recogniser,
merge, caption crops): the sum of its synchronised stage laps, per
screenshot (traced run)."""

STAGES = ("candidates", "detect_nms", "recognise", "merge", "caption_crops")


def read(run):
    st = run["stage_ms"]
    if not run["shots"] or not any(k in st for k in STAGES):
        return None
    return sum(st.get(k, 0.0) for k in STAGES) / run["shots"]
