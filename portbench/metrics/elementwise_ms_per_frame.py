"""elementwise_ms_per_frame: device ms of the elementwise / copy / reduce
family (`trace.FAMILIES`) in the traced window, per interpolated frame
traced."""


def read(run):
    s = run.trace
    if s is None or not run.traced_frames:
        return None
    return 1e3 * s["family_s"].get("elementwise / copy", 0.0) \
        / run.traced_frames
