"""launches_per_frame: device kernel launches in the traced window per
interpolated frame traced (a count; it repeats exactly)."""


def read(run):
    s = run.trace
    if s is None or not run.traced_frames:
        return None
    return s["kernels"] / run.traced_frames
