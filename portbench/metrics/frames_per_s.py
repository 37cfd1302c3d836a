"""frames_per_s: interpolated frames delivered to the caller as uint8 host
arrays, over the whole timed window (all frames over all its seconds)."""


def read(run):
    w = run.window
    return w.frames / w.seconds if w.seconds > 0 and w.frames else None
