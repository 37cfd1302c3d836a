"""device_idle_share.pair: 1 - (the union of device kernel, copy and set
intervals) / (the traced window), in %, in pair traffic."""


def read(run):
    s = run.trace
    if s is None or run.traffic["mode"] != "pair" or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
