"""mfu: the counted tensor-core time of the frames completed in the timed
window, over the window's seconds, in %. One frame's time is its
forward's bf16 product FLOPs at the chip's bf16 peak plus its f32
product FLOPs at the f32 peak, counted on the reference forward at the
cell's padded shape (`counts/`)."""


def read(run):
    c, p, w = run.counts, run.peaks, run.window
    if c is None or p is None or w.seconds <= 0 or not w.frames:
        return None
    t = (c["tc_bf16_flops"] / (p["tflops_bf16"] * 1e12)
         + c["tc_f32_flops"] / (p["tflops_f32"] * 1e12)) / c["pairs"]
    return 100.0 * w.frames * t / w.seconds
