"""Faults planted in the program's timed path, for the readings that set
the check's limits (`calibrate.py`) and for the tests that see
`correct` come out false. Each wraps the pipeline's device forward
`interpolate_device(im0, im1) -> I_t`, which both traffic modes reach.

* `unchanged`: the step returns its input: I_t = im0;
* `half_batch`: the first half of the batch is computed and its frames
  are returned for the second half as well (a batch of 1 is left as is);
* `altered`: each answer altered where it is produced: a 64 x 64 block
  of I_t (at its centre) set to 0.
"""
from __future__ import annotations


def _wrap(pipe, fn):
    inner = pipe.interpolate_device
    pipe.interpolate_device = lambda a, b: fn(inner, a, b)


def unchanged(pipe):
    _wrap(pipe, lambda inner, a, b: a.float().clamp(0, 1))


def half_batch(pipe):
    def fn(inner, a, b):
        B = a.shape[0]
        if B < 2:
            return inner(a, b)
        h = B // 2
        y = inner(a[:h], b[:h])
        return y.repeat((B + h - 1) // h, 1, 1, 1)[:B]
    _wrap(pipe, fn)


def altered(pipe):
    def fn(inner, a, b):
        y = inner(a, b).clone()
        H, W = y.shape[1:3]
        y[:, H // 2 - 32:H // 2 + 32, W // 2 - 32:W // 2 + 32] = 0
        return y
    _wrap(pipe, fn)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}
