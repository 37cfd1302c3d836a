"""Drive the program with a traffic mix: warm-up, the timed window and
the traced window, for each `mode` a traffic file may name.

* `stream`: one closed-loop call of `interpolate_stream_batched(frames,
  factor, batch)` over the pool cycled without end; the window pulls
  frames until `seconds` have passed and a batch has been delivered
  whole. Interpolated frame j lies between pool frames j and j + 1
  (mod the pool's size).
* `pair`: one client calling `interpolate(img0, img1)` on pool pair
  (i, i + 1) at its i-th call, each call timed on the host clock; a
  call that raises counts as failed, with no latency.

Both keep the latest delivery of each sampled pair for the check. Only
factor 2 is driven.
"""
from __future__ import annotations

import itertools
import math
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Window:
    frames: int = 0  # interpolated frames delivered
    seconds: float = 0.0
    failed: int = 0
    latencies_s: Optional[List[float]] = None
    samples: Dict[int, np.ndarray] = field(default_factory=dict)


def sample_pairs(traffic: dict, n: int, seed: int) -> List[int]:
    """n pool pairs drawn from the seed. In a stream, pair q always sits
    at position q mod batch of its forward (the pool is a multiple of
    the batch), so the first `batch` draws take one pair at each
    position."""
    P, B = traffic["pool"], traffic["batch"]
    rng = np.random.default_rng([abs(int(seed)), 1])
    if traffic["mode"] == "stream":
        if P % B:
            raise ValueError(f"pool {P} is not a multiple of batch {B}")
        pos = [r % B for r in range(n)]
        out: List[int] = []
        for r in pos:
            choices = [q for q in range(r, P, B) if q not in out]
            out.append(int(rng.choice(choices)))
        return out
    return [int(q) for q in rng.choice(P, size=n, replace=False)]


class StreamDrive:
    def __init__(self, pipe, pool: np.ndarray, traffic: dict):
        if traffic["factor"] != 2:
            raise ValueError("only factor 2 is driven")
        self.pipe, self.pool = pipe, pool
        self.batch = traffic["batch"]

    def _stream(self, frames):
        return self.pipe.interpolate_stream_batched(frames, 2, self.batch)

    def warmup(self) -> None:
        """Two forwards of the cell's batch and shape."""
        for _ in self._stream(list(self.pool[:2 * self.batch + 1])):
            pass

    def window(self, seconds: float, sample: List[int]) -> Window:
        P, B = self.pool.shape[0], self.batch
        want = set(sample)
        w = Window()
        gen = self._stream(itertools.cycle(self.pool))
        t0 = time.perf_counter()
        for k, out in enumerate(gen):
            if k % 2 == 0:  # the pair's first source frame
                continue
            q = (k // 2) % P
            if q in want:
                w.samples[q] = out
            w.frames += 1
            if w.frames % B == 0 and time.perf_counter() - t0 >= seconds:
                break
        w.seconds = time.perf_counter() - t0
        gen.close()
        return w

    def traced(self, steps: int) -> int:
        """`steps` forwards from the start of a new stream; returns the
        interpolated frames delivered."""
        n = 2 * steps * self.batch
        gen = self._stream(itertools.cycle(self.pool))
        for k, _ in enumerate(gen):
            if k + 1 == n:
                break
        gen.close()
        return steps * self.batch


class PairDrive:
    def __init__(self, pipe, pool: np.ndarray, traffic: dict):
        if traffic["factor"] != 2 or traffic["batch"] != 1:
            raise ValueError("a pair call is factor 2, batch 1")
        self.pipe, self.pool = pipe, pool

    def _pair(self, i: int):
        P = self.pool.shape[0]
        return self.pool[i % P], self.pool[(i + 1) % P]

    def warmup(self) -> None:
        for i in range(2):
            self.pipe.interpolate(*self._pair(i))

    def window(self, seconds: float, sample: List[int]) -> Window:
        P = self.pool.shape[0]
        want = set(sample)
        w = Window(latencies_s=[])
        t0 = time.perf_counter()
        i = 0
        while True:
            a, b = self._pair(i)
            ts = time.perf_counter()
            try:
                out = self.pipe.interpolate(a, b)
            except Exception:  # a failed call: counted, the loop goes on
                if w.failed == 0:
                    traceback.print_exc(file=sys.stderr)
                w.failed += 1
                w.latencies_s.append(math.inf)
            else:
                w.latencies_s.append(time.perf_counter() - ts)
                w.frames += 1
                if i % P in want:
                    w.samples[i % P] = out
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        w.seconds = time.perf_counter() - t0
        return w

    def traced(self, steps: int) -> int:
        for i in range(steps):
            self.pipe.interpolate(*self._pair(i))
        return steps


MODES = {"stream": StreamDrive, "pair": PairDrive}
