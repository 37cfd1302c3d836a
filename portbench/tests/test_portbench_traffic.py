"""The frame generator and the sample draw: fixed by the seed."""
import numpy as np
import pytest

from portbench import drive, frames

T = {"mode": "stream", "height": 48, "width": 80, "pool": 8, "batch": 4,
     "factor": 2, "video": {"max_speed": 4, "patch_speed": 6,
                            "noise_levels": 2.0}}


def test_pool_is_a_function_of_the_seed():
    a = frames.make_pool(T, 2 ** 31 + 7, "cpu")
    b = frames.make_pool(T, 2 ** 31 + 7, "cpu")
    c = frames.make_pool(T, 2 ** 31 + 8, "cpu")
    assert a.shape == c.shape == (8, 48, 80, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_consecutive_frames_differ_by_motion():
    p = frames.make_pool(T, 3, "cpu").astype(np.int16)
    d = np.abs(p[1:] - p[:-1]).mean(axis=(1, 2, 3))
    assert (d > 2.0).all()  # more than the sensor noise alone


@pytest.mark.parametrize("mode,batch", [("stream", 4), ("stream", 1),
                                        ("pair", 1)])
def test_sample_is_a_function_of_the_seed(mode, batch):
    t = dict(T, mode=mode, batch=batch, pool=32)
    s = drive.sample_pairs(t, 4, 2 ** 31 + 11)
    assert s == drive.sample_pairs(t, 4, 2 ** 31 + 11)
    assert len(set(s)) == 4 and all(0 <= q < 32 for q in s)
    if mode == "stream":  # one pair at each position of the batch
        assert sorted(q % batch for q in s) == sorted(r % batch
                                                      for r in range(4))
