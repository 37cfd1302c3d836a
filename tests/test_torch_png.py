"""The port's image reader takes the PNGs the JAX package's reader
takes: palette, grey + alpha (the codec decodes both) and 16-bit grey
(through Pillow where it is installed), each equal to JAX's
`read_image`; and Pillow's BILINEAR resize, ported exactly for the
Vimeo training set at scale_factor > 1."""
import numpy as np
import pytest
import torch
from PIL import Image

from atmvfi_tpu.utils.images import read_image as jread_image
from atmvfi_tpu_torch.utils import images
from atmvfi_tpu_torch.utils.resample import pillow_resize

torch.set_num_threads(2)  # the test workers share the CPU


def _pillow_png(kind, path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (32, 48, 3), dtype=np.uint8)
    if kind == "palette":
        im = Image.fromarray(rgb).convert("P")
    elif kind == "grey_alpha":
        im = Image.fromarray(rgb).convert("LA")
    else:  # 16-bit grey
        im = Image.fromarray(rgb[..., 0].astype(np.uint16) * 257)
    im.save(path)
    return path


@pytest.mark.parametrize("kind", ["palette", "grey_alpha", "grey16"])
def test_read_image_takes_the_pngs_jax_reads(tmp_path, kind):
    path = _pillow_png(kind, str(tmp_path / f"{kind}.png"))
    want = jread_image(path)
    got = images.read_image(path)
    assert got.dtype == np.uint8 and got.shape == (32, 48, 3)
    np.testing.assert_array_equal(got, want)
    if kind == "grey16":  # not the codec's: Pillow reads it
        with pytest.raises(images.UnsupportedPNG):
            images.read_png(path)
    else:  # the codec's own, with no Pillow
        np.testing.assert_array_equal(
            np.repeat(images.read_png(path)[..., :1], 3, 2)
            if kind == "grey_alpha" else images.read_png(path), want)


@pytest.mark.parametrize("src,dst", [((256, 448), (512, 896)),
                                     ((33, 47), (20, 90))])
def test_bilinear_resize_matches_pillow(src, dst):
    rng = np.random.default_rng(src[0])
    img = rng.integers(0, 256, (*src, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR))
    np.testing.assert_array_equal(
        pillow_resize(img, dst[1], dst[0], "bilinear"), want)
