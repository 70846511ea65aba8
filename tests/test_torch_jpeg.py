"""JPEG frames in the port: ``utils/image_io.py::read_image`` routes a file by
its signature (PNG to the port's reader, JPEG to OpenCV's ``IMREAD_UNCHANGED``
decode, anything else to imageio) and must decode every JPEG to the pixels of
the JAX package's reader (``imageio.v2.imread``, as ``smilify_tpu/data``
calls it), with 0 difference: Pillow-written RGB at quality 75 and 95, one
tagged EXIF orientation 6 (imageio does not rotate it, nor may the port) and
one grayscale.

``tests/fixtures/jpeg/`` holds those four files as :func:`write_jpeg_fixtures`
writes them, with the pixels imageio decodes from them (``pixels.npz``);
``chip_smoke.py`` holds the card's OpenCV decode to those pixels.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import pathlib
import shutil

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from smilify_tpu_torch.utils import image_io

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "jpeg"
NAMES = ("q75.jpg", "q95.jpg", "exif6.jpg", "gray.jpg")
H, W = 40, 60


def _picture(seed, channels):
    """A smooth gradient with a few edges and seeded noise, uint8 (H, W, channels)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    base = np.stack([x * 4, y * 6, (x + y) * 2], -1)[..., :channels].astype(np.float64)
    base[10:25, 20:45] = 220.0
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def write_jpeg_fixtures(folder) -> None:
    """The four JPEGs, written by Pillow."""
    folder = pathlib.Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    Image.fromarray(_picture(0, 3)).save(folder / "q75.jpg", quality=75)
    Image.fromarray(_picture(1, 3)).save(folder / "q95.jpg", quality=95)
    exif = Image.Exif()
    exif[0x0112] = 6                                     # Orientation: rotate 90° CW to view
    Image.fromarray(_picture(2, 3)).save(folder / "exif6.jpg", quality=90, exif=exif)
    Image.fromarray(_picture(3, 1)[..., 0], mode="L").save(folder / "gray.jpg", quality=90)


@pytest.mark.parametrize("name", NAMES)
def test_read_image_equals_imageio_on_pillow_jpegs(tmp_path, name):
    write_jpeg_fixtures(tmp_path)
    want = imageio.imread(tmp_path / name)
    got = image_io.read_image(tmp_path / name)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape == ((H, W) if name == "gray.jpg" else (H, W, 3))
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) == 0


@pytest.mark.parametrize("name", NAMES)
def test_committed_fixtures_are_imageio_decodes(name):
    """The committed files decode, by imageio and by the port, to the
    committed pixels; the orientation tag is really in the file."""
    want = np.load(FIXTURES / "pixels.npz")[name]
    np.testing.assert_array_equal(imageio.imread(FIXTURES / name), want)
    np.testing.assert_array_equal(image_io.read_image(FIXTURES / name), want)
    if name == "exif6.jpg":
        assert Image.open(FIXTURES / name).getexif()[0x0112] == 6


def test_route_follows_the_signature_not_the_name(tmp_path):
    """JPEG bytes under a ``.png`` name decode as JPEG, PNG bytes under a
    ``.JPG`` name (replicAnt's frame name) as PNG; another format goes to
    imageio; a file with a JPEG signature that does not decode raises."""
    write_jpeg_fixtures(tmp_path)
    shutil.copy(tmp_path / "q75.jpg", tmp_path / "frame.png")
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "frame.png"),
                                  imageio.imread(tmp_path / "q75.jpg"))
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.read_png(tmp_path / "frame.png")
    rgb = _picture(4, 3)
    image_io.write_png(tmp_path / "frame.JPG", rgb)
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "frame.JPG"), rgb)
    Image.fromarray(rgb).save(tmp_path / "frame.bmp")
    np.testing.assert_array_equal(image_io.read_image(tmp_path / "frame.bmp"), rgb)
    (tmp_path / "broken.jpg").write_bytes(image_io.JPEG_SIGNATURE + b"\x00" * 64)
    with pytest.raises(ValueError, match="could not decode"):
        image_io.read_image(tmp_path / "broken.jpg")


def test_synthetic_sequence_writes_jpeg_frames(tmp_path):
    """``write_replicant_sequence(..., image_format="jpeg")``: real JPEG bytes
    in both layouts, read back by the loaders through OpenCV."""
    import torch

    from smilify_tpu_torch.core.spec import toy_model_spec
    from smilify_tpu_torch.data.loaders import load_smil_sequence
    from smilify_tpu_torch.tools.synthetic_data import write_replicant_sequence

    spec = toy_model_spec(6, 5, 3, device="cpu")
    with torch.no_grad():
        coco, names = write_replicant_sequence(str(tmp_path / "c"), spec, 2, 32, image_format="jpeg")
        folder, _ = write_replicant_sequence(str(tmp_path / "u"), spec, 1, 32, layout="unreal",
                                             image_format="jpeg")
    assert names == ["SMIL_00_synth.jpg", "SMIL_01_synth.jpg"]
    frame = pathlib.Path(coco) / "data" / names[0]
    assert frame.read_bytes().startswith(image_io.JPEG_SIGNATURE)
    (rgb, sil, joints, _), _ = load_smil_sequence(coco, names[0], 32, spec.joint_names)
    want = (imageio.imread(frame).astype(np.float64) / 255.0).astype(np.float32)
    np.testing.assert_array_equal(rgb, want[None])
    unreal = pathlib.Path(folder) / "SMIL_synth_00.JPG"
    assert unreal.read_bytes().startswith(image_io.JPEG_SIGNATURE)
    np.testing.assert_array_equal(image_io.read_image(unreal), imageio.imread(unreal))
