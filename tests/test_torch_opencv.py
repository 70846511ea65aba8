"""The OpenCV paths' reference outputs (``tools/opencv_paths.py``) that
``chip_smoke.py`` holds the card machine's OpenCV to:
``tests/fixtures/opencv_paths.npz`` is exactly what this CPU's OpenCV makes
of the seeded inputs, and each output equals the JAX package's function on
the same inputs and draws (augmentation's blur and warps, undistortion of an
image and of points)."""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import pathlib

import numpy as np
import pytest

from smilify_tpu.data import augmentation as jaug
from smilify_tpu.data import preprocess_multiview as jpm
from smilify_tpu.data import sleap as jsl

from smilify_tpu_torch.tools import opencv_paths

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "opencv_paths.npz"


@pytest.fixture(scope="module")
def outputs():
    return opencv_paths.run()


def test_fixture_is_this_cpus_output(outputs):
    import cv2

    want = np.load(FIXTURE)
    assert str(want["opencv_version"]) == cv2.__version__
    assert set(want.files) - {"opencv_version"} == set(outputs)
    for k, v in outputs.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


@pytest.mark.parametrize("part", ["blur", "warp", "undistort"])
def test_outputs_equal_the_jax_packages(outputs, part):
    img, K, kp = opencv_paths.inputs()
    if part == "blur":
        blur = jaug.AugmentationParams(gaussian_blur_prob=1.0, random_erasing_prob=0.0)
        for i in range(2):
            np.testing.assert_array_equal(
                outputs[f"blurred_{i}"],
                jaug.photometric_augment(img, np.random.default_rng((0, i)), blur))
    elif part == "warp":
        geo = jaug.AugmentationParams(geometric_enabled=True, crop_jitter_fraction=0.1)
        rng = np.random.default_rng((0, 10))
        warped, K1, kp1 = jaug.geometric_scale_jitter(img, K, rng, geo, kp)
        warped, K2, kp2 = jaug.geometric_crop_jitter(warped, K1, rng, geo, kp1)
        np.testing.assert_array_equal(outputs["warped"], warped)
        np.testing.assert_array_equal(outputs["warped_K"], K2)
        np.testing.assert_array_equal(outputs["warped_keypoints"], kp2)
        # the numpy model of the warp: exact positions (OpenCV 5) give this
        # CPU's pixels; positions rounded to 1/32 px (OpenCV 4) move them
        M1, M2 = outputs["warp_matrices"]
        model = opencv_paths.warp_affine_reference
        exact = model(model(img, M1), M2)
        assert 255 * np.abs(exact - warped).max() <= 1e-2
        rounded = model(model(img, M1, 5), M2, 5)
        assert 255 * np.abs(rounded - warped).max() > 1.0
    else:
        und, kp_u = jpm.undistort_view(np.round(img * 255).astype(np.uint8), kp, K,
                                       opencv_paths.DIST)
        np.testing.assert_array_equal(outputs["undistorted"], und)
        np.testing.assert_array_equal(outputs["undistorted_keypoints"], kp_u)
        cam = jsl.CameraCalibration("cam_0", (opencv_paths.W, opencv_paths.H), K,
                                    opencv_paths.DIST, np.zeros(3), np.zeros(3))
        np.testing.assert_array_equal(outputs["calibration_undistorted_points"],
                                      cam.undistort_points(kp))
        assert np.abs(kp_u - kp).max() > 0.1          # the distortion is not negligible
