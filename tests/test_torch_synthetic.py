"""Parity of the port's synthetic multi-view generator
(smilify_tpu_torch.data.synthetic) and device data cache
(smilify_tpu_torch.train.trainer.DeviceDataCache) with the JAX package on
the CPU.

Both generators run on the toy (10, 6, 3) spec at 96², 4 views, 5 samples in
chunks of 2 (the last chunk padded), with ``keyframe_every`` 0 and 2. The
JAX function's samples are taken where it hands them to its HDF5 writer, so
its images are compared before JPEG. Tolerances: parameters exactly (numpy
draws in one order); 3D keypoints within 1e-5 (float32 SMIL forwards with
their sums in other orders, as ``test_torch_core.py``); 2D keypoints within
1e-3 px and visibility exactly; images within one level of 255 (the JAX side
renders with its all-faces oracle, the port with the plain version of K1,
which drops faces beyond the blur margin: alpha within ~1e-6, and the
quantization truncates). The caches hold the same file, read through each
package's reader, so their batches are equal exactly.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import smilify_tpu.data.hdf5_dataset as jhdf
from smilify_tpu.data import synthetic as jsyn
from smilify_tpu.train.multidevice import toy_model_spec as jax_toy_spec
from smilify_tpu.train.trainer import DeviceDataCache as JaxDeviceDataCache

from smilify_tpu_torch.core.spec import toy_model_spec
from smilify_tpu_torch.data import hdf5_dataset as thdf
from smilify_tpu_torch.data import synthetic as tsyn
from smilify_tpu_torch.train.trainer import DeviceDataCache

N_SAMPLES, CHUNK, VIEWS, RES = 5, 2, 4, 96
PARAMS = ("global_rot", "joint_rot", "betas", "trans")
KP3D_ATOL = 1e-5
KP2D_ATOL = 1e-3


def _jax_samples(monkeypatch, tmp_path, keyframe_every):
    """The JAX generator's sample dicts, caught on their way to the writer."""
    caught = {}
    real = jhdf.write_multiview_hdf5

    def catch(path, samples, **kw):
        caught["samples"] = samples
        return real(path, samples, **kw)

    monkeypatch.setattr(jhdf, "write_multiview_hdf5", catch)
    path = str(tmp_path / f"jax_kf{keyframe_every}.h5")
    jsyn.generate_synthetic_multiview(
        jax_toy_spec(10, 6, 3), path, n_samples=N_SAMPLES, n_views=VIEWS, resolution=RES,
        chunk_size=CHUNK, keyframe_every=keyframe_every)
    return caught["samples"], path


@pytest.fixture(scope="module")
def tspec():
    return toy_model_spec(10, 6, 3, device="cpu")


@pytest.mark.parametrize("keyframe_every", [0, 2])
def test_synthesize_matches_jax(monkeypatch, tmp_path, tspec, keyframe_every):
    jax_samples, _ = _jax_samples(monkeypatch, tmp_path, keyframe_every)
    ours = tsyn.synthesize_multiview(tspec, N_SAMPLES, VIEWS, RES, chunk_size=CHUNK,
                                     keyframe_every=keyframe_every, device="cpu")
    assert len(ours) == len(jax_samples) == N_SAMPLES
    covered = 0
    for j, t in zip(jax_samples, ours):
        for k in PARAMS + ("camera_intrinsics", "camera_extrinsics_R", "camera_extrinsics_t",
                           "image_sizes"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        assert t["camera_indices"] == j["camera_indices"]
        assert (t["frame_idx"], t["session_name"]) == (j["frame_idx"], j["session_name"])
        np.testing.assert_allclose(t["keypoints_3d"], j["keypoints_3d"], atol=KP3D_ATOL, rtol=0)
        np.testing.assert_allclose(t["keypoints_2d"], j["keypoints_2d"], atol=KP2D_ATOL, rtol=0)
        np.testing.assert_array_equal(t["keypoint_visibility"], j["keypoint_visibility"])
        jimg = np.stack(j["images"])
        assert t["images"].shape == jimg.shape == (VIEWS, RES, RES, 3)
        assert t["images"].dtype == np.uint8
        diff = np.abs(t["images"].astype(int) - jimg.astype(int))
        assert diff.max() <= 1
        covered += int((jimg > 0).any(-1).sum())
    assert covered > 0                       # the silhouettes are not empty


def test_draws_do_not_depend_on_chunk_size(tspec):
    """The determinism contract: the same seed gives the same parameters and
    joints for any chunk size (here 2, with a padded last chunk, and 5)."""
    a = tsyn.synthesize_multiview(tspec, N_SAMPLES, 2, 32, chunk_size=2, keyframe_every=2,
                                  render_images=False, device="cpu")
    b = tsyn.synthesize_multiview(tspec, N_SAMPLES, 2, 32, chunk_size=5, keyframe_every=2,
                                  render_images=False, device="cpu")
    for sa, sb in zip(a, b):
        for k in PARAMS:
            np.testing.assert_array_equal(sa[k], sb[k])
        np.testing.assert_allclose(sa["keypoints_3d"], sb["keypoints_3d"], atol=KP3D_ATOL, rtol=0)


def test_generated_file_reads_as_the_jax_one(monkeypatch, tmp_path, tspec):
    """The port's HDF5 against the JAX generator's, both read by the JAX
    reader: every array but the images equal within the tolerances above, the
    JPEG images within a few levels (encoded from images at most one level
    apart)."""
    _, jpath = _jax_samples(monkeypatch, tmp_path, 0)
    tpath = tsyn.generate_synthetic_multiview(tspec, str(tmp_path / "torch.h5"), N_SAMPLES,
                                              VIEWS, RES, chunk_size=CHUNK, device="cpu")
    a, b = jhdf.MultiViewHDF5Dataset(jpath), jhdf.MultiViewHDF5Dataset(tpath)
    assert a.metadata == b.metadata
    for i in range(N_SAMPLES):
        sa, sb = a[i], b[i]
        assert sa.keys() == sb.keys()
        for k in sa:
            if k == "images":
                assert np.abs(sa[k] - sb[k]).max() <= 8 / 255
            elif k in ("keypoints_3d", "keypoints_2d"):
                np.testing.assert_allclose(sb[k], sa[k], atol=KP2D_ATOL, rtol=0, err_msg=k)
            else:
                np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)


def test_device_data_cache_matches_jax(monkeypatch, tmp_path):
    _, path = _jax_samples(monkeypatch, tmp_path, 0)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jcache = JaxDeviceDataCache(jhdf.MultiViewHDF5Dataset(path), mesh)
    tcache = DeviceDataCache(thdf.MultiViewHDF5Dataset(path), device="cpu")
    assert tcache.n == jcache.n == N_SAMPLES
    assert tcache.arrays.keys() == jcache.arrays.keys()
    assert tcache.arrays["images"].dtype == torch.uint8

    def same(tb, jb):
        assert tb.keys() == jb.keys()
        for k in tb:
            j = np.asarray(jb[k])
            assert tb[k].numpy().dtype == j.dtype, k
            np.testing.assert_array_equal(tb[k].numpy(), j, err_msg=k)

    same(tcache.batch([4, 0, 2]), jcache.batch([4, 0, 2]))
    for kw in ({}, {"shuffle": False}, {"fraction": 0.6}):
        tb = list(tcache.iterate(2, np.random.default_rng(3), **kw))
        jb = list(jcache.iterate(2, np.random.default_rng(3), **kw))
        assert len(tb) == len(jb) > 0
        for x, y in zip(tb, jb):
            same(x, y)


def test_device_data_cache_over_synthesized_samples(tspec):
    """The generator's samples (uint8 images) cached directly: a batch is the
    host-side gather of the same indices, images times the float32 1/255."""
    samples = tsyn.synthesize_multiview(tspec, N_SAMPLES, 2, 32, chunk_size=CHUNK, device="cpu")
    cache = DeviceDataCache(samples, device="cpu")
    idx = [3, 1, 1]
    b = cache.batch(idx)
    want = np.stack([samples[i]["images"] for i in idx]).astype(np.float32) * np.float32(1 / 255)
    np.testing.assert_array_equal(b["images"].numpy(), want)
    np.testing.assert_array_equal(b["betas"].numpy(), np.stack([samples[i]["betas"] for i in idx]))
    np.testing.assert_array_equal(b["frame_idx"].numpy(), np.asarray(idx, np.int32))
    assert cache.bytes == sum(t.numel() * t.element_size() for t in cache.arrays.values())


def test_entry_points_default_to_cuda(tspec):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tsyn.synthesize_multiview(tspec, 2, 2, 32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceDataCache([{"x": np.zeros(3, np.float32)}])
