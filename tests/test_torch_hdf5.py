"""The port's HDF5 codec (smilify_tpu_torch/utils/hdf5_io.py) against h5py
and the JAX package on the CPU.

* The committed fixtures (tests/fixtures/hdf5/: files that h5py and the JAX
  package wrote, and expected.npz, what h5py reads from each) read through
  the codec equal their expected contents bit for bit, dtypes, shapes and
  attribute types included; the generator below, run again, still writes
  what the .npz holds. To write them anew (this box's h5py and OpenCV):
  ``JAX_PLATFORMS=cpu python -c "import tests.test_torch_hdf5 as t; t.regenerate()"``.
* Both directions: a property test draws trees of groups (up to 40 links),
  datasets and attributes over the writer's types and writes each tree with
  the codec and with h5py; either library reads either file to the same
  contents.
* The JAX package's dataset classes read the port's stores and the port's
  read the JAX package's, sample for sample at 0 difference, the JPEG bytes
  included.
* Each feature the codec refuses raises NotImplementedError naming it.
* tools/synthetic_data.py::write_sleap_session (the codec's SLEAP files)
  holds the SLEAP files that test_torch_data.py writes with h5py, and the
  JAX preprocess_sleap_multiview on it equals the port's.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import json
import os
import pickle
import string
import time

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from smilify_tpu.cli import preprocess_sleap_multiview as jsleapmv_cli
from smilify_tpu.data import hdf5_dataset as jh5
from smilify_tpu.data import sleap as jsl

from smilify_tpu_torch.cli import preprocess_sleap_multiview as tsleapmv_cli
from smilify_tpu_torch.core.spec import load_model_spec, toy_model_spec
from smilify_tpu_torch.data import hdf5_dataset as th5
from smilify_tpu_torch.tools import hdf5_fixtures
from smilify_tpu_torch.tools.synthetic_data import write_model_pkl, write_sleap_session
from smilify_tpu_torch.utils import hdf5_io
from tests.test_torch_data import NODES, _write_session
from tests.test_torch_data_cli import assert_same_h5

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "hdf5")


# ---------------------------------------------------------------------------
# the fixtures
# ---------------------------------------------------------------------------


def _image(rng, size):
    """A smooth RGB image (small as a JPEG): a gradient and a disc."""
    y, x = np.mgrid[:size, :size] / size
    c = rng.uniform(0.2, 0.8, 2)
    disc = ((y - c[0]) ** 2 + (x - c[1]) ** 2 < 0.05)
    img = np.stack([x, y, 1 - x], -1) * 200 + disc[..., None] * rng.uniform(0, 55, 3)
    return img.astype(np.uint8)


def _multiview_samples(rng, K=6, views=(18, 6, 3, 1)):
    samples = []
    for i, nv in enumerate(views):
        samples.append({
            "images": [_image(rng, 32) for _ in range(nv)],
            "camera_indices": list(range(18 - nv, 18)),
            "camera_names": [f"cam{c}" for c in range(18 - nv, 18)],
            "keypoints_2d": rng.uniform(0, 32, (nv, K, 2)).astype(np.float32),
            "keypoint_visibility": (rng.uniform(size=(nv, K)) > 0.3).astype(np.float32),
            "camera_intrinsics": np.tile(np.diag([40.0, 40.0, 1.0]), (nv, 1, 1)).astype(np.float32),
            "camera_extrinsics_R": np.tile(np.eye(3), (nv, 1, 1)).astype(np.float32),
            "camera_extrinsics_t": rng.normal(0, 1, (nv, 3)).astype(np.float32),
            "image_sizes": np.full((nv, 2), 32, np.int32),
            "keypoints_3d": rng.normal(0, 1, (K, 3)).astype(np.float32) if i % 2 == 0 else None,
            "global_rot": rng.normal(0, 1, 3).astype(np.float32),
            "joint_rot": rng.normal(0, 1, (5, 3)).astype(np.float32),
            "betas": rng.normal(0, 1, 3).astype(np.float32) if i < 3 else None,
            "trans": rng.normal(0, 1, 3).astype(np.float32),
            "session_name": f"session_{i % 2}",
            "frame_idx": 10 * i,
        })
    return samples


def _singleview_samples(rng, K=6, n=3):
    return [{
        "image": _image(rng, 32),
        "keypoints_2d": rng.uniform(0, 1, (K, 2)).astype(np.float32),
        "keypoint_visibility": np.ones(K, np.float32),
        "global_rot": rng.normal(0, 1, 3), "joint_rot": rng.normal(0, 1, (5, 3)),
        "betas": rng.normal(0, 1, 3), "trans": rng.normal(0, 1, 3), "fov": [45.0],
        "cam_rot": np.eye(3).reshape(-1), "cam_trans": [0.0, 0.0, 3.0],
        "silhouette": (_image(rng, 32)[..., 0] > 128).astype(np.float32),
        "session_name": f"séance_{i}", "camera_name": f"cam{i}", "frame_idx": i,
        "keypoints_3d_sleap": rng.normal(0, 1, (K, 3)).astype(np.float32),
    } for i in range(n)]


def write_fixtures(d):
    """The fixtures, written by h5py and the JAX package into ``d``."""
    rng = np.random.default_rng(2026)
    os.makedirs(d, exist_ok=True)
    jh5.write_multiview_hdf5(os.path.join(d, "multiview18.h5"), _multiview_samples(rng), 18, 32,
                             [f"cam{c}" for c in range(18)], 5, 3, jpeg_quality=50,
                             extra_metadata={"source": "fixture", "scale": 0.5})
    jh5.write_singleview_hdf5(os.path.join(d, "singleview.h5"), _singleview_samples(rng), 32, 5, 3)
    F, K = 23, 4
    tracks = rng.uniform(0, 60, (1, 2, K, F))
    tracks[0, :, 1, 3:6] = np.nan
    with h5py.File(os.path.join(d, "analysis.h5"), "w") as f:       # SLEAP's analysis export
        f.create_dataset("tracks", data=tracks, chunks=(1, 2, K, 8), compression="gzip",
                         compression_opts=1, shuffle=True, fletcher32=True)
        f["track_occupancy"] = np.ones((F, 1), np.uint8)
        f["point_scores"] = rng.uniform(0, 1, (1, K, F))
        f["instance_scores"] = rng.uniform(0, 1, (1, F))
        f["track_names"] = np.asarray([b"track_0"])
        f["node_names"] = np.asarray([n.encode() for n in NODES])
        f["edge_names"] = np.asarray([[b"Head", b"Thorax"], [b"Thorax", b"tail_tip"]])
        f["edge_inds"] = np.asarray([[0, 1], [1, 2]])
        f["labels_path"] = "labels.v001.slp"
        f["provenance"] = json.dumps({"sleap_version": "1.3.3"})
    with h5py.File(os.path.join(d, "session.slp"), "w") as f:        # a .slp's tables
        meta = f.create_group("metadata")
        meta.attrs["format_id"] = 1.2
        meta.attrs["json"] = json.dumps({
            "skeletons": [{"nodes": [{"id": 10 + k} for k in range(K)],
                           "links": [{"source": 10, "target": 11}]}],
            "nodes": [{"id": 10 + k, "name": n} for k, n in enumerate(NODES)]})
        frames = np.zeros(F, [("frame_id", "<u8"), ("video", "<u4"), ("frame_idx", "<u8"),
                              ("instance_id_start", "<u8"), ("instance_id_end", "<u8")])
        frames["frame_id"] = frames["frame_idx"] = np.arange(F)
        frames["instance_id_start"], frames["instance_id_end"] = np.arange(F), np.arange(1, F + 1)
        f.create_dataset("frames", data=frames, maxshape=(None,), chunks=(8,))
        inst = np.zeros(F, [("instance_id", "<i8"), ("instance_type", "u1"), ("frame_id", "<u8"),
                            ("track", "<i4"), ("score", "<f4"), ("point_id_start", "<u8"),
                            ("point_id_end", "<u8")])
        inst["instance_id"] = inst["frame_id"] = np.arange(F)
        inst["point_id_start"], inst["point_id_end"] = K * np.arange(F), K * np.arange(1, F + 1)
        inst["score"] = rng.uniform(0, 1, F)
        f["instances"] = inst
        pts = np.zeros(F * K, [("x", "<f8"), ("y", "<f8"), ("visible", "?"), ("complete", "?"),
                               ("score", "<f8")])
        pts["x"], pts["y"] = rng.uniform(0, 60, F * K), rng.uniform(0, 60, F * K)
        pts["visible"] = rng.uniform(size=F * K) > 0.2
        pts["score"] = rng.uniform(0, 1, F * K)
        f["pred_points"] = pts
        f["videos_json"] = np.asarray([json.dumps({"filename": "cam0.mp4"})],
                                      dtype=h5py.string_dtype())
    jsl.write_points3d_h5(os.path.join(d, "points3d.h5"), rng.normal(0, 1, (F, K, 3)),
                          {"unit": "m", "n_cameras": 3, "cameras": ["a", "b", "c"]})
    with h5py.File(os.path.join(d, "latest.h5"), "w", libver="latest") as f:
        g = f.create_group("group")
        g["ints"] = np.arange(12, dtype=">i4").reshape(3, 4)
        g["names"] = np.asarray(["α", "beta"], dtype=h5py.string_dtype())
        g.attrs["note"] = "latest format"
        g.attrs["flags"] = np.asarray([True, False, True])
        f["floats"] = rng.normal(0, 1, (2, 3)).astype(np.float32)
        f["scalar"] = np.int16(-7)
        f["vlen"] = np.asarray([np.arange(3, dtype=np.uint8), np.zeros(0, np.uint8)],
                               dtype=h5py.vlen_dtype(np.uint8))
        f.attrs["created_by"] = "h5py"


def regenerate(d=FIXTURES):
    """The fixtures and expected.npz (what h5py reads from them) in ``d``."""
    write_fixtures(d)
    flat = {}
    for name in hdf5_fixtures.FIXTURES:
        flat.update(_flat(os.path.join(d, name), h5py.File, name))
    hdf5_fixtures.save_expected(os.path.join(d, "expected.npz"), flat)


def _expected():
    return hdf5_fixtures.load_expected(os.path.join(FIXTURES, "expected.npz"))


def _flat(path, opener, name):
    with opener(path, "r") as f:
        return {f"{name}:{k}": v for k, v in hdf5_fixtures.contents(f).items()}


def test_codec_reads_the_committed_fixtures():
    assert hdf5_fixtures.check(FIXTURES) == {name: [] for name in hdf5_fixtures.FIXTURES}
    size = sum(os.path.getsize(os.path.join(FIXTURES, n)) for n in os.listdir(FIXTURES))
    assert size < 200_000


def test_fixture_generator_writes_what_the_npz_holds(tmp_path):
    """The generator, run again with h5py, writes files whose contents
    (read by h5py and by the codec) are the committed .npz's."""
    write_fixtures(str(tmp_path))
    want = _expected()
    for name in hdf5_fixtures.FIXTURES:
        mine = {k: v for k, v in want.items() if k.startswith(f"{name}:")}
        assert mine, name
        for opener in (h5py.File, hdf5_io.File):
            got = _flat(str(tmp_path / name), opener, name)
            assert hdf5_fixtures.differences(got, mine) == [], (name, opener)


def test_fixtures_values_as_h5py_returns_them():
    """A few of the fixtures' values, by type, as the port's callers meet them."""
    with hdf5_io.File(os.path.join(FIXTURES, "multiview18.h5")) as f:
        assert f["multiview_images/view_mask"].dtype == np.bool_
        assert f["multiview_images/view_mask"][:].sum(1).tolist() == [18, 6, 3, 1]
        assert isinstance(f["metadata"].attrs["is_multiview"], np.bool_)
        assert isinstance(f["metadata"].attrs["dataset_type"], str)
        assert isinstance(f["metadata"].attrs["num_samples"], np.int64)
        assert f["auxiliary/session_name"].dtype.metadata == {"vlen": bytes}
        assert f["auxiliary/session_name"][1] == b"session_1"
        jpeg = f["multiview_images/image_jpeg_view_17"]
        assert jpeg.dtype.metadata["vlen"] == np.uint8 and len(jpeg) == 4
        assert jpeg[0][:3].tolist() == [0xFF, 0xD8, 0xFF] and jpeg[np.array([0, 2])].shape == (2,)
        assert jpeg[3].size == 0                                           # an absent view
        assert sorted(f.keys()) == list(f.keys())
    with hdf5_io.File(os.path.join(FIXTURES, "analysis.h5")) as f:
        assert f["tracks"].chunks == (1, 2, 4, 8)
        assert f["node_names"][:].dtype == np.dtype("S8")
        assert f["labels_path"][()] == b"labels.v001.slp"
        assert np.isnan(f["tracks"][0, :, 1, 3:6]).all()
    with hdf5_io.File(os.path.join(FIXTURES, "session.slp")) as f:
        assert f["pred_points"].dtype.names == ("x", "y", "visible", "complete", "score")
        assert f["pred_points"].dtype["visible"] == np.bool_
        assert json.loads(f["metadata"].attrs["json"])["nodes"][0]["name"] == NODES[0]
    with hdf5_io.File(os.path.join(FIXTURES, "latest.h5")) as f:
        assert f["group/names"][0] == "α".encode()
        assert f["group/ints"].dtype == np.dtype(">i4")
        assert f["scalar"][()] == -7 and isinstance(f["scalar"][()], np.int16)


# ---------------------------------------------------------------------------
# both directions, on drawn trees
# ---------------------------------------------------------------------------

_NAMES = st.text(string.ascii_letters + string.digits + "_-.", min_size=1, max_size=8).filter(
    lambda s: s.strip("."))
_TEXT = st.text(st.characters(blacklist_characters="\0", blacklist_categories=("Cs",)),
                max_size=6)
_ASCII = st.text(string.printable, max_size=6).map(str.encode)
_NUMERIC = st.sampled_from(["i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8", "f2", "f4", "f8",
                            "?", ">i4", ">f8"])
_SHAPES = hnp.array_shapes(min_dims=0, max_dims=3, min_side=0, max_side=4)
_COMPOUND = np.dtype([("a", "<i4"), ("b", "<f8"), ("c", "?"), ("d", "u1")])


def _object_array(items, dtype):
    arr = np.empty(len(items), dtype)
    for i, x in enumerate(items):
        arr[i] = x
    return arr


_DATA = st.one_of(
    hnp.arrays(_NUMERIC, _SHAPES),
    st.sampled_from([1, 3, 7]).flatmap(lambda n: hnp.arrays(
        f"S{n}", _SHAPES, elements=st.binary(max_size=n).map(lambda b: b.replace(b"\0", b"x")))),
    st.lists(_TEXT, max_size=5).map(lambda xs: np.asarray(xs, dtype=hdf5_io.string_dtype())),
    st.lists(hnp.arrays(np.uint8, st.integers(0, 40)), max_size=4).map(
        lambda xs: _object_array(xs, hdf5_io.vlen_dtype(np.uint8))),
    hnp.arrays(_COMPOUND, st.integers(0, 3)),
    st.lists(_ASCII, min_size=1, max_size=4),                  # h5py: variable-length ASCII
    _TEXT,                                                     # a scalar string dataset
)
_ATTR = st.one_of(
    st.integers(-2 ** 63, 2 ** 63 - 1), st.floats(), st.booleans(), _TEXT, _ASCII,
    st.lists(st.integers(-1000, 1000), max_size=3), st.lists(_TEXT, min_size=1, max_size=3),
    st.just([]), hnp.arrays(_NUMERIC, hnp.array_shapes(min_dims=0, max_dims=2, max_side=3)),
    hnp.from_dtype(np.dtype("f4")), hnp.from_dtype(np.dtype("i2")),
)
_ATTRS = st.dictionaries(_NAMES, _ATTR, max_size=12)


def _dataset():
    return st.tuples(st.just("dataset"), _DATA, _ATTRS)


_TREE = st.recursive(
    _dataset(),
    lambda kids: st.tuples(st.just("group"), st.dictionaries(_NAMES, kids, max_size=40), _ATTRS),
    max_leaves=60,
)


def _write_tree(f, node):
    """One tree through the h5py API (h5py's File or the codec's)."""
    _, members, attrs = node
    for k, v in attrs.items():
        f.attrs[k] = v
    for name, (kind, body, a) in members.items():
        if kind == "group":
            _write_tree(f.create_group(name), (kind, body, a))
        else:
            ds = f.create_dataset(name, data=body)
            for k, v in a.items():
                ds.attrs[k] = v


@settings(max_examples=25, deadline=None, database=None, suppress_health_check=list(HealthCheck))
@given(members=st.dictionaries(_NAMES, _TREE, max_size=40), attrs=_ATTRS)
def test_codec_and_h5py_read_each_others_files(tmp_path_factory, members, attrs):
    d = tmp_path_factory.mktemp("tree")
    tree = ("group", members, attrs)
    paths = {"h5py": str(d / "h5py.h5"), "codec": str(d / "codec.h5")}
    with h5py.File(paths["h5py"], "w") as f:
        _write_tree(f, tree)
    with hdf5_io.File(paths["codec"], "w") as f:
        _write_tree(f, tree)
    want = _flat(paths["h5py"], h5py.File, "t")
    for writer, path in paths.items():
        for opener in (h5py.File, hdf5_io.File):
            got = _flat(path, opener, "t")
            assert hdf5_fixtures.differences(got, want) == [], (writer, opener)


def test_writer_raises_as_h5py_does(tmp_path):
    with hdf5_io.File(str(tmp_path / "w.h5"), "w") as f:
        for bad in ({"a": 1}, np.asarray(["unicode"]), np.zeros(2, object)):
            with pytest.raises(TypeError):
                f.attrs["x"] = bad
            with pytest.raises(TypeError):
                f.create_dataset("x", data=bad)
        f.create_group("g")
        with pytest.raises(ValueError, match="already exists"):
            f.create_group("g")
        f["g/sub/x"] = 1                                         # intermediate groups
        assert "g/sub/x" in f and "g/sub" in f and "nope" not in f
        with pytest.raises(NotImplementedError, match="dense attribute storage"):
            f.attrs["huge"] = np.zeros(10_000)


def test_file_api(tmp_path):
    p = str(tmp_path / "a.h5")
    with hdf5_io.File(p, "w") as f:
        ds = f.create_dataset("v", shape=(3,), dtype=hdf5_io.vlen_dtype(np.uint8))
        ds[1] = np.arange(5)
        f.create_dataset("z", shape=(2, 2), dtype="i2")
        f["m"] = np.arange(12.0).reshape(3, 4)
        f["m"].attrs["unit"] = "mm"
    with hdf5_io.File(p) as f:
        assert [x.tolist() for x in f["v"][:]] == [[], [0, 1, 2, 3, 4], []]
        assert f["z"][()].dtype == np.int16 and not f["z"][()].any()
        m = f["m"]
        np.testing.assert_array_equal(m[1:, ::2], np.arange(12.0).reshape(3, 4)[1:, ::2])
        np.testing.assert_array_equal(m[np.array([0, 2]), 1], [1.0, 9.0])
        assert m[2, 3] == 11.0 and m[...].shape == (3, 4) and len(m) == 3 and m.size == 12
        assert f.get("nope") is None and isinstance(f.get("m"), hdf5_io.Dataset)
        names = []
        f.visititems(lambda n, o: names.append((n, type(o).__name__)))
        assert names == [("m", "Dataset"), ("v", "Dataset"), ("z", "Dataset")]
        assert m.attrs.get("unit") == "mm" and m.attrs.get("none", 3) == 3
        back = pickle.loads(pickle.dumps(f))                 # by path, reopened when read
        assert back.filename == p and back["m"][0, 1] == 1.0
        back.close()
        with pytest.raises(OSError, match="read-only"):
            f.attrs["x"] = 1
    for mode in ("r+", "a", "x"):
        with pytest.raises(NotImplementedError, match=repr(mode)):
            hdf5_io.File(p, mode)


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------


def _refused(tmp_path, name, write, what, path="x"):
    p = str(tmp_path / f"{name}.h5")
    write(p)
    with pytest.raises(NotImplementedError, match=what):
        with hdf5_io.File(p) as f:
            obj = f[path]
            obj.attrs.keys()
            obj.keys() if isinstance(obj, hdf5_io.Group) else obj[()]


def test_refusals_name_the_feature(tmp_path):
    def latest(fill):
        def write(p):
            with h5py.File(p, "w", libver="latest") as f:
                fill(f)
        return write

    def plain(fill, **kw):
        def write(p):
            with h5py.File(p, "w", **kw) as f:
                fill(f)
        return write

    def many_links(f):
        g = f.create_group("x")
        for i in range(12):
            g[f"d{i}"] = i

    def many_attrs(f):
        f["x"] = 1
        for i in range(12):
            f["x"].attrs[f"a{i}"] = i

    cases = [
        ("dense_links", latest(many_links), "dense link storage"),
        ("dense_attrs", latest(many_attrs), "dense attribute storage"),
        ("v4_chunks", latest(lambda f: f.create_dataset("x", data=np.arange(10), chunks=(5,))),
         "layout-v4 chunk index"),
        ("lzf", plain(lambda f: f.create_dataset("x", data=np.arange(10), compression="lzf")),
         "lzf"),
        ("soft", plain(lambda f: f.__setitem__("x", h5py.SoftLink("/y"))), "soft link"),
        ("external", plain(lambda f: f.__setitem__("x", h5py.ExternalLink("o.h5", "/y"))),
         "external link"),
        ("committed", plain(lambda f: f.__setitem__("x", np.dtype("f4"))), "committed datatype"),
        ("reference", plain(lambda f: f.create_dataset("x", shape=(1,), dtype=h5py.ref_dtype)),
         "reference"),
        ("opaque", plain(lambda f: f.create_dataset("x", data=np.zeros(2, "V3"))), "opaque"),
    ]
    for name, write, what in cases:
        _refused(tmp_path, name, write, what)
    p = str(tmp_path / "userblock.h5")
    with h5py.File(p, "w", userblock_size=512) as f:
        f["x"] = 1
    with pytest.raises(NotImplementedError, match="user block"):
        hdf5_io.File(p)["x"]


def test_fletcher32_is_verified(tmp_path):
    p = str(tmp_path / "f.h5")
    with h5py.File(p, "w") as f:
        f.create_dataset("x", data=np.arange(1000, dtype="<i4"), chunks=(500,), fletcher32=True)
    with hdf5_io.File(p) as f:
        np.testing.assert_array_equal(f["x"][:], np.arange(1000))
    raw = bytearray(open(p, "rb").read())
    at = raw.find(np.arange(500, 510, dtype="<i4").tobytes())
    raw[at] ^= 1                                              # one bit of the second chunk
    open(p, "wb").write(bytes(raw))
    with hdf5_io.File(p) as f, pytest.raises(ValueError, match="fletcher32"):
        f["x"][:]
    for data in (b"", b"a", b"abc", bytes(range(256)) * 20):
        # HDF5's definition, word by word (H5_checksum_fletcher32)
        s1 = s2 = 0
        words = [data[i] << 8 | data[i + 1] for i in range(0, len(data) - 1, 2)]
        for start in range(0, len(words), 360):
            for w in words[start:start + 360]:
                s1 += w
                s2 += s1
            s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
        if len(data) % 2:
            s1 += data[-1] << 8
            s2 += s1
            s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
        s1, s2 = (s1 & 0xFFFF) + (s1 >> 16), (s2 & 0xFFFF) + (s2 >> 16)
        assert hdf5_io.fletcher32(data) == s2 << 16 | s1


# ---------------------------------------------------------------------------
# the stores across the two packages
# ---------------------------------------------------------------------------


def _assert_samples_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


def test_stores_read_across_packages(tmp_path):
    rng = np.random.default_rng(5)
    mv, sv = _multiview_samples(rng, views=(3, 2, 1)), _singleview_samples(rng)
    paths = {}
    for name, mod in (("jax", jh5), ("torch", th5)):
        paths[name, "mv"] = str(tmp_path / f"{name}_mv.h5")
        mod.write_multiview_hdf5(paths[name, "mv"], mv, 3, 32, ["a", "b", "c"], 5, 3)
        paths[name, "sv"] = str(tmp_path / f"{name}_sv.h5")
        mod.write_singleview_hdf5(paths[name, "sv"], sv, 32, 5, 3)
    for kind in ("mv", "sv"):
        assert_same_h5(paths["torch", kind], paths["jax", kind])
    for col in ("multiview_images/image_jpeg_view_0", "multiview_images/image_jpeg_view_2"):
        with hdf5_io.File(paths["jax", "mv"]) as t, h5py.File(paths["torch", "mv"]) as j:
            for i in range(3):
                assert t[col][i].tobytes() == j[col][i].tobytes()
    for (jcls, tcls, kw, kind) in (
            (jh5.MultiViewHDF5Dataset, th5.MultiViewHDF5Dataset, {}, "mv"),
            (jh5.MultiViewHDF5Dataset, th5.MultiViewHDF5Dataset,
             {"return_single_view": True, "expand_all_views": True}, "mv"),
            (jh5.SingleViewHDF5Dataset, th5.SingleViewHDF5Dataset, {}, "sv")):
        # the JAX package's class on the port's file, the port's on the JAX package's
        j_on_t, t_on_j = jcls(paths["torch", kind], **kw), tcls(paths["jax", kind], **kw)
        t_on_t = tcls(paths["torch", kind], **kw)
        assert len(j_on_t) == len(t_on_j) == len(t_on_t)
        for i in range(len(t_on_j)):
            _assert_samples_equal(j_on_t[i], t_on_j[i])
            _assert_samples_equal(t_on_t[i], t_on_j[i])


# ---------------------------------------------------------------------------
# the SLEAP session the card writes
# ---------------------------------------------------------------------------


def test_write_sleap_session_matches_h5py_session_and_jax_preprocessing(tmp_path):
    ours = write_sleap_session(str(tmp_path / "codec" / "sess"))
    ref = _write_session(str(tmp_path / "h5py" / "sess"))
    for name in ("cam0.analysis.h5", "cam1.slp"):
        a, b = (os.path.join(d, name) for d in (ours, ref))
        assert hdf5_fixtures.differences(_flat(a, h5py.File, name), _flat(b, h5py.File, name)) == []
    for name in ("calibration.toml", "cam0.avi", "cam1.avi"):
        assert open(os.path.join(ours, name), "rb").read() == open(os.path.join(ref, name), "rb").read()
    pkl = write_model_pkl(str(tmp_path / "toy.pkl"), toy_model_spec(8, 6, 3, device="cpu"))
    names = list(load_model_spec(pkl, align_symmetry=False, device="cpu").joint_names)
    lookup = tmp_path / "lookup.csv"
    lookup.write_text("sleap_name,model_name\n" + "".join(
        f"{n},{names[i + 1]}\n" for i, n in enumerate(NODES[:3])) + f"{NODES[3]},\n")
    outs = {}
    for name, cli in (("jax", jsleapmv_cli), ("torch", tsleapmv_cli)):
        outs[name] = str(tmp_path / f"{name}.h5")
        cli.main(["--sessions", ours, "--output", outs[name], "--model", pkl,
                  "--joint-lookup", str(lookup), "--resolution", "32", "--crop-mode", "centred",
                  "--min-views", "1"])
    assert_same_h5(outs["torch"], outs["jax"])
    ds = th5.MultiViewHDF5Dataset(outs["torch"])
    assert len(ds) > 0 and ds[0]["images"].shape[1:] == (32, 32, 3)


def test_port_reader_same_samples_through_codec_and_h5py(tmp_path):
    """The port's reader gives the same samples from a store opened by the
    codec as by h5py; the time each takes on this CPU is printed (``-s``),
    for the records only."""
    rng = np.random.default_rng(9)
    p = str(tmp_path / "mv.h5")
    th5.write_multiview_hdf5(p, _multiview_samples(rng, views=(4,) * 32), 4, 32,
                             ["a", "b", "c", "d"], 5, 3)
    times, samples = {}, {}
    for name, opener in (("codec", hdf5_io.File), ("h5py", h5py.File)):
        ds = th5.MultiViewHDF5Dataset(p)
        ds._file = opener(p, "r")
        t0 = time.perf_counter()
        samples[name] = [ds[i] for i in range(len(ds))]
        times[name] = time.perf_counter() - t0
        ds.close()
    print(f"read 32 samples x 4 views at 32^2: codec {times['codec'] * 1e3:.1f} ms, "
          f"h5py {times['h5py'] * 1e3:.1f} ms (this CPU)")
    assert len(samples["codec"]) == 32
    for a, b in zip(samples["codec"], samples["h5py"]):
        _assert_samples_equal(a, b)
