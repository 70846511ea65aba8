"""The port's YAML reader (``smilify_tpu_torch/utils/yaml_io.py``) against
PyYAML 6, which the test CPU has and the port does not import.

* Stage-like trees drawn by hypothesis, written by ``yaml.safe_dump`` in
  block and flow style (narrow widths fold long scalars and flow collections
  across lines), read back by both: the same values, types and key order.
* The resolver's traps, one table: booleans, nulls, octal, hex, binary,
  sexagesimal, the floats that need a dot, ``.inf`` and ``.nan``.
* Every refused construct raises ``NotImplementedError`` naming it.
* ``cli/optimise_3d.py::load_stages_from_yaml`` equals the JAX package's on
  the same files.
"""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import io
import math

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from smilify_tpu_torch.utils.yaml_io import safe_load

SETTINGS = settings(max_examples=150, deadline=None, database=None,
                    suppress_health_check=[HealthCheck.too_slow])


def _same(a, b) -> bool:
    """Equal values of equal types, dict keys in the same order, NaN == NaN."""
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or a == b
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


# text with the characters that make the dumper quote, escape or fold
_ALPHABET = st.sampled_from(list("abcXYZ019 _-.:#'\"\\,[]{}&*!|>%@`?~=<\t")
                            + ["é", "ß", "\x85", "\x07", "\x1b", "😀"])
_WORDS = st.sampled_from(["yes", "No", "ON", "off", "true", "null", "~", "017", "0x1F", "1:30",
                          "1e-3", "1.0e3", "1.0e-3", ".inf", "-.inf", ".nan", "<<", "=", "-",
                          "2001-12-14", "w_chamfer", "joint_rot", "", " lead", "trail "])
_TEXT = st.one_of(st.text(_ALPHABET, max_size=12), _WORDS,
                  st.text(st.sampled_from("ab "), min_size=30, max_size=60))
_SCALARS = st.one_of(st.none(), st.booleans(), st.integers(-10**20, 10**20),
                     st.floats(allow_nan=True, allow_infinity=True), _TEXT)
# (an empty key the dumper writes as a complex key, "? ''", which the reader refuses)
_KEYS = st.one_of(st.text(st.sampled_from("abcdefgh_012"), min_size=1, max_size=10),
                  _WORDS.filter(bool), st.integers(-5, 5))
_TREES = st.recursive(_SCALARS, lambda inner: st.one_of(
    st.lists(inner, max_size=4), st.dictionaries(_KEYS, inner, max_size=4)), max_leaves=20)
# the stage files' shape: stages of scheme / nits / lr / loss_weights / custom_lrs
_STAGE = st.fixed_dictionaries(
    {"scheme": st.sampled_from(["init", "default", "shape", "deform"]),
     "nits": st.integers(0, 1000), "lr": st.floats(1e-6, 1.0)},
    optional={"loss_weights": st.dictionaries(st.sampled_from(
        ["w_chamfer", "w_edge", "w_laplacian", "w_normal", "w_scale"]), st.floats(0, 10),
        max_size=4),
              "custom_lrs": st.dictionaries(st.sampled_from(
                  ["joint_rot", "global_rot", "betas", "deform_verts"]), st.floats(0, 1),
                  max_size=3)})
_STAGE_FILES = st.fixed_dictionaries(
    {"stages": st.dictionaries(st.text(st.sampled_from("Stage0123"), min_size=1, max_size=7),
                               _STAGE, min_size=1, max_size=4)},
    optional={"args": st.fixed_dictionaries({}, optional={
        "results_dir": _TEXT, "batch_size": st.integers(-1, 200)})})
_DUMP = st.fixed_dictionaries({
    "default_flow_style": st.sampled_from([False, True, None]),
    "width": st.sampled_from([12, 40, 80]), "indent": st.sampled_from([2, 4]),
    "allow_unicode": st.booleans(), "sort_keys": st.booleans(),
    "explicit_start": st.booleans(), "explicit_end": st.booleans()})


@SETTINGS
@given(tree=st.one_of(_TREES, _STAGE_FILES), dump=_DUMP)
def test_safe_load_equals_pyyaml_on_dumped_trees(tree, dump):
    text = yaml.safe_dump(tree, **dump)
    want = yaml.safe_load(text)
    assert _same(safe_load(text), want), text


def test_safe_load_reads_streams_bytes_and_the_hand_written_subset():
    text = ("# stages for a registration\n"
            "---\n"
            "stages:\n"
            "  Stage0:            # the first\n"
            "    scheme: init\n"
            "    nits: 20\n"
            "    lr: 0.01\n"
            "  Stage1:\n"
            "    scheme: 'default'\n"
            "    nits: 20\n"
            "    lr: 5.0e-3\n"
            "    loss_weights: {w_chamfer: 1.0,\n"
            "                   w_edge: 0.5, w_scale: }\n"
            "    custom_lrs: {joint_rot: 0.005}\n"
            "    tags: [a, \"b c\", [d, {e: f}], g: h]\n"
            "    note: a long plain\n"
            "      scalar, folded\n"
            "args:\n"
            "  results_dir: \"out\\tdir\"\n"
            "  empty:\n"
            "  list:\n"
            "  - 1\n"
            "  - - 2\n"
            "    - 3\n"
            "  - k: v\n"
            "    k2: v2\n"
            "...\n")
    want = yaml.safe_load(text)
    for src in (text, text.encode(), io.StringIO(text)):
        assert _same(safe_load(src), want)
    assert want["stages"]["Stage1"]["tags"][3] == {"g": "h"}


@pytest.mark.parametrize("text,value", [
    ("yes", True), ("No", False), ("on", True), ("OFF", False), ("True", True),
    ("~", None), ("null", None), ("NULL", None), ("", None),
    ("017", 15), ("-017", -15), ("0x1F", 31), ("0b101", 5), ("1_000", 1000), ("+7", 7),
    ("09", "09"), ("0o17", "0o17"),
    ("1:30", 90), ("-1:30", -90), ("3:25:45", 12345), ("1:70", "1:70"),
    ("1:30.5", 90.5), ("190:20:30.15", 685230.15),
    ("1e-3", "1e-3"), ("1.0e3", "1.0e3"), ("1.0e-3", 1.0e-3), ("1.0E+3", 1000.0),
    ("1.", 1.0), (".5", 0.5), ("+.5", "+.5"), ("._", "._"), ("1_0.5", 10.5),
    (".inf", math.inf), ("-.Inf", -math.inf), ("+.INF", math.inf), (".nan", math.nan),
    ("0.1.2", "0.1.2"), ("12e", "12e"), ("-", None),
])
def test_resolver_traps(text, value):
    doc = f"k: {text}\n" if text != "-" else "- \n"
    want = yaml.safe_load(doc)
    got = safe_load(doc)
    assert _same(got, want)
    assert _same(got, [value] if text == "-" else {"k": value})


@pytest.mark.parametrize("text,construct", [
    ("a: &x 1\nb: *x\n", "anchors"),
    ("a: *x\n", "anchors"),
    ("a: !!str 1\n", "tags"),
    ("a: !custom x\n", "tags"),
    ("a: |\n  x\n", "block scalars"),
    ("a: >-\n  x\n", "block scalars"),
    ("a: 1\n---\nb: 2\n", "more than one"),
    ("---\na: 1\n...\n---\nb: 2\n", "more than one"),
    ("? a\n: b\n", "complex keys"),
    ("a: [?x]\n", "complex keys"),
    ("<<: {a: 1}\nb: 2\n", "merge keys"),
    ("a: {<<: {b: 1}}\n", "merge keys"),
    ("a: 2001-12-14\n", "timestamps"),
    ("a: 2001-12-14 21:59:43.10 -5\n", "timestamps"),
    ("%YAML 1.1\n---\na: 1\n", "directives"),
    ("[a]: b\n", "collections as mapping keys"),
    ("a: 'x\u2028y'\n", "line break LS"),
])
def test_refusals_name_the_construct(text, construct):
    with pytest.raises(NotImplementedError, match=construct):
        safe_load(text)


@pytest.mark.parametrize("text", ["a: b: c\n", "a: - 1\n", "a:\n  b: 1\n c: 2\n", "k: a\tb\n",
                                  "a: \"x\"y\n", "a: \"\\q\"\n", "a: 'open\n", "a: [1, 2\n",
                                  "a: [1, , 2]\n", "a: @x\n"])
def test_malformed_input_raises_as_pyyaml_does(text):
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(ValueError):
        safe_load(text)


@SETTINGS
@given(cfg=_STAGE_FILES, flow=st.sampled_from([False, None]))
def test_load_stages_from_yaml_matches_jax(tmp_path_factory, cfg, flow):
    from smilify_tpu.cli import optimise_3d as jcli
    from smilify_tpu_torch.cli import optimise_3d as tcli

    path = tmp_path_factory.mktemp("yaml") / "stages.yaml"
    path.write_text("# stages\n" + yaml.safe_dump(cfg, default_flow_style=flow))
    (jstages, jargs), (tstages, targs) = (m.load_stages_from_yaml(str(path)) for m in (jcli, tcli))
    assert _same(targs, jargs)
    fields = ("name", "scheme", "n_its", "lr", "loss_weights", "custom_lrs")
    assert [[getattr(s, f) for f in fields] for s in tstages] == [
        [getattr(s, f) for f in fields] for s in jstages]
