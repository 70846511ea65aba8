"""The committed fixtures of the port's YAML reader, polygon masks and
plotter (``tests/fixtures/plots/``): what PyYAML and matplotlib answer for a
set of cases, so that a machine without either package (the card's) can be
held to them.

The cases are defined here, from seeds:

  * :data:`YAML_DOCUMENTS`: stage files and documents of the reader's
    subset, with the resolver's traps;
  * :func:`polygon_cases`: COCO polygon segmentations (integer, half-integer
    and float vertices, edges through pixel centres, self-intersecting,
    unclosed and closed, several polygons in one annotation) on a pixel grid;
  * :func:`axes_cases`: the plot sites' 2D call sequences (linear, log,
    histogram, shared x axes, ``axhline``), applied by :func:`apply_case` to
    ``pyplot`` or to ``utils/plotting.py``, whichever module is passed;
  * :func:`projection_cases`: 3D call sequences with their views, and
    points to project.

``expected.json`` holds PyYAML's values (tagged by type, so that keys and
numbers keep their types) and ``expected.npz`` matplotlib's masks, axis
limits, projection matrices and projected points, and its viridis table.
The reference side, which imports PyYAML and matplotlib, is in
``tests/test_torch_plots.py`` (``reference_answers``, ``regenerate``); it
also checks that the committed files are still what they answer. :func:`check`
computes the port's answers and lists every key that differs (masks,
values and the table exactly, limits within 1e-12 relative, projections
within 1e-9): ``tests/test_torch_plots.py`` on the CPU, ``chip_smoke.py``
phase 17 on the card.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, List

import numpy as np

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "tests", "fixtures", "plots")
LIMIT_RTOL = 1e-12
PROJ_TOL = 1e-9

YAML_DOCUMENTS = {
    "stages": (
        "# a registration's stages\n"
        "stages:\n"
        "  Stage0:            # rigid first\n"
        "    scheme: init\n"
        "    nits: 20\n"
        "    lr: 0.01\n"
        "  Stage1:\n"
        "    scheme: default\n"
        "    nits: 20\n"
        "    lr: 5.0e-3\n"
        "    loss_weights: {w_chamfer: 1.0, w_edge: 0.5, w_laplacian: 1.0e-1}\n"
        "    custom_lrs: {joint_rot: 0.005, betas: 1e-3}\n"
        "args: {results_dir: fit3d_results}\n"),
    "traps": (
        "bools: [yes, No, on, OFF, true, False]\n"
        "nulls: [~, null, NULL, ]\n"
        "ints: [017, -017, 0x1F, 0b101, 1_000, +7, 09, 0o17, 1:30, -1:30, 1:70]\n"
        "floats: [1e-3, 1.0e3, 1.0e-3, 1.0E+3, 1., .5, +.5, 1:30.5, .inf, -.Inf, .nan, 0.1.2]\n"
        "empty:\n"
        "'quoted': 'it''s'\n"
        "\"double\": \"tab\\there \\u00e9\\x41 \\\\ \\\"q\\\" \\/\"\n"),
    "block": (
        "---\n"
        "list:\n"
        "- 1\n"
        "- - 2\n"
        "  - 3\n"
        "- k: v\n"
        "  k2: [a, {b: c}, d: e]\n"
        "-\n"
        "nested:\n"
        "    deep:\n"
        "        deeper: a plain scalar\n"
        "          folded over lines\n"
        "    'key with: colon': x#not a comment\n"
        "1: int key\n"
        "true: bool key\n"
        "...\n"),
    "flow": (
        "{stages: {S0: {scheme: init, nits: 2,\n"
        "   lr: 0.05}, S1: {scheme: default,\n"
        "   loss_weights: {w_chamfer: 1.0}, custom_lrs: {}}}, args: {results_dir: 'out dir'},\n"
        " empty: [], none: {}}\n"),
}


def yaml_encode(value) -> Any:
    """A parsed YAML value as JSON that keeps its types: [tag, ...]."""
    if value is None:
        return ["null"]
    if isinstance(value, bool):
        return ["bool", value]
    if isinstance(value, int):
        return ["int", str(value)]
    if isinstance(value, float):
        return ["float", "nan" if math.isnan(value) else float.hex(value)]
    if isinstance(value, str):
        return ["str", value]
    if isinstance(value, list):
        return ["seq", [yaml_encode(v) for v in value]]
    if isinstance(value, dict):
        return ["map", [[yaml_encode(k), yaml_encode(v)] for k, v in value.items()]]
    raise TypeError(f"yaml_encode: {type(value).__name__}")


def polygon_cases() -> Dict[str, dict]:
    """name → {"polygons": [flat vertex lists], "height", "width"}."""
    rng = np.random.RandomState(11)
    h, w = 48, 64
    cases = {
        "integer": [rng.randint(-4, 68, 14).tolist()],
        "half_integer": [(rng.randint(-8, 130, 16) / 2.0).tolist()],
        "float": [rng.uniform(-3.0, 66.0, 18).tolist()],
        # axis-aligned and diagonal edges through pixel centres, a vertex on one
        "through_centres": [[5, 5, 30, 5, 30, 20, 5, 20], [40, 2, 60, 22, 40, 42, 33, 22]],
        "self_intersecting": [[4, 4, 40, 40, 40, 4, 4, 40], [45, 10, 62, 30, 42, 30, 60, 10, 52, 40]],
        "closed": [[10, 10, 50, 12, 30, 40, 10, 10]],
        "unclosed": [[10, 10, 50, 12, 30, 40]],
        "several": [[2, 2, 12, 2, 12, 12], [20.5, 20.5, 40.5, 22, 30, 45.5],
                    rng.uniform(30, 63, 10).tolist()],
        "degenerate": [[5, 5, 20, 20], [1, 1, 30, 30, 60, 60]],
        "outside": [[-20, -20, -5, -10, -8, -30], [70, 50, 90, 60, 80, 80]],
    }
    return {k: {"polygons": v, "height": h, "width": w} for k, v in cases.items()}


def axes_cases() -> Dict[str, dict]:
    """name → {"nrows", "sharex", "calls": [(axes index, method, args, kwargs)]}:
    the plot sites' call sequences on data from a seed."""
    rng = np.random.RandomState(5)
    ep = np.arange(12.0)
    loss = 1.0 / (ep + 1) + 0.01 * rng.rand(12)
    nan_loss = loss.copy()
    nan_loss[[0, 5]] = np.nan
    lr = 1e-3 * 0.9 ** ep
    lr[3] = np.nan
    comps = [np.abs(rng.randn(12)) * 10.0 ** -k for k in range(3)]
    comps[1][2] = 0.0
    comps[2][4] = -1.0
    ts = np.asarray([1, 2, 5, 10, 20, 50], np.float64)
    pck = np.asarray([0.05, 0.12, 0.4, 0.71, 0.9, 1.0])
    errors = np.abs(rng.randn(400)) * 7.0
    iters = np.arange(20.0)
    xs = np.arange(7.0)

    def line(y, **kw):
        return (0, "plot", (ep, y), kw)

    def pca(offset):
        calls = []
        for i in (0, 1):
            for k in range(3):
                calls.append((i, "scatter", (xs, rng.randn(7) * 0.1 + offset), {"s": 14,
                                                                                "label": "xyz"[k]}))
            calls.append((i, "axhline", (0,), {"color": "gray", "lw": 0.5}))
        calls.append((1, "set_xticks", (xs,), {}))
        return {"nrows": 2, "sharex": True, "calls": calls}

    return {
        "history": {"calls": [line(loss, label="loss")]},
        "history_nan": {"calls": [line(nan_loss)]},
        "lr_log": {"calls": [line(lr), (0, "set_yscale", ("log",), {})]},
        "lr_log_constant": {"calls": [line(np.full(12, 1e-3)), (0, "set_yscale", ("log",), {})]},
        "components_log": {"calls": [line(c, label=f"c{k}") for k, c in enumerate(comps)]
                           + [(0, "set_yscale", ("log",), {})]},
        "single_point": {"calls": [(0, "plot", ([3.0], [0.5]), {})]},
        "no_data": {"calls": [(0, "plot", ([np.nan], [np.nan]), {})]},
        "pck_curve": {"calls": [(0, "plot", (ts, pck), {})]},
        "error_hist": {"calls": [(0, "hist", (errors,), {"bins": 50})]},
        "hist_constant": {"calls": [(0, "hist", (np.full(9, 2.5),), {"bins": 50})]},
        "semilogy_stages": {"calls": [(0, "semilogy", (iters, 2.0 ** -iters / 3), {"label": "init"}),
                                      (0, "semilogy", (iters + 20, 1e-6 + 0 * iters),
                                       {"label": "default"})]},
        "loss_components_rows": {"nrows": 3, "calls": [
            (i, "semilogy", (iters, np.abs(rng.randn(20)) + 10.0 ** -i), {"label": "s"})
            for i in range(3)]},
        "pca_zero_inside": pca(0.0),
        "pca_zero_outside": pca(5.0),
    }


def projection_cases() -> Dict[str, dict]:
    """name → {"calls": [(method, args, kwargs)], "points": (N, 3)}: 3D
    call sequences (scatter, plot, plot_trisurf, view_init, set_*lim) and
    points to project through the resulting view."""
    rng = np.random.RandomState(6)
    pred = rng.randn(12, 3) * [1.0, 0.5, 0.3]
    gt = pred + rng.randn(12, 3) * 0.05
    gt[[2, 7]] = 0.0
    nz = ~np.all(gt == 0, axis=-1)
    kp = [("scatter", tuple(pred.T), {"c": "red", "s": 12, "label": "pred"}),
          ("scatter", tuple(gt[nz].T), {"c": "green", "s": 12, "label": "gt"})]
    kp += [("plot", ([a[0], b[0]], [a[1], b[1]], [a[2], b[2]]), {"c": "gray", "lw": 0.5})
           for a, b in zip(pred[nz], gt[nz])]
    grid = np.stack(np.meshgrid(np.linspace(-1, 1, 6), np.linspace(-0.5, 0.7, 5)), -1).reshape(-1, 2)
    verts = np.concatenate([grid, (np.sin(grid[:, :1] * 2) * 0.3)], axis=1)
    tris = np.asarray([[r * 6 + c, r * 6 + c + 1, (r + 1) * 6 + c] for r in range(4) for c in range(5)])

    def equal(pts):
        lo, hi = pts.min(axis=0), pts.max(axis=0)
        c = (lo + hi) / 2
        r = float((hi - lo).max() / 2) or 1.0
        return [("set_xlim", (c[0] - r, c[0] + r), {}), ("set_ylim", (c[1] - r, c[1] + r), {}),
                ("set_zlim", (c[2] - r, c[2] + r), {})]

    mesh = [("plot_trisurf", tuple(verts.T), {"triangles": tris, "color": "lightblue",
                                              "edgecolor": "none", "alpha": 0.9})]
    cases = {
        "keypoints_autoscale": {"calls": kp},
        "mesh_equal": {"calls": mesh + [("view_init", (), {"elev": 20.0, "azim": -60.0})]
                       + equal(verts)},
        "clouds_equal": {"calls": [("scatter", tuple(pred.T), {"s": 4, "label": "a"}),
                                   ("scatter", tuple(gt.T), {"s": 4, "label": "b"})]
                         + equal(np.concatenate([pred, gt]))},
    }
    for elev, azim in ((45.0, 30.0), (-20.0, 170.0), (100.0, -120.0), (10.0, 75.0)):
        cases[f"view_{elev:g}_{azim:g}"] = {
            "calls": kp + [("view_init", (), {"elev": elev, "azim": azim})]}
    for case in cases.values():
        case["points"] = np.concatenate([pred, rng.uniform(-1.0, 1.0, (8, 3))])
    return cases


def apply_case(module, case: dict, three_d: bool = False):
    """A case's calls on a fresh figure of ``module`` (``matplotlib.pyplot``
    or ``smilify_tpu_torch.utils.plotting``) → (figure, [axes])."""
    if three_d:
        fig = module.figure(figsize=(6, 6))
        ax = fig.add_subplot(projection="3d")
        for name, args, kwargs in case["calls"]:
            getattr(ax, name)(*args, **kwargs)
        return fig, [ax]
    fig, axes = module.subplots(case.get("nrows", 1), 1, sharex=case.get("sharex", False),
                                squeeze=False)
    axes = [a for a in axes[:, 0]]
    for i, name, args, kwargs in case["calls"]:
        getattr(axes[i], name)(*args, **kwargs)
    return fig, axes


def answers(module, proj_transform, yaml_load, mask) -> Dict[str, Any]:
    """Every case's answer from one side: the port's (``utils/plotting``,
    its ``proj_transform``, ``utils/yaml_io.safe_load`` and
    ``data/loaders.polygon_mask``) or the reference's (pyplot,
    ``proj3d.proj_transform``, ``yaml.safe_load`` and a mask from
    ``Path.contains_points``): → {"yaml": {name: encoded value}, "arrays":
    {key: array}}."""
    arrays: Dict[str, np.ndarray] = {}
    for name, case in polygon_cases().items():
        arrays[f"mask/{name}"] = np.asarray(mask(case["polygons"], case["height"],
                                                 case["width"]), bool)
    for name, case in axes_cases().items():
        _, axes = apply_case(module, case)
        arrays[f"limits/{name}"] = np.asarray([[ax.get_xlim(), ax.get_ylim()] for ax in axes])
    for name, case in projection_cases().items():
        _, (ax,) = apply_case(module, case, three_d=True)
        arrays[f"limits3d/{name}"] = np.asarray([ax.get_xlim(), ax.get_ylim(), ax.get_zlim()])
        M = ax.get_proj()
        arrays[f"proj/{name}"] = M
        arrays[f"projected/{name}"] = np.asarray(proj_transform(*case["points"].T, M))
    yaml_values = {name: yaml_encode(yaml_load(text)) for name, text in YAML_DOCUMENTS.items()}
    return {"yaml": yaml_values, "arrays": arrays}


def port_answers() -> Dict[str, Any]:
    from smilify_tpu_torch.data.loaders import polygon_mask
    from smilify_tpu_torch.utils import plotting
    from smilify_tpu_torch.utils.yaml_io import safe_load

    out = answers(plotting, plotting.proj_transform, safe_load, polygon_mask)
    out["arrays"]["viridis"] = plotting.VIRIDIS
    return out


def save(directory: str, ref: Dict[str, Any]) -> None:
    """Writes ``expected.json`` (the YAML values) and ``expected.npz`` (the
    arrays; masks bit-packed)."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "expected.json"), "w") as f:
        json.dump(ref["yaml"], f, indent=1, sort_keys=True)
        f.write("\n")
    arrays = {k: (np.packbits(v, axis=-1) if k.startswith("mask/") else v)
              for k, v in ref["arrays"].items()}
    np.savez_compressed(os.path.join(directory, "expected.npz"), **arrays)


def load(directory: str = FIXTURE_DIR) -> Dict[str, Any]:
    """What :func:`save` wrote, the masks unpacked to their widths."""
    with open(os.path.join(directory, "expected.json")) as f:
        yaml_values = json.load(f)
    cases = polygon_cases()
    with np.load(os.path.join(directory, "expected.npz")) as npz:
        arrays = {}
        for k in npz.files:
            v = npz[k]
            if k.startswith("mask/"):
                v = np.unpackbits(v, axis=-1, count=cases[k[5:]]["width"]).astype(bool)
            arrays[k] = v
    return {"yaml": yaml_values, "arrays": arrays}


def differences(got: Dict[str, Any], want: Dict[str, Any]) -> Dict[str, List[str]]:
    """{section: keys that differ}: YAML values, masks and the viridis table
    exactly, limits within :data:`LIMIT_RTOL` relative, projection matrices
    and projected points within :data:`PROJ_TOL`."""
    out = {"yaml": sorted(k for k in set(got["yaml"]) | set(want["yaml"])
                          if got["yaml"].get(k) != want["yaml"].get(k))}
    sections = {"mask": [], "limits": [], "limits3d": [], "proj": [], "projected": [],
                "viridis": []}
    for k in sorted(set(got["arrays"]) | set(want["arrays"])):
        section = k.split("/")[0]
        g, w = got["arrays"].get(k), want["arrays"].get(k)
        if g is None or w is None or g.shape != w.shape:
            bad = True
        elif section in ("mask", "viridis"):
            bad = not np.array_equal(g, w)
        elif section.startswith("limits"):
            bad = not np.allclose(g, w, rtol=LIMIT_RTOL, atol=0)
        else:
            bad = not np.allclose(g, w, rtol=PROJ_TOL, atol=PROJ_TOL)
        if bad:
            sections[section].append(k)
    out.update(sections)
    return out


def check(directory: str = FIXTURE_DIR) -> Dict[str, List[str]]:
    """The port's answers against the committed fixtures → {section: the
    keys that differ} (all empty when the port answers as PyYAML and
    matplotlib do)."""
    return differences(port_answers(), load(directory))


def write_polygon_coco(root: str):
    """A replicAnt COCO folder whose annotations carry
    :func:`polygon_cases`' segmentations, one black 8-bit frame a case
    → (the COCO folder, {frame name: case name})."""
    from smilify_tpu_torch.utils.image_io import write_png

    coco = os.path.join(root, "SMIL_COCO")
    os.makedirs(os.path.join(coco, "data"), exist_ok=True)
    images, annotations, names = [], [], {}
    for i, (name, case) in enumerate(polygon_cases().items()):
        frame = f"SMIL_{i:02d}_synth.png"
        write_png(os.path.join(coco, "data", frame),
                  np.zeros((case["height"], case["width"], 3), np.uint8))
        images.append({"id": i, "file_name": frame, "height": case["height"],
                       "width": case["width"]})
        annotations.append({"id": i, "image_id": i, "segmentation": case["polygons"],
                            "keypoints": [1.0, 2.0, 2.0, 3.0, 4.0, 2.0]})
        names[frame] = name
    labels = {"images": images, "annotations": annotations,
              "categories": [{"id": 1, "name": "insect", "keypoints": ["a", "b"]}]}
    with open(os.path.join(coco, "labels.json"), "w") as f:
        json.dump(labels, f)
    return coco, names
