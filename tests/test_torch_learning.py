"""The port's learning-proof tool (``smilify_tpu_torch/tools/prove_learning.py``)
at a toy size on the CPU (``unet_micro`` at 32², two epochs): the plumbing,
not the gates, which need the full runs on the card (``chip_smoke.py`` phase
15 runs ``memorize``; ``heldout`` runs through the tool). Held: the samples it
scores are the JAX package's seeded split for the same n and ratios (its test
rows for ``heldout``), and an error planted in a training row's keypoints
leaves the held-out scores unchanged while one planted in a test row moves
them."""

import tests._torch_threads  # noqa: F401  (first: torch's thread share of a worker)

import copy
import os

import numpy as np
import pytest

from smilify_tpu.train.trainer import split_dataset as jax_split_dataset

from smilify_tpu_torch.cli import benchmark_model
from smilify_tpu_torch.tools import prove_learning

TOY = dict(epochs=2, backbone="unet_micro", res=32, device="cpu")


@pytest.fixture(scope="module")
def heldout_sv(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("heldout"))
    return work, prove_learning.run("sv", "heldout", work, samples=40, **TOY)


def test_heldout_scores_the_jax_split_test_rows(heldout_sv):
    _, r = heldout_sv
    want = jax_split_dataset(40, (0.85, 0.05, 0.10), 1234)[2]
    assert r["scored_split"] == "test" and r["scored_samples"] == sorted(int(i) for i in want)
    assert len(r["scored_samples"]) == 4 and 0 < r["scored_keypoints"] <= 4 * 55
    assert r["steps"] == 2 * (34 // 32) and np.isfinite(r["loss_ratio"])
    assert set(r["gates"]) == {"pck@10px"} and r["ok"] == (r["pck@10px"] >= 0.9)
    assert os.path.exists(os.path.join(heldout_sv[0], "learning_sv_heldout.json"))


def _errors(work, store):
    acc = benchmark_model.main([
        "--checkpoint", os.path.join(work, "heldout_sv", "final_model"), "--device", "cpu",
        "--output-dir", os.path.join(work, "bench"), "--split", "test",
        "--split-ratios", "0.85,0.05,0.1", "--split-seed", "1234"], source=store)
    return np.concatenate([np.ravel(e) for e in acc.pixel_errors_input])


def test_planted_error_in_a_training_row_leaves_heldout_scores(heldout_sv):
    from smilify_tpu_torch.core.spec import load_model_spec

    work, r = heldout_sv
    spec = load_model_spec(os.path.join(work, "stick_width.pkl"), align_symmetry=False, device="cpu")
    store = prove_learning.make_store(spec, 40, 1, 32, 11, "cpu")
    base = _errors(work, store)
    train_row = next(i for i in range(40) if i not in r["scored_samples"])
    for row, moves in ((train_row, False), (r["scored_samples"][0], True)):
        planted = copy.deepcopy(store)
        planted.arrays["multiview_keypoints/keypoints_2d"][row] += 7.0     # pixels
        got = _errors(work, planted)
        assert got.shape == base.shape
        assert (not np.array_equal(got, base)) == moves, (row, moves)


def test_memorize_multiview_plumbing(tmp_path):
    r = prove_learning.run("mv", "memorize", str(tmp_path), **TOY)
    train = jax_split_dataset(12, (0.99, 0.0, 0.01), 1234)[0]
    assert r["scored_split"] == "train" and r["scored_samples"] == sorted(int(i) for i in train)
    assert r["views"] == 2 and r["steps"] == 2 * (11 // 4)
    assert set(r["gates"]) == {"loss_ratio", "pck@5px", "pck@10px"}
    assert r["mpjpe"]["n"] > 0 and np.isfinite(r["loss_ratio"])
