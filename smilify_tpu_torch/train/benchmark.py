"""Benchmark harness: PCK curves and MPJPE statistics (port of
``smilify_tpu/train/benchmark.py``; host-side numpy).

Metric definitions match the reference ``neuralSMIL/benchmark_model.py``:
  * per-joint pixel errors at native resolution (rescaled by original
    width/height) and at input resolution; PCK@t for t = 1..50 px
    (_compute_pck_errors:176-250);
  * MPJPE in millimetres with P50/P90/P95/P99 percentiles for multi-view
    models with 3D ground truth (_accumulate_mpjpe_mm:251+);
  * outputs: report txt, PCK curve plot, error histograms, raw .npy arrays
    (output contract README.md:306-340).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np


class BenchmarkAccumulator:
    def __init__(self, pck_thresholds=range(1, 51)):
        self.pck_thresholds = list(pck_thresholds)
        self.pixel_errors_native: List[np.ndarray] = []
        self.pixel_errors_input: List[np.ndarray] = []
        self.mpjpe_mm: List[np.ndarray] = []

    def add_2d(
        self,
        pred_yx_norm: np.ndarray,
        gt_yx_norm: np.ndarray,
        visibility: np.ndarray,
        input_size: int,
        native_size: Optional[np.ndarray] = None,
    ):
        """Accumulate normalized (…, K, 2) (y, x) predictions vs GT."""
        d = pred_yx_norm - gt_yx_norm
        err_in = np.linalg.norm(d * input_size, axis=-1)
        vis = visibility > 0
        self.pixel_errors_input.append(err_in[vis])
        if native_size is not None:
            scale = np.asarray(native_size, dtype=np.float64)  # (..., 2) (H, W)
            err_nat = np.linalg.norm(d * scale[..., None, :], axis=-1)
            self.pixel_errors_native.append(err_nat[vis])

    def add_3d(self, pred_xyz: np.ndarray, gt_xyz: np.ndarray, valid: Optional[np.ndarray] = None,
               world_to_mm: float = 1000.0):
        err = np.linalg.norm(pred_xyz - gt_xyz, axis=-1) * world_to_mm
        if valid is not None:
            err = err[valid > 0]
        self.mpjpe_mm.append(err.reshape(-1))

    # --- summaries ---

    def pck_curve(self, which: str = "input") -> Dict[int, float]:
        errs = np.concatenate(
            self.pixel_errors_input if which == "input" else self.pixel_errors_native
        ) if (self.pixel_errors_input if which == "input" else self.pixel_errors_native) else np.zeros(0)
        if errs.size == 0:
            return {}
        return {t: float((errs <= t).mean()) for t in self.pck_thresholds}

    def mpjpe_stats(self) -> Dict[str, float]:
        if not self.mpjpe_mm:
            return {}
        e = np.concatenate(self.mpjpe_mm)
        return {
            "mpjpe_mm": float(e.mean()),
            "p50": float(np.percentile(e, 50)),
            "p90": float(np.percentile(e, 90)),
            "p95": float(np.percentile(e, 95)),
            "p99": float(np.percentile(e, 99)),
            "n": int(e.size),
        }

    def write_report(self, out_dir: str, title: str = "benchmark"):
        os.makedirs(out_dir, exist_ok=True)
        lines = [f"# {title}", ""]
        for which in ("input", "native"):
            curve = self.pck_curve(which)
            if curve:
                lines.append(f"PCK ({which} resolution):")
                for t in (1, 2, 5, 10, 20, 50):
                    if t in curve:
                        lines.append(f"  PCK@{t}px = {curve[t]:.4f}")
                errs = np.concatenate(
                    self.pixel_errors_input if which == "input" else self.pixel_errors_native
                )
                lines.append(f"  mean pixel error = {errs.mean():.2f} px (n={errs.size})")
                np.save(os.path.join(out_dir, f"pixel_errors_{which}.npy"), errs)
                lines.append("")
        stats = self.mpjpe_stats()
        if stats:
            lines.append("MPJPE (mm): " + " ".join(f"{k}={v:.2f}" for k, v in stats.items()))
            np.save(os.path.join(out_dir, "mpjpe_mm.npy"), np.concatenate(self.mpjpe_mm))

        report = "\n".join(lines)
        with open(os.path.join(out_dir, "benchmark_report.txt"), "w") as f:
            f.write(report + "\n")

        self._plot(out_dir)
        return report

    def _plot(self, out_dir: str):
        from smilify_tpu_torch.utils import plotting

        curve = self.pck_curve("input")
        if curve:
            fig, ax = plotting.subplots(figsize=(6, 4))
            ts = sorted(curve)
            ax.plot(ts, [curve[t] for t in ts])
            ax.set_xlabel("threshold (px)")
            ax.set_ylabel("PCK")
            ax.set_title("PCK curve (input resolution)")
            ax.grid(True, alpha=0.3)
            fig.savefig(os.path.join(out_dir, "pck_curve.png"), dpi=120)
        if self.pixel_errors_input:
            fig, ax = plotting.subplots(figsize=(6, 4))
            ax.hist(np.concatenate(self.pixel_errors_input), bins=50)
            ax.set_xlabel("pixel error")
            ax.set_title("keypoint error histogram")
            fig.savefig(os.path.join(out_dir, "error_histogram.png"), dpi=120)


def detect_model_type_from_params(state_dict) -> str:
    """single vs multi-view from a model state dict's keys (the multi-view
    model has ``view_embeddings.weight``)."""
    if any("view_embeddings" in k for k in (state_dict or {})):
        return "multi_view"
    return "single_view"
