"""Raw-video inference input (reference ``run_singleview_inference.py``;
port of ``smilify_tpu/data/video.py``).

``VideoFrameDataset`` turns a video file into a map-style dataset of
single-view inference samples with the reference's crop modes:

  * ``default``   — direct (anisotropic) resize of the full frame;
  * ``centred``   — center square crop then resize;
  * ``bbox_crop`` — square crop around the subject from SLEAP 2D predictions
    (1.05× padding), falling back to ``centred`` on frames without
    predictions.

The SLEAP predictions (.slp / analysis .h5) are optional; when given they also
populate per-frame ``keypoints_2d``/``keypoint_visibility`` in crop
coordinates so overlays and PCK evaluation work on raw video.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


class VideoFrameDataset:
    VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv")

    def __init__(
        self,
        video_path: str,
        resolution: int = 224,
        crop_mode: str = "default",
        sleap_predictions: Optional[str] = None,
        joint_names: Optional[List[str]] = None,
        joint_lookup: Optional[dict] = None,
        confidence_threshold: float = 0.5,
        max_frames: Optional[int] = None,
    ):
        from smilify_tpu_torch.data.sleap_raw import (
            SequentialVideoReader,
            map_keypoints_to_model,
            read_sleap_predictions,
        )

        self.reader = SequentialVideoReader(video_path)
        self.resolution = resolution
        self.crop_mode = crop_mode
        self.confidence_threshold = confidence_threshold
        n = self.reader.n_frames
        self.n = n if max_frames is None else min(n, max_frames)

        self.kp = None
        self.scores = None
        if sleap_predictions:
            pts, scores, node_names = read_sleap_predictions(sleap_predictions)
            if joint_names is not None:
                pts, scores = map_keypoints_to_model(
                    pts, scores, node_names, list(joint_names), joint_lookup
                )
            self.kp = pts
            self.scores = scores
        elif crop_mode == "bbox_crop":
            raise ValueError("bbox_crop needs --sleap-predictions for the subject bbox")

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        from smilify_tpu_torch.data.preprocess_multiview import crop_and_resize

        frame = self.reader.read(idx)
        if frame is None:
            raise IndexError(f"frame {idx} unreadable")
        H, W = frame.shape[:2]
        if self.kp is not None and idx < len(self.kp):
            kp = np.asarray(self.kp[idx], np.float64)
            sc = np.asarray(self.scores[idx], np.float32)
        else:
            kp = np.full((1, 2), np.nan)
            sc = np.zeros(1, np.float32)

        mode = self.crop_mode
        if mode == "bbox_crop" and not np.isfinite(kp).all(axis=1).any():
            mode = "centred"
        K = np.array([[max(H, W), 0, W / 2], [0, max(H, W), H / 2], [0, 0, 1.0]])
        res = crop_and_resize(frame, kp, K, self.resolution, mode)
        R = self.resolution
        inb = (
            np.isfinite(res.keypoints).all(axis=1)
            & (res.keypoints[:, 0] >= 0) & (res.keypoints[:, 0] < R)
            & (res.keypoints[:, 1] >= 0) & (res.keypoints[:, 1] < R)
        )
        vis = ((sc >= self.confidence_threshold) & inb).astype(np.float32)
        return {
            "image": np.clip(res.image, 0.0, 1.0).astype(np.float32),
            "keypoints_2d": np.nan_to_num(res.keypoints).astype(np.float32),
            "keypoint_visibility": vis,
            "frame_idx": idx,
        }

    def close(self):
        self.reader.close()
