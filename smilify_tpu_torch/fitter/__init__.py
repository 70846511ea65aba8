"""The 2D keypoint + silhouette optimization fitter."""
