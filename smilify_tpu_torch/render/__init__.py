"""Camera and soft-silhouette rasterizer."""
