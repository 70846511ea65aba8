"""The benchmark of smilify_tpu_torch on NVIDIA cards (see README.md)."""
