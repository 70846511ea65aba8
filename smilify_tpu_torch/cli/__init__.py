"""Command-line entry points: the fitter CLIs and 3D registration."""
