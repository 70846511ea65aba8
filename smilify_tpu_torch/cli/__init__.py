"""Command-line entry points: the fitter CLIs, 3D registration, the data
tools, and the regressors' inference and benchmark."""
