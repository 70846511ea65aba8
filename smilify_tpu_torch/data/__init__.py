"""Sequence loaders for the fitter CLIs."""
