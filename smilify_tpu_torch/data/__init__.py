"""The data pipeline: the fitter CLIs' sequence loaders, the HDF5 dataset
schema and its readers, replicAnt and SLEAP inputs, augmentation, and the
synthetic multi-view generator."""
