"""Plain PyTorch references of what the benchmark's cells run: the SMIL
forward and camera (``smil.py``), the capped soft silhouette (``raster.py``),
the fitter's stage step (``fit.py``) and the single-view regressor's forward,
loss and Adam step (``regressor.py``). They import nothing of the program
under test and take nothing it made: the harness hands them the same seeded
inputs and weights it hands the program."""
