"""Point-cloud and mesh operations of 3D registration: kNN, mesh losses and sampling, SDF."""
