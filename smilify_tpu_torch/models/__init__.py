"""The neural regressors: backbones, heads, models, weight carrying."""
