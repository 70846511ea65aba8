"""Training support: configs, checkpoints, staging, splits, the device-resident
data cache and the benchmark accumulator (the trainers follow)."""
