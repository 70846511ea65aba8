"""Training support: the device-resident data cache (the trainers follow
with the neural models)."""
