"""Measurement tools of the port: timing, the FP32 peak probe and the benches."""
