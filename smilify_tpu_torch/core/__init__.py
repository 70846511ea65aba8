"""Model asset format, rotations and linear blend skinning."""
