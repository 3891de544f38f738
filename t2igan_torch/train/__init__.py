"""Inference and (in later slices) training steps of the port."""
