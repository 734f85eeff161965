"""Device-side DSP ops (JAX/XLA) and signal synthesis utilities."""
