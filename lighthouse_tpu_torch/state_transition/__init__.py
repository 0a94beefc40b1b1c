"""State transition pieces of the PyTorch/CUDA port (the epoch engine's
shuffle so far)."""
