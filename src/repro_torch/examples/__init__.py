"""Runnable examples of the PyTorch/CUDA port (``python -m
repro_torch.examples.<name>``)."""
