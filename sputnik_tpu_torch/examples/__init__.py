"""Runnable examples of the PyTorch port (``python -m
sputnik_tpu_torch.examples.<name>``)."""
