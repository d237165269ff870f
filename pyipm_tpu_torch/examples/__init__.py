"""Runnable examples of the port; each is ``python -m pyipm_tpu_torch.examples.<name> [--device cpu]``."""
