"""Measurement entry points of the port, run as `python3 -m
fluctus_tpu_torch.scripts.<name>` on a CUDA card."""
