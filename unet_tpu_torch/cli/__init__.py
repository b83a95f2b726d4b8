"""Command-line interface of the port (python -m unet_tpu_torch.cli)."""
