"""Command-line tools of the port (`python -m halo2_tpu_torch.tools.<name>`)."""
