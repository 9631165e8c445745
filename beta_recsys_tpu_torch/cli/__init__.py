"""Command-line entry points: ``python -m beta_recsys_tpu_torch.cli.<name>``."""
