"""The reference's four examples as PyTorch scripts, run as
`python -m repro_torch.examples.<name> [--device cpu]` (on the card by
default)."""
