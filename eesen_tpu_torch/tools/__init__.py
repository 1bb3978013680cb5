"""Command-line tools of the port (`python -m eesen_tpu_torch.tools.cli`)
and the timing scripts that compare two checkouts on one card."""
