"""Runnable examples of the port as a library (`python -m
vectorsearch_tpu_torch.examples.<name>`)."""
