"""Data parallelism over the cards of one machine (torch.distributed)."""
