"""Data parallelism across processes (torch.distributed)."""
