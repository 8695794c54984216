"""Data parallelism over torch.distributed (``parallel.ddp``)."""
