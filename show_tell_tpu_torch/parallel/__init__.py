"""Data parallelism over torch.distributed (counterpart of show_tell_tpu/parallel/)."""
