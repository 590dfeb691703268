"""Plain PyTorch references of the benchmark's cells."""
