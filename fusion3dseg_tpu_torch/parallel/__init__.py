"""Training-step building blocks (one device; the mesh waits for multi-GPU)."""
