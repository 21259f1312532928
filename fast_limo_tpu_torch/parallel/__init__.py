"""Multi-session layers (one card: ``batched``)."""
