"""optim substrate."""
