"""ckpt substrate."""
