"""data substrate."""
