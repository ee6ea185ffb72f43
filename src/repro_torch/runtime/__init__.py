"""runtime substrate."""
