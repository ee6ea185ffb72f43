"""train substrate."""
