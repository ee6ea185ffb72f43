"""Per-device operation counts and roofline terms (`op_count`)."""
