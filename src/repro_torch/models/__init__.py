"""Model code of the port (the attention families: dense and MoE)."""
