"""Model code of the port: the attention families (dense, MoE and the
stub frontends), the hybrid (Mamba2 + a shared attention block) and the
ssm family (RWKV6)."""
