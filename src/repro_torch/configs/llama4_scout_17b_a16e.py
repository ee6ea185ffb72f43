"""llama4-scout-17b-a16e [moe] — MoE, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    rope_theta=500000.0,
    tie_embeddings=False,
    subquadratic=False,
    source="hf:meta-llama/Llama-4-Scout-17B-16E (unverified)",
    notes="All layers MoE top-1 per the assigned config; early-fusion "
    "multimodality enters as token embeddings (text path modelled).",
)
