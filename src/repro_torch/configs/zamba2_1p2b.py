"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]

Faithfulness note (docs/design.md §5): Zamba2 interleaves one *shared*
full-attention block into the Mamba2 stack; we apply the shared block
after every `attn_every=2` Mamba2 layers (19 sites), matching the
alternation density of the reference model.  The per-site LoRA deltas of
the shared block are omitted (weight-sharing is the modelled feature).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,  # Mamba2 layers; shared attn applied every 2
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    d_inner_mult=2,
    attn_every=2,
    tie_embeddings=True,
    subquadratic=True,  # SSM backbone: long_500k runs (attention sites
    # hold the only KV caches; decode state is O(1) in the Mamba trunk)
    source="arXiv:2411.15242",
)
