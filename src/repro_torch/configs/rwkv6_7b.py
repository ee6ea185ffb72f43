"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.

32L d_model=4096 (attn-free) d_ff=14336 vocab=65536
[arXiv:2404.05892; hf]
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # wkv heads (d_model / rwkv_head_dim); no attention
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    tie_embeddings=False,
    subquadratic=True,  # O(1)-state decode: long_500k runs
    source="arXiv:2404.05892",
)
