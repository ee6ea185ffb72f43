"""gemma2-27b [dense] — local+global alternating attention, logit softcap.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118; hf]

head_dim=128 per the published model (q/k/v project to 32*128=4096, not
d_model).  Local layers use a 4096-token sliding window; attention logit
softcap 50.0, final logit softcap 30.0, gemma post-norms and sqrt(d)
embedding scaling.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    window_pattern=(4096, 0),  # local, global alternating
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norm=True,
    embed_scale=True,
    rope_theta=10000.0,
    tie_embeddings=True,
    subquadratic=False,  # global layers are full attention -> long_500k skipped
    source="arXiv:2408.00118",
)
