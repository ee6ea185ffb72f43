"""llava-next-34b [vlm] — anyres tiling; backbone only.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The vision frontend (anyres patch tiler + projector) is a STUB per the
assignment: `input_specs()` provides precomputed patch embeddings
[B, S, d_model]; training/prefill consume them directly, decode embeds
generated text tokens through the LM table.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=10000.0,
    tie_embeddings=False,
    frontend="vision_stub",
    subquadratic=False,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf (unverified)",
)
