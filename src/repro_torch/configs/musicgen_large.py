"""musicgen-large [audio] — decoder-only over EnCodec tokens; backbone only.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf]

The EnCodec frontend is a STUB per the assignment: `input_specs()`
provides precomputed frame embeddings (the codebook-sum embedding of the
delay-interleaved streams); decode embeds generated audio tokens through
the code embedding table (vocab 2048).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    rope_theta=10000.0,
    tie_embeddings=False,
    frontend="audio_stub",
    subquadratic=False,
    source="arXiv:2306.05284",
)
