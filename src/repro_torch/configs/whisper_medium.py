"""whisper-medium — encoder-decoder, conv frontend (stub) [arXiv:2212.04356]
(the reference's config).

24L decoder + 24L encoder, d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
The mel-spectrogram and conv feature extractor are a stub: the batch
carries precomputed frame embeddings (B, 1500, d_model). The encoder is
bidirectional (sinusoidal positions); the decoder is causal with learned
positions and cross-attention over the 1500-frame encoder output.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab=51865,
    norm="layernorm",
    act="gelu",
    qkv_bias=True,
    rope_theta=0.0,  # learned/sinusoidal positions, no rotary
    encoder_layers=24,
    encoder_seq=1500,
    max_seq=32_768,  # decoder learned-position table
)
