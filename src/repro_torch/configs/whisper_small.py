"""whisper-small — encoder-decoder with audio conv frontend stub.

[arXiv:2212.04356; unverified] 12L encoder + 12L decoder, d_model=768,
12H (MHA), d_ff=3072, vocab=51865. The conv frontend is a STUB per the
assignment: ``input_specs()`` provides precomputed frame embeddings
(batch, 1500, d_model). Whisper uses LayerNorm + GELU + plain FFN +
sinusoidal/learned positions; attention is full -> long_500k skipped.

decode shapes lower the decoder step (self-KV cache of seq_len + cross-KV
over the 1500 encoder frames); the 32k self-context is structural (the
released model caps at 448) and is noted in EXPERIMENTS.md.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="whisper-small",
    family="encdec",
    num_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    qkv_bias=True,
    rope="none",
    norm="layernorm",
    act="gelu",
    glu=False,
    encoder_layers=12,
    encoder_seq=1500,
    frontend="audio_stub",
    source="arXiv:2212.04356",
)

ARCH = ArchConfig(
    model=MODEL,
    run_overrides={"train_4k": RunConfig(layout="dp")},  # §Perf iteration 8
)
