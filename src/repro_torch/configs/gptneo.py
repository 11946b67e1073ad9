"""GPT-Neo family — the paper's own evaluation models (Tables 1/4/7/8).

GPT-Neo uses alternating global/local (sliding-window 256) attention,
LayerNorm, GELU, learned positions, MHA, no GLU. Used by the FlashMem
benchmarks (latency/memory/solver tables); reduced variants run on CPU.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, ShapeConfig

_COMMON = dict(
    family="dense",
    rope="none",
    norm="layernorm",
    act="gelu",
    glu=False,
    tie_embeddings=True,
    vocab=50257,
    source="EleutherAI/gpt-neo",
)

GPTNEO_S = ModelConfig(
    name="gptneo-s", num_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, **_COMMON)

GPTNEO_1_3B = ModelConfig(
    name="gptneo-1.3b", num_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, **_COMMON)

GPTNEO_2_7B = ModelConfig(
    name="gptneo-2.7b", num_layers=32, d_model=2560, n_heads=20, n_kv_heads=20,
    d_ff=10240, **_COMMON)

PAPER_SHAPES = (
    ShapeConfig("paper_1k", 1024, 1, "prefill"),
    ShapeConfig("paper_decode", 1024, 1, "decode"),
)

ARCH = ArchConfig(model=GPTNEO_1_3B, shapes=PAPER_SHAPES)
