"""qwen1.5-4b — MHA (kv == heads) dense decoder with QKV bias.

[hf:Qwen/Qwen1.5-4B; hf] 40L d_model=2560 20H (kv=20 -> MHA) d_ff=6912
vocab=151936. Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    num_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen1.5-4B",
)

ARCH = ArchConfig(
    model=MODEL,
    run_overrides={"train_4k": RunConfig(layout="dp")},  # §Perf iteration 8
)
