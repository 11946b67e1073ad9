"""qwen3-moe-30b-a3b — fine-grained 128-expert top-8 MoE.

[hf:Qwen/Qwen3-30B-A3B; hf] 48L d_model=2048 32H (GQA kv=4) per-expert
d_ff=768 vocab=151936, MoE 128e top-8, head_dim=128 (decoupled from
d_model/n_heads as in the released model). Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, MoEConfig, RunConfig

MODEL = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab=151936,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff=768),
    rope_theta=1e6,
    source="hf:Qwen/Qwen3-30B-A3B",
)

ARCH = ArchConfig(
    model=MODEL,
    run_overrides={
        "train_4k": RunConfig(microbatch=128, fsdp=True),
    },
)
