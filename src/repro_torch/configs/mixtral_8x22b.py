"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention.

[arXiv:2401.04088; hf] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8e top-2, SWA. SWA window 4096 (v0.1 convention) makes the
arch sub-quadratic -> long_500k runs with a windowed KV cache.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, MoEConfig, RunConfig

MODEL = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=32768,
    sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff=16384),
    rope_theta=1e6,
    source="arXiv:2401.04088; hf",
)

ARCH = ArchConfig(
    model=MODEL,
    run_overrides={
        "train_4k": RunConfig(
            microbatch=64, fsdp=True, opt_moment_dtype="bfloat16",
            grad_accum_dtype="bfloat16",
        ),
    },
)
