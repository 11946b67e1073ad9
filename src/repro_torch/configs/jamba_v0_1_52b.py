"""jamba-v0.1-52b — hybrid Mamba+attention with MoE.

[arXiv:2403.19887; hf] 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2. Attention:Mamba interleave 1:7 (one attention
layer per 8-layer period), MoE every other layer. Jamba ships Mamba-1; we
implement the interleave with the SSD (Mamba-2) mixer since SSD is the
MXU-native chunked-matmul formulation of the same selective-state-space
dynamics (DESIGN.md §2 hardware adaptation; d_state kept at Jamba's 16).
Hybrid -> long_500k runs.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, MoEConfig, RunConfig, SSMConfig

MODEL = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    attn_every=8,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, every=2),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=64, variant="mamba2"),
    rope="none",  # jamba uses no positional embedding in attention layers
    source="arXiv:2403.19887; hf",
)

ARCH = ArchConfig(
    model=MODEL,
    run_overrides={
        "train_4k": RunConfig(microbatch=64, fsdp=True, opt_moment_dtype="bfloat16"),
    },
)
