"""qwen2-72b — dense GQA decoder with QKV bias.

[arXiv:2407.10671; hf] 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064. Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    source="arXiv:2407.10671; hf",
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
