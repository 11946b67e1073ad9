"""qwen2-vl-72b — VLM backbone (M-RoPE); vision frontend is a stub.

[arXiv:2409.12191; hf] 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064. The assignment specifies the transformer BACKBONE only;
``input_specs()`` provides precomputed patch embeddings plus the 3-axis
(temporal, h, w) M-RoPE position ids. Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="qwen2-vl-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope="mrope",
    rope_theta=1e6,
    frontend="vision_stub",
    source="arXiv:2409.12191; hf",
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
