"""llama3-405b — the largest assigned dense config.

[arXiv:2407.21783; unverified] 126L d_model=16384 128H (GQA kv=8)
d_ff=53248 vocab=128256. Full attention -> long_500k skipped.

Training at this size requires FSDP over the data axis (ZeRO-3), bf16
optimizer moments and gradient accumulation; see RunConfig below and
EXPERIMENTS.md for the per-chip memory report.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="llama3-405b",
    family="dense",
    num_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=5e5,
    source="arXiv:2407.21783",
)

ARCH = ArchConfig(
    model=MODEL,
    run_overrides={
        "train_4k": RunConfig(
            microbatch=32, fsdp=True, opt_moment_dtype="bfloat16",
            grad_accum_dtype="bfloat16",
        ),
        "prefill_32k": RunConfig(fsdp=False),
    },
)
