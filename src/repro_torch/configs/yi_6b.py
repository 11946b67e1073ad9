"""yi-6b — llama-architecture dense GQA.

[arXiv:2403.04652; hf] 32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, RunConfig

MODEL = ModelConfig(
    name="yi-6b",
    family="dense",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
    rope_theta=5e6,
    source="arXiv:2403.04652; hf",
)

ARCH = ArchConfig(
    model=MODEL,
    run_overrides={
        # 6B params on 256 chips: TP=16 is collective-bound; pure DP+ZeRO-3
        # cuts the collective term 8.5x (EXPERIMENTS.md §Perf iteration 8)
        "train_4k": RunConfig(layout="dp"),
    },
)
