"""mamba2-130m — attention-free SSD (state-space duality).

[arXiv:2405.21060; unverified] 24L d_model=768, vocab=50280, ssm_state=128,
expand=2 (d_inner=1536), SSD head_dim=64 -> 24 heads. Decode state is O(1)
per layer; decode_32k / long_500k cost does not scale with cache length.
"""
from repro_torch.configs.base import ArchConfig, ModelConfig, RunConfig, SSMConfig

MODEL = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    rope="none",
    glu=False,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, variant="mamba2"),
    source="arXiv:2405.21060",
)

ARCH = ArchConfig(
    model=MODEL,
    run_overrides={"train_4k": RunConfig(layout="dp")},  # §Perf iteration 8
)
