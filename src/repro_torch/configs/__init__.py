"""Architecture registry: ``--arch <id>`` resolution.

All 10 assigned architectures plus the paper's own GPT-Neo models.
"""
from __future__ import annotations

from repro_torch.configs.base import (
    ArchConfig,
    LM_SHAPES,
    ModelConfig,
    MoEConfig,
    RunConfig,
    ShapeConfig,
    SSMConfig,
)

from repro_torch.configs import (  # noqa: E402
    gptneo,
    jamba_v0_1_52b,
    llama3_405b,
    mamba2_130m,
    mixtral_8x22b,
    qwen1_5_4b,
    qwen2_72b,
    qwen2_vl_72b,
    qwen3_moe_30b_a3b,
    whisper_small,
    yi_6b,
)

ARCHS: dict = {
    "mixtral-8x22b": mixtral_8x22b.ARCH,
    "qwen3-moe-30b-a3b": qwen3_moe_30b_a3b.ARCH,
    "qwen2-72b": qwen2_72b.ARCH,
    "llama3-405b": llama3_405b.ARCH,
    "yi-6b": yi_6b.ARCH,
    "qwen1.5-4b": qwen1_5_4b.ARCH,
    "jamba-v0.1-52b": jamba_v0_1_52b.ARCH,
    "qwen2-vl-72b": qwen2_vl_72b.ARCH,
    "mamba2-130m": mamba2_130m.ARCH,
    "whisper-small": whisper_small.ARCH,
    # paper's own models (benchmarks; not part of the 40-cell grid)
    "gptneo-s": ArchConfig(model=gptneo.GPTNEO_S, shapes=gptneo.PAPER_SHAPES),
    "gptneo-1.3b": ArchConfig(model=gptneo.GPTNEO_1_3B, shapes=gptneo.PAPER_SHAPES),
    "gptneo-2.7b": ArchConfig(model=gptneo.GPTNEO_2_7B, shapes=gptneo.PAPER_SHAPES),
}

ASSIGNED = [
    "mixtral-8x22b", "qwen3-moe-30b-a3b", "qwen2-72b", "llama3-405b",
    "yi-6b", "qwen1.5-4b", "jamba-v0.1-52b", "qwen2-vl-72b",
    "mamba2-130m", "whisper-small",
]


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = [
    "ARCHS", "ASSIGNED", "get_arch", "ArchConfig", "ModelConfig", "MoEConfig",
    "RunConfig", "ShapeConfig", "SSMConfig", "LM_SHAPES",
]
