"""Config system: model/shape/arch dataclasses and the registry.

Every assigned architecture is a ``ModelConfig`` (exact published dims) plus
the shared LM shape grid. Reduced configs for CPU smoke tests come from
``ModelConfig.reduced()`` which shrinks width/depth/experts but preserves the
family-specific structure (GQA ratio, MoE top-k, hybrid interleave, ...).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional


@dataclass(frozen=True)
class SSMConfig:
    """State-space mixer config (mamba-1 / mamba-2 SSD)."""
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64          # SSD head dim; mamba-1 behaviour == head_dim 1
    chunk: int = 256            # SSD chunk length
    variant: str = "mamba2"     # "mamba2" (SSD) | "mamba1" (diagonal selective scan)

    @property
    def d_inner(self) -> int:
        return -1  # resolved against d_model by the model code


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    d_ff: int = 16384           # per-expert FFN width
    every: int = 1              # MoE layer every `every` layers (jamba: 2)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | encdec
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope: str = "rope"          # rope | mrope | none | sinusoid
    rope_theta: float = 1e6
    sliding_window: int = 0     # 0 = full attention
    tie_embeddings: bool = False
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    act: str = "silu"           # silu | gelu
    glu: bool = True            # gated FFN (SwiGLU) vs plain 2-matmul FFN
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 1         # hybrid: attention layer every `attn_every`
                                # layers (jamba: 8 -> 1 attn + 7 mamba)
    encoder_layers: int = 0     # encdec only
    encoder_seq: int = 1500     # whisper frame count after conv stub
    frontend: str = "none"      # none | audio_stub | vision_stub
    dtype: str = "bfloat16"
    # --- notes/source ---
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k shape."""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window > 0
        )

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=max(2, min(4, self.num_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4),
            d_ff=128,
            vocab=256,
            head_dim=16,
        )
        if self.family == "hybrid":
            kw["num_layers"] = 8  # keep one full interleave period
        if self.moe is not None:
            kw["moe"] = replace(
                self.moe,
                n_experts=min(8, self.moe.n_experts),
                top_k=min(2, self.moe.top_k),
                d_ff=128,
            )
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=16, chunk=16)
        if self.encoder_layers:
            kw["encoder_layers"] = 2
            kw["encoder_seq"] = 32
        if self.sliding_window:
            kw["sliding_window"] = 32
        return replace(self, **kw)

    # ------------------------------------------------------------------
    # parameter counting (used by roofline MODEL_FLOPS and the OPG graph)
    # ------------------------------------------------------------------
    def layer_kinds(self) -> list:
        """Per-decoder-layer mixer kind: 'attn' | 'ssm'."""
        kinds = []
        for i in range(self.num_layers):
            if self.family == "ssm":
                kinds.append("ssm")
            elif self.family == "hybrid":
                # jamba: 1 attn per `attn_every` block, attn at index
                # attn_every//2 within each period
                kinds.append("attn" if i % self.attn_every == self.attn_every // 2 else "ssm")
            else:
                kinds.append("attn")
        return kinds

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        every = self.moe.every
        return i % every == (every - 1) if every > 1 else True

    def param_count(self, active_only: bool = False) -> int:
        """Total (or activated-path) parameter count, embeddings included."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = self.vocab * d  # embed
        if not self.tie_embeddings:
            total += self.vocab * d  # lm head
        ssm = self.ssm
        for i, kind in enumerate(self.layer_kinds()):
            total += d  # pre-mixer norm
            if kind == "attn":
                qkv = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
                if self.qkv_bias:
                    qkv += n_q * hd + 2 * (n_kv * hd)
                total += qkv
            else:
                d_in = ssm.expand * d
                nheads = d_in // ssm.head_dim
                # in_proj -> [z, x, B, C, dt], conv, A, D, out_proj, dt_bias
                total += d * (2 * d_in + 2 * ssm.d_state + nheads)
                total += ssm.d_conv * (d_in + 2 * ssm.d_state)
                total += nheads * 2 + nheads
                total += d_in * d
            total += d  # pre-ffn norm
            if self.layer_is_moe(i):
                m = self.moe
                e = m.top_k if active_only else m.n_experts
                per_expert = d * m.d_ff * (3 if self.glu else 2)
                total += e * per_expert + d * m.n_experts  # + router
            else:
                total += d * self.d_ff * (3 if self.glu else 2)
        # encoder (whisper)
        for _ in range(self.encoder_layers):
            qkv = 4 * d * d + (3 * d if self.qkv_bias else 0)
            total += 2 * d + qkv + d * self.d_ff * 2  # whisper ffn: plain gelu
            # decoder cross-attn counted in decoder loop? -> add here
        if self.encoder_layers:
            # decoder cross attention blocks (one per decoder layer)
            total += self.num_layers * (4 * d * d + d)
        total += d  # final norm
        return total


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode


LM_SHAPES = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


@dataclass(frozen=True)
class RunConfig:
    """Per-(arch,shape) runtime knobs for the distributed step."""
    microbatch: int = 0         # 0 -> no grad accumulation (= global batch)
    remat: str = "full"         # none | block | full
    fsdp: bool = False          # shard params/moments over data axis too
    seq_shard: bool = True      # sequence-parallel residual stream
    layout: str = "tp"          # tp (Megatron) | dp (pure DP + ZeRO-3)
    opt_moment_dtype: str = "float32"
    grad_accum_dtype: str = "float32"


@dataclass(frozen=True)
class ArchConfig:
    model: ModelConfig
    shapes: tuple = LM_SHAPES
    run_overrides: dict = field(default_factory=dict)  # shape name -> RunConfig

    def run_config(self, shape_name: str) -> RunConfig:
        return self.run_overrides.get(shape_name, RunConfig())

    def supported_shapes(self):
        out = []
        for s in self.shapes:
            if s.name == "long_500k" and not self.model.sub_quadratic:
                continue
            out.append(s)
        return out

    def skipped_shapes(self):
        return [s for s in self.shapes if s not in self.supported_shapes()]
