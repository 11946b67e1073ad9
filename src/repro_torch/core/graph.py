"""Operator graph for overlap planning.

The DAG G=(V,E) of §3.1: nodes are low-level operators in execution order
(the linearization is produced by the model code); each weight has a
single first-consuming op ``i_w``. Op *classes* follow Table 5:

  elemental    — elementwise/activation/add: low mem-bw, LOW compute,
                 medium-to-huge load tolerance (300% threshold)
  reusable     — matmul/conv: structured reuse, HIGH load tolerance (20%)
  hierarchical — softmax/layernorm/attention: stepwise sync, 0% tolerance

Builders turn a ModelConfig into the lowered op sequence (mirroring the
paper's "# Layers = low-level operator nodes after graph lowering").
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig

ELEMENTAL, REUSABLE, HIERARCHICAL = "elemental", "reusable", "hierarchical"

KIND_CLASS = {
    "matmul": REUSABLE, "conv": REUSABLE, "embed": REUSABLE,
    "add": ELEMENTAL, "activation": ELEMENTAL, "elementwise": ELEMENTAL,
    "rope": ELEMENTAL, "gate": ELEMENTAL,
    "softmax": HIERARCHICAL, "layernorm": HIERARCHICAL,
    "rmsnorm": HIERARCHICAL, "attention": HIERARCHICAL, "ssd": HIERARCHICAL,
    "router": HIERARCHICAL,
}


@dataclass(frozen=True)
class WeightRef:
    name: str
    bytes: int
    consumer: int          # i_w: index of the (unique) first consuming op


@dataclass
class Op:
    index: int
    name: str
    kind: str
    flops: float = 0.0
    act_bytes: float = 0.0           # activation bytes touched
    weights: tuple = ()              # weight names consumed here
    fused_from: tuple = ()           # op names merged into this node
    layer: int = -1                  # source decoder layer (for reports)

    @property
    def op_class(self) -> str:
        return KIND_CLASS.get(self.kind, ELEMENTAL)


@dataclass
class ModelGraph:
    name: str
    ops: List[Op] = field(default_factory=list)
    weights: Dict[str, WeightRef] = field(default_factory=dict)

    def add_op(self, name: str, kind: str, *, flops=0.0, act_bytes=0.0,
               weight_bytes: Optional[int] = None, layer: int = -1) -> Op:
        idx = len(self.ops)
        wnames = ()
        if weight_bytes:
            wname = f"{name}.w"
            self.weights[wname] = WeightRef(wname, int(weight_bytes), idx)
            wnames = (wname,)
        op = Op(idx, name, kind, flops=flops, act_bytes=act_bytes,
                weights=wnames, layer=layer)
        self.ops.append(op)
        return op

    @property
    def total_weight_bytes(self) -> int:
        return sum(w.bytes for w in self.weights.values())

    def weight_consumers(self) -> Dict[str, int]:
        return {w.name: w.consumer for w in self.weights.values()}

    def validate(self):
        for i, op in enumerate(self.ops):
            assert op.index == i
            for wn in op.weights:
                assert self.weights[wn].consumer == i
        return True


# ---------------------------------------------------------------------------
# graph construction
# ---------------------------------------------------------------------------

def build_lm_graph(cfg: ModelConfig, *, seq: int = 1024, batch: int = 1,
                   dtype_bytes: int = 2) -> ModelGraph:
    """Lower a decoder-only / hybrid / ssm / encdec ModelConfig to the op
    sequence the runtime executes (one node per low-level operator)."""
    g = ModelGraph(cfg.name)
    d, hd = cfg.d_model, (cfg.resolved_head_dim if cfg.n_heads else 0)
    t = seq * batch
    act = t * d * dtype_bytes

    g.add_op("embed", "embed", flops=0, act_bytes=act,
             weight_bytes=cfg.vocab * d * dtype_bytes, layer=-1)

    def norm(i, tag):
        g.add_op(f"L{i}.{tag}", cfg.norm, flops=5 * t * d, act_bytes=2 * act,
                 weight_bytes=d * 4, layer=i)

    def matmul(i, tag, fin, fout, bias=False):
        wb = fin * fout * dtype_bytes + (fout * 4 if bias else 0)
        g.add_op(f"L{i}.{tag}", "matmul", flops=2.0 * t * fin * fout,
                 act_bytes=t * (fin + fout) * dtype_bytes,
                 weight_bytes=wb, layer=i)

    kinds = cfg.layer_kinds()
    for i, kind in enumerate(kinds):
        norm(i, "norm1")
        if kind == "attn":
            nq, nkv = cfg.n_heads, cfg.n_kv_heads
            matmul(i, "wq", d, nq * hd, cfg.qkv_bias)
            matmul(i, "wk", d, nkv * hd, cfg.qkv_bias)
            matmul(i, "wv", d, nkv * hd, cfg.qkv_bias)
            if cfg.rope != "none":
                g.add_op(f"L{i}.rope", "rope", flops=4 * t * nq * hd,
                         act_bytes=2 * t * nq * hd * dtype_bytes, layer=i)
            w = cfg.sliding_window or seq
            eff = min(w, seq)
            g.add_op(f"L{i}.attn", "attention",
                     flops=4.0 * batch * seq * eff * nq * hd / 2,
                     act_bytes=4 * t * nq * hd * dtype_bytes, layer=i)
            matmul(i, "wo", nq * hd, d)
        else:
            s = cfg.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            matmul(i, "in_proj", d, 2 * d_in + 2 * s.d_state + nheads)
            g.add_op(f"L{i}.conv", "conv",
                     flops=2 * t * s.d_conv * (d_in + 2 * s.d_state),
                     act_bytes=2 * t * d_in * dtype_bytes,
                     weight_bytes=s.d_conv * (d_in + 2 * s.d_state) * 4,
                     layer=i)
            g.add_op(f"L{i}.ssd", "ssd",
                     flops=4.0 * t * s.chunk * d_in + 4.0 * t * s.d_state * d_in,
                     act_bytes=4 * t * d_in * dtype_bytes, layer=i)
            matmul(i, "out_proj", d_in, d)
        g.add_op(f"L{i}.res1", "add", flops=t * d, act_bytes=2 * act, layer=i)
        norm(i, "norm2")
        if cfg.layer_is_moe(i):
            m = cfg.moe
            g.add_op(f"L{i}.router", "router", flops=2 * t * d * m.n_experts,
                     act_bytes=act, weight_bytes=d * m.n_experts * 4, layer=i)
            # experts are individually streamable weights
            per = d * m.d_ff * dtype_bytes
            toks = t * m.top_k / m.n_experts
            for e in range(m.n_experts):
                wb = per * (3 if cfg.glu else 2)
                g.add_op(f"L{i}.exp{e}", "matmul",
                         flops=2.0 * toks * d * m.d_ff * (3 if cfg.glu else 2),
                         act_bytes=2 * toks * d * dtype_bytes,
                         weight_bytes=wb, layer=i)
        else:
            matmul(i, "ffn_in", d, cfg.d_ff)
            if cfg.glu:
                matmul(i, "ffn_gate", d, cfg.d_ff)
            g.add_op(f"L{i}.act", "activation", flops=4 * t * cfg.d_ff,
                     act_bytes=2 * t * cfg.d_ff * dtype_bytes, layer=i)
            matmul(i, "ffn_out", cfg.d_ff, d)
        g.add_op(f"L{i}.res2", "add", flops=t * d, act_bytes=2 * act, layer=i)

    norm(len(kinds), "final_norm")
    if not cfg.tie_embeddings:
        matmul(len(kinds), "lm_head", d, cfg.vocab)
    g.validate()
    return g
