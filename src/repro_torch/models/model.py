"""Model facade: (arch x shape) -> step function + the ParamSpec trees of
its inputs, and the real tensors for tests and the smoke run.

The JAX package's ``repro.models.model`` for the ``prefill`` and ``decode``
kinds of the SSM, dense, MoE and hybrid families (``transformer``) and of
the enc-dec family (``encdec``), and for the ``train`` kind of every
family (``training.trainer.make_train_step``; an MoE block through the
differentiable dispatch and combine of ``models.moe``). The JAX
package's ``lower_step`` is its dry run's XLA lowering; the port's dry run
(``launch/dryrun.py``) traces the bundle's function on the ``meta``
device instead. ``params_from_numpy`` carries a JAX parameter tree
(or decode cache, or optimizer state), mapped through ``np.asarray``, into
the port's tensors with the same dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import MeshEnv, ParamSpec
from repro_torch.models import encdec, transformer
from repro_torch.models.context_parallel import cp_prefill
from repro_torch.training.optimizer import OptConfig, opt_state_specs
from repro_torch.training.trainer import make_train_step


def param_specs(cfg: ModelConfig):
    if cfg.family == "encdec":
        return encdec.param_specs(cfg)
    return transformer.param_specs(cfg)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    if cfg.family == "encdec":
        return encdec.cache_specs(cfg, batch, cache_len)
    return transformer.cache_specs(cfg, batch, cache_len)


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapeConfig, *, train: bool) -> dict:
    b, s = shape.global_batch, shape.seq_len
    tok = ParamSpec((b, s), torch.int32, ("batch", None))
    out = {}
    if cfg.frontend == "vision_stub":
        out["embeds"] = ParamSpec((b, s, cfg.d_model), torch.bfloat16,
                                  ("batch", None, None))
        out["positions"] = ParamSpec((3, b, s), torch.int32,
                                     (None, "batch", None))
    elif cfg.frontend == "audio_stub":
        out["frames"] = ParamSpec((b, cfg.encoder_seq, cfg.d_model),
                                  torch.bfloat16, ("batch", None, None))
        out["tokens"] = tok
    else:
        out["tokens"] = tok
    if train:
        out["targets"] = ParamSpec((b, s), torch.int32, ("batch", None))
    return out


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    b = shape.global_batch
    pos_shape, pos_logical = ((3, b), (None, "batch")) \
        if cfg.rope == "mrope" else ((b,), ("batch",))
    return {
        "cache": cache_specs(cfg, b, shape.seq_len),
        "tokens": ParamSpec((b, 1), torch.int32, ("batch", None)),
        "pos": ParamSpec(pos_shape, torch.int32, pos_logical),
    }


# ---------------------------------------------------------------------------
# step bundles
# ---------------------------------------------------------------------------

# the JAX package's attention schedules: its block grid ("full", "banded",
# "paired") and context-parallel prefill ("cp")
ATTN_MODES = ("full", "banded", "paired", "cp")


@dataclass
class StepBundle:
    """One (arch x shape) step: the function and its inputs' spec trees."""
    fn: Callable                 # the step, on tensors
    arg_specs: tuple             # ParamSpec trees, in call order
    # the inputs the step updates in place (a train step's params and
    # optimizer state); it records that for the caller and feeds nothing
    donate: tuple = ()


def make_step_bundle(arch: ArchConfig, shape: ShapeConfig, env: MeshEnv, *,
                     opt_cfg: Optional[OptConfig] = None,
                     attn_mode: str = "paired",
                     seq_shards: Optional[int] = None) -> StepBundle:
    """The step of ``shape.kind``. A prefill batch carries ``tokens``,
    ``embeds`` and ``positions`` for the vision stub, or ``frames`` and
    ``tokens`` for the audio stub (enc-dec); decode takes ``pos`` [B]
    ([3,B] under M-RoPE).

    ``attn_mode`` is one of ``ATTN_MODES`` and computes the same prefill
    in each: the block-grid schedules leave the function unchanged, and
    ``"cp"`` routes a dense config without M-RoPE to
    ``context_parallel.cp_prefill`` (the JAX package's rule) over
    ``seq_shards`` sequence shards in turn, the env's model axis by
    default (1 on one card, where it is bit for bit the ordinary
    prefill).

    A train step is ``fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` (``batch_specs(train=True)``), AdamW under ``opt_cfg``
    (the run config's moment dtype by default); it updates ``params`` and
    ``opt_state`` in place (``donate``)."""
    if attn_mode not in ATTN_MODES:
        raise ValueError(f"attn_mode {attn_mode!r} is not one of "
                         f"{ATTN_MODES}")
    cfg = arch.model
    run = arch.run_config(shape.name)
    pspecs = param_specs(cfg)

    if shape.kind == "train":
        opt_cfg = opt_cfg or OptConfig(moment_dtype=run.opt_moment_dtype)
        step = make_train_step(cfg, run, env, opt_cfg)
        return StepBundle(fn=step, arg_specs=(
            pspecs, opt_state_specs(pspecs, opt_cfg),
            batch_specs(cfg, shape, train=True)), donate=(0, 1))

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            def fn(params, batch):
                return encdec.prefill(cfg, run, env, params, batch)
        elif (attn_mode == "cp" and cfg.family == "dense"
              and cfg.rope != "mrope"):
            def fn(params, batch):
                return cp_prefill(cfg, run, env, params, batch["tokens"],
                                  seq_shards=seq_shards)
        else:
            def fn(params, batch):
                return transformer.prefill(
                    cfg, run, env, params, batch.get("tokens"),
                    embeds=batch.get("embeds"),
                    positions=batch.get("positions"))
        return StepBundle(fn=fn, arg_specs=(
            pspecs, batch_specs(cfg, shape, train=False)))

    step = encdec.decode_step if cfg.family == "encdec" \
        else transformer.decode_step

    def fn(params, cache, tokens, pos):
        return step(cfg, run, env, params, cache, tokens, pos)
    dspecs = decode_input_specs(cfg, shape)
    return StepBundle(fn=fn, arg_specs=(pspecs, dspecs["cache"],
                                        dspecs["tokens"], dspecs["pos"]))


# ---------------------------------------------------------------------------
# real tensors
# ---------------------------------------------------------------------------

def init_inputs(bundle: StepBundle, generator: torch.Generator,
                device: DeviceLike = None) -> tuple:
    """Random/zero tensors matching the bundle's arg specs, on ``device``.
    Integer inputs are drawn in [0, 2), as the JAX package draws them."""
    dev = resolve_device(device)

    def mk(s: ParamSpec):
        if not s.dtype.is_floating_point:
            return torch.randint(0, 2, s.shape, generator=generator,
                                 dtype=s.dtype,
                                 device=generator.device).to(dev)
        return shd.init_params(s, generator, dev)
    return tuple(shd.spec_map(mk, tree) for tree in bundle.arg_specs)


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")           # a writable copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bf16: torch refuses it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device: DeviceLike = None):
    """A tree of numpy arrays (a JAX parameter tree, decode cache or
    optimizer state ``{"m", "v", "step"}`` through ``np.asarray``) as
    tensors on ``device``, dtypes kept."""
    dev = resolve_device(device)
    return shd.tree_map(lambda a: _tensor(a, dev), tree)


__all__ = ["param_specs", "cache_specs", "batch_specs", "decode_input_specs",
           "StepBundle", "make_step_bundle", "init_inputs",
           "params_from_numpy"]
