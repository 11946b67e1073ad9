"""Model facade: (arch x shape) -> step function + the ParamSpec trees of
its inputs, and the real tensors for tests and the smoke run.

The JAX package's ``repro.models.model`` for the ``prefill`` and ``decode``
kinds of the SSM, dense and MoE families (and of a dense stack whose
``moe`` config makes its FFN an MoE block). ``train`` waits for the
training slice, and the hybrid and enc-dec families for their own
(``ROADMAP.md`` §1);
``lower_step`` is the dry-run's XLA lowering and waits with
``launch/dryrun.py``. ``params_from_numpy`` carries a JAX parameter tree
(or decode cache), mapped through ``np.asarray``, into the port's tensors
with the same dtypes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import MeshEnv, ParamSpec
from repro_torch.models import transformer


def _check_family(cfg: ModelConfig) -> None:
    """The SSM, dense and MoE families run; the hybrid family raises in
    ``transformer`` and the enc-dec family here, each naming its slice."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            "the enc-dec family (Whisper) is not ported yet; see ROADMAP.md "
            "§1 for its slice")


def param_specs(cfg: ModelConfig):
    _check_family(cfg)
    return transformer.param_specs(cfg)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    _check_family(cfg)
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


def make_step_bundle(arch: ArchConfig, shape: ShapeConfig, env: MeshEnv, *,
                     attn_mode: str = "paired") -> StepBundle:
    """The step of ``shape.kind``. A prefill batch carries ``tokens``, or
    ``embeds`` and ``positions`` for the vision stub; decode takes ``pos``
    [B] ([3,B] under M-RoPE).

    ``attn_mode`` is one of ``ATTN_MODES`` and computes the same prefill
    in each: the block-grid schedules leave the function unchanged, and
    ``"cp"`` on one device (one model shard, the query chunk at offset 0,
    the weight and K/V gathers identities) is the ordinary prefill. Its
    sharding across devices waits for the mesh slice (``ROADMAP.md`` §1,
    "Mesh and analysis")."""
    if attn_mode not in ATTN_MODES:
        raise ValueError(f"attn_mode {attn_mode!r} is not one of "
                         f"{ATTN_MODES}")
    cfg = arch.model
    run = arch.run_config(shape.name)
    if shape.kind == "train":
        raise NotImplementedError(
            "training steps are not ported yet; see ROADMAP.md §1 for the "
            "training slice")
    pspecs = param_specs(cfg)

    if shape.kind == "prefill":
        def fn(params, batch):
            return transformer.prefill(
                cfg, run, env, params, batch.get("tokens"),
                embeds=batch.get("embeds"), positions=batch.get("positions"))
        return StepBundle(fn=fn, arg_specs=(
            pspecs, batch_specs(cfg, shape, train=False)))

    def fn(params, cache, tokens, pos):
        return transformer.decode_step(cfg, run, env, params, cache, tokens,
                                       pos)
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
    """A tree of numpy arrays (a JAX parameter tree or decode cache through
    ``np.asarray``) as tensors on ``device``, dtypes kept."""
    dev = resolve_device(device)
    return shd.tree_map(lambda a: _tensor(a, dev), tree)


__all__ = ["param_specs", "cache_specs", "batch_specs", "decode_input_specs",
           "StepBundle", "make_step_bundle", "init_inputs",
           "params_from_numpy"]
