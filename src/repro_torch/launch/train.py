"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \
        --steps 50 --ckpt-dir /tmp/ckpt

The JAX package's ``repro.launch.train`` with its flags, plus ``--device``
(``cuda``, the default, which raises without a card, or ``cpu`` with the
kernels' plain versions). ``--smoke`` takes the arch's reduced config;
without it the full config runs on the one device. Wires together:
config -> device env -> data stream -> train step (grad accumulation,
remat, AdamW) -> async checkpoints -> straggler and preemption handling.
Parameters are drawn from ``torch.Generator`` seed 0 (the reference's
``jax.random.PRNGKey(0)`` draws other numbers), so the two packages agree
only when started from one state (``models.model.params_from_numpy``).
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import (DataConfig, PrefetchIterator,
                                       SyntheticLMStream)
from repro_torch.distributed import sharding as shd
from repro_torch.ft.resilience import (PreemptionHandler, StragglerDetector,
                                       timed_step)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model as M
from repro_torch.training.optimizer import OptConfig, init_opt_state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model trains: the card with the CUDA "
                    "kernels, or the CPU with their plain versions")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.smoke:
        arch = replace(arch, model=arch.model.reduced())
    env = make_host_mesh(device=args.device)
    dev = env.device
    cfg = arch.model
    shape = ShapeConfig("train_cli", args.seq, args.batch, "train")
    run = arch.run_config(shape.name)

    opt_cfg = OptConfig(lr=args.lr, warmup=max(args.steps // 10, 5),
                        total_steps=args.steps,
                        moment_dtype=run.opt_moment_dtype)
    bundle = M.make_step_bundle(arch, shape, env, opt_cfg=opt_cfg)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    stream = SyntheticLMStream(dcfg)

    start_step = 0
    if args.resume and args.ckpt_dir and \
            ckpt.latest_step(args.ckpt_dir) is not None:
        state, extra = ckpt.restore(args.ckpt_dir, device=dev)
        params, opt_state = state["params"], state["opt"]
        start_step = int(extra.get("step", 0))
        stream.restore({"step": extra.get("data_step", start_step)})
        print(f"resumed from step {start_step}")
    else:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = shd.init_params(bundle.arg_specs[0], gen, dev)
        opt_state = init_opt_state(params, opt_cfg)

    saver = ckpt.AsyncCheckpointer(args.ckpt_dir) if args.ckpt_dir else None
    preempt = PreemptionHandler(install_signal=not args.smoke)
    straggler = StragglerDetector()
    it = PrefetchIterator(iter(stream), 2)

    losses = []
    for step in range(start_step, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        (params, opt_state, metrics), dt = timed_step(
            bundle.fn, params, opt_state, batch)
        straggler.record(0, dt)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
        if saver and (step + 1) % args.ckpt_every == 0:
            saver.submit(step + 1, {"params": params, "opt": opt_state},
                         extra={"step": step + 1,
                                "data_step": stream.checkpoint()["step"]})
        if preempt.should_stop():
            print("preemption requested: checkpointing and exiting")
            if saver:
                saver.submit(step + 1, {"params": params, "opt": opt_state},
                             extra={"step": step + 1,
                                    "data_step": stream.checkpoint()["step"]})
            break
    it.close()
    if saver:
        saver.close()
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
