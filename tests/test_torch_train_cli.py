"""The port's training CLI (``repro_torch.launch.train``) on the CPU: it
converges and resumes as ``tests/test_system.py`` holds the JAX package's
CLI to, prints the same lines, checkpoints in the layout the JAX package
restores, stops on preemption with a checkpoint, trains every arch at its
reduced size (the MoE and hybrid ones too), and raises without a card
unless ``--device cpu`` is given.
"""
import re
import tempfile

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jax_ckpt
from repro_torch.checkpoint import ckpt
from repro_torch.launch import train
from torch_threads import one_torch_thread  # noqa: F401

STEP_LINE = re.compile(r"^step +\d+ loss \d+\.\d{4} gnorm \d+\.\d{3} "
                       r"lr \d\.\d\de[-+]\d\d \d+ms$")
DENSE_AND_SSM = ["yi-6b", "qwen1.5-4b", "qwen2-72b", "llama3-405b",
                 "mamba2-130m", "gptneo-s"]


def _cli(*args):
    return train.main(["--device", "cpu", "--smoke", "--batch", "4",
                       "--seq", "16", *args])


def test_training_converges_and_resumes():
    with tempfile.TemporaryDirectory() as d:
        l1 = train.main(["--device", "cpu", "--arch", "yi-6b", "--smoke",
                         "--steps", "12", "--batch", "8", "--seq", "32",
                         "--ckpt-dir", d, "--ckpt-every", "6",
                         "--log-every", "100"])
        l2 = train.main(["--device", "cpu", "--arch", "yi-6b", "--smoke",
                         "--steps", "18", "--batch", "8", "--seq", "32",
                         "--ckpt-dir", d, "--resume", "--log-every", "100"])
        assert len(l2) == 6          # resumed at step 12
        assert np.mean(l2) < l1[0]   # loss improved vs start


def test_ssm_training_converges_and_resumes(capsys):
    """The SSM family through the CLI at the dense test's settings above:
    Mamba-2's loss falls, and a resumed run starts at the checkpoint's
    step (on the card the same run goes through the ``ssd_scan`` kernels,
    forward and backward)."""
    with tempfile.TemporaryDirectory() as d:
        args = ["--device", "cpu", "--arch", "mamba2-130m", "--smoke",
                "--batch", "8", "--seq", "32", "--ckpt-dir", d,
                "--log-every", "100"]
        l1 = train.main([*args, "--steps", "12", "--ckpt-every", "6"])
        l2 = train.main([*args, "--steps", "18", "--resume"])
    assert len(l2) == 6                      # resumed at step 12
    assert all(np.isfinite(l1 + l2)) and np.mean(l2) < l1[0]
    assert "resumed from step 12" in capsys.readouterr().out


@pytest.mark.parametrize("arch", DENSE_AND_SSM)
def test_every_dense_and_ssm_arch_trains(arch, capsys):
    losses = _cli("--arch", arch, "--steps", "4", "--log-every", "1")
    assert len(losses) == 4 and all(np.isfinite(losses))
    lines = capsys.readouterr().out.strip().splitlines()
    assert sum(bool(STEP_LINE.match(line)) for line in lines) == 4, lines
    assert lines[-1] == f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})"


@pytest.mark.parametrize("log_every,printed", [(1, 5), (3, 3), (100, 2)])
def test_log_every_prints_those_steps_and_the_last(log_every, printed,
                                                   capsys):
    _cli("--steps", "5", "--log-every", str(log_every))
    out = capsys.readouterr().out.splitlines()
    assert sum(bool(STEP_LINE.match(line)) for line in out) == printed


def test_two_runs_give_the_same_losses():
    assert _cli("--steps", "3") == _cli("--steps", "3")


@pytest.mark.parametrize("arch", ["yi-6b", "mamba2-130m"])
def test_checkpoint_restores_in_the_jax_package(arch):
    with tempfile.TemporaryDirectory() as d:
        _cli("--arch", arch, "--steps", "4", "--ckpt-dir", d,
             "--ckpt-every", "2")
        assert ckpt.latest_step(d) == jax_ckpt.latest_step(d) == 4
        tree, extra = jax_ckpt.restore(d)
        mine, mine_extra = ckpt.restore(d, device="cpu")
    assert extra == mine_extra and extra["step"] == 4
    assert int(tree["opt"]["step"]) == int(mine["opt"]["step"]) == 4
    np.testing.assert_array_equal(
        np.asarray(tree["params"]["embed"]).astype(np.float32),
        mine["params"]["embed"].float().numpy())
    assert mine["params"]["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["yi-6b", "qwen1.5-4b"])
def test_preemption_checkpoints_and_resume_continues(arch, monkeypatch,
                                                     capsys):
    calls = []

    def should_stop(self):
        calls.append(1)
        return len(calls) == 3

    monkeypatch.setattr(train.PreemptionHandler, "should_stop", should_stop)
    with tempfile.TemporaryDirectory() as d:
        first = _cli("--arch", arch, "--steps", "8", "--ckpt-dir", d)
        assert len(first) == 3 and ckpt.latest_step(d) == 3
        assert "preemption requested" in capsys.readouterr().out
        monkeypatch.undo()
        rest = _cli("--arch", arch, "--steps", "8", "--ckpt-dir", d,
                    "--resume")
    assert len(rest) == 5
    assert "resumed from step 3" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mixtral-8x22b",
                                  "jamba-v0.1-52b"])
def test_every_moe_and_hybrid_arch_trains(arch, capsys):
    losses = _cli("--arch", arch, "--steps", "2", "--log-every", "1")
    assert len(losses) == 2 and all(np.isfinite(losses))
    lines = capsys.readouterr().out.strip().splitlines()
    assert sum(bool(STEP_LINE.match(line)) for line in lines) == 2, lines
    assert lines[-1] == f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})"


def test_moe_training_converges_and_resumes(capsys):
    """The MoE family through the CLI at the dense test's settings: the
    reduced Qwen3-30B-A3B's loss falls, and a resumed run starts at the
    checkpoint's step (on the card the same run goes through the
    ``flash_attention`` kernels, forward and backward)."""
    with tempfile.TemporaryDirectory() as d:
        args = ["--device", "cpu", "--arch", "qwen3-moe-30b-a3b", "--smoke",
                "--batch", "8", "--seq", "32", "--ckpt-dir", d,
                "--log-every", "100"]
        l1 = train.main([*args, "--steps", "12", "--ckpt-every", "6"])
        l2 = train.main([*args, "--steps", "18", "--resume"])
    assert len(l2) == 6                      # resumed at step 12
    assert all(np.isfinite(l1 + l2)) and np.mean(l2) < l1[0]
    assert "resumed from step 12" in capsys.readouterr().out


def test_without_device_cpu_the_cli_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "yi-6b", "--smoke", "--steps", "1"])
