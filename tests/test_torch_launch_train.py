"""The port's training CLI (``repro_torch.launch.train``) on the CPU, as
tests/test_system.py:40-60 drive the reference's: a reduced granite-3-2b
whose loss falls through the fault-tolerant loop, and a second run that
resumes from the first one's checkpoint; ``--pod-parallel`` and
``--compress`` on one rank's host mesh (no "pod" axis) fall back to the
plain step, as the reference's CLI does, and without a card the CLI
raises unless it is given ``--device cpu``."""
import pytest
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch.train import main

CPU = ["--device", "cpu"]


def test_training_loss_decreases_end_to_end(tmp_path):
    res = main(["--arch", "granite-3-2b", "--reduced", "--steps", "25",
                "--batch", "4", "--seq", "64", "--save-every", "10",
                "--ckpt-dir", str(tmp_path), "--log-every", "100", *CPU])
    losses = [h["loss"] for h in res.metrics_history if "loss" in h]
    assert losses[-1] < losses[0] - 0.2
    assert res.last_step == 25 and res.restarts == 0


def test_training_resumes_from_checkpoint(tmp_path):
    args = ["--arch", "granite-3-2b", "--reduced", "--batch", "2", "--seq",
            "32", "--save-every", "5", "--ckpt-dir", str(tmp_path),
            "--log-every", "100", *CPU]
    first = main(["--steps", "10", *args])
    saved, extra = Checkpointer(str(tmp_path)).restore(10)
    assert extra["next_step"] == 10
    for name, p in first.state["params"].items():
        assert torch.equal(saved["params"][name], p.detach()), name
    # second invocation resumes at step 10 and continues to 15
    res = main(["--steps", "15", *args])
    steps = [h["step"] for h in res.metrics_history]
    assert steps and min(steps) >= 10


@pytest.mark.parametrize("flag", ["--pod-parallel", "--compress"])
def test_mesh_flags_are_refused(tmp_path, flag):
    """Named for the refusal that the pod step replaced: on a host mesh of
    one rank each flag now falls back to the plain step, as the
    reference's CLI does, so one step's loss is the plain CLI's."""
    args = ["--reduced", "--steps", "1", "--batch", "2", "--seq", "32",
            *CPU]
    got = main([*args, "--ckpt-dir", str(tmp_path / "a"), flag])
    want = main([*args, "--ckpt-dir", str(tmp_path / "b")])
    assert [float(h["loss"]) for h in got.metrics_history] == [
        float(h["loss"]) for h in want.metrics_history]


def test_runs_on_the_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.glob("step_*"))


def test_mesh_train_steps_wait_for_item_11():
    """Named for the refusal that these steps replaced: the pod step now
    refuses only a mesh without a "pod" axis, and the pipelined step
    without a mesh runs its stages in turn (the reference's sequential
    fallback)."""
    import types

    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.dist.plan import Plan
    from repro_torch.models.lm import LM, init_params
    from repro_torch.train import optimizer, train_step
    cfg = get_config("granite-3-2b").reduced()
    lm = LM(cfg, init_params(cfg, device="cpu"))
    mesh = types.SimpleNamespace(mesh_dim_names=("data",), shape=(1,))
    with pytest.raises(ValueError, match="'pod' axis"):
        train_step.make_pod_parallel_train_step(lm, TrainConfig(), mesh)
    tcfg = TrainConfig(lr=1e-2, warmup_steps=1)
    ws = torch.full((2, 3, 3), 0.5)
    x, y = torch.ones(4, 3), torch.zeros(4, 3)
    step = train_step.make_pipeline_train_step(
        lambda w, h: torch.tanh(h @ w), tcfg, None, Plan())
    _, _, metrics = step(ws, optimizer.init({"stages": ws}, tcfg), (x, y),
                         0)
    want = torch.mean(torch.tanh(torch.tanh(x @ torch.full((3, 3), 0.5))
                                 @ torch.full((3, 3), 0.5)) ** 2)
    assert float(metrics["loss"]) == pytest.approx(float(want), rel=1e-6)
    assert (ws < 0.5).all()
