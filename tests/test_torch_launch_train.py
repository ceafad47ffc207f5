"""The port's training CLI (``repro_torch.launch.train``) on the CPU, as
tests/test_system.py:40-60 drive the reference's: a reduced granite-3-2b
whose loss falls through the fault-tolerant loop, and a second run that
resumes from the first one's checkpoint; the mesh-only flags are refused
naming ROADMAP item 11, and without a card the CLI raises unless it is
given ``--device cpu``."""
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
    with pytest.raises(NotImplementedError, match="item 11"):
        main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path),
              flag, *CPU])


def test_runs_on_the_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
    assert not list(tmp_path.glob("step_*"))


def test_mesh_train_steps_wait_for_item_11():
    from repro_torch.train import train_step
    with pytest.raises(NotImplementedError, match="item 11"):
        train_step.make_pod_parallel_train_step(None, None, None)
    with pytest.raises(NotImplementedError, match="item 11"):
        train_step.make_pipeline_train_step(None, None, None, None)
