"""A whole run of each cell on the CPU at a tiny size, past the harness's
look for a card, with the timed path sound and then broken underneath:
``correct`` holds for the sound run and comes out false for each fault
the cell can have, under the cell's own limits."""
import pytest
import torch

from helpers_tiny import tiny_run

SERVE = ["granite-3-2b.chat.poisson", "nemotron-4-15b.docqa.closed"]
TRAIN = "granite-3-2b.train.s2048"


@pytest.mark.parametrize("cell", SERVE + [TRAIN])
def test_a_sound_run_is_correct(cell):
    run = tiny_run(cell)
    assert run.correct, run.checks
    assert run.attempted > 0 and run.failed == 0


def test_a_traced_training_run_times_the_steps_after_the_profiler():
    run = tiny_run(TRAIN, seconds=1.2, trace=True, trace_s=0.3)
    assert run.correct, run.checks
    assert run.traced is not None
    assert run.untraced_steps > 0 and run.untraced_s > 0


@pytest.mark.parametrize("cell", SERVE)
def test_a_traced_serving_run_is_correct(cell):
    run = tiny_run(cell, trace=True, trace_s=0.5)
    assert run.correct, run.checks
    assert run.traced is not None and run.traced_steps


def altered_token(monkeypatch):
    """Every slot's token of each decode step replaced, where it is
    produced, by the one its logits rank last."""
    from repro_torch.serve.batching import ContinuousBatcher
    orig = ContinuousBatcher._step

    def step(self):
        logits = orig(self).clone()
        worst = logits[:, :self.cfg.vocab_size].argmin(1, keepdim=True)
        return logits.scatter(1, worst, 1e9)
    monkeypatch.setattr(ContinuousBatcher, "_step", step)


def unchanged_cache(monkeypatch):
    """A decode step that returns the cache as it found it: the new
    token's K/V never written."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "write_kv", lambda *a, **k: None)


@pytest.mark.parametrize("cell", SERVE)
@pytest.mark.parametrize("fault", [altered_token, unchanged_cache])
def test_a_serving_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    run = tiny_run(cell)
    assert not run.correct, run.checks


def unchanged_state(monkeypatch):
    """An optimizer step that leaves the parameters and its state as they
    were."""
    from repro_torch.train import optimizer

    def update(grads, state, params, tcfg):
        z = torch.zeros(())
        return params, state, {"lr": z, "grad_norm": z}
    monkeypatch.setattr(optimizer, "update", update)


def half_batch(monkeypatch):
    """The loss taken over half of each batch's rows, the mean over
    them."""
    from repro_torch.models.lm import LM
    orig = LM.train_loss

    def loss(self, batch):
        b = batch["tokens"].shape[0] // 2
        return orig(self, {k: v[:b] for k, v in batch.items()})
    monkeypatch.setattr(LM, "train_loss", loss)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch])
def test_a_training_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    run = tiny_run(TRAIN)
    assert not run.correct, run.checks
