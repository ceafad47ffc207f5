"""The plain reference agrees with the port's LM on the CPU at a reduced
size, so its equations are the port's: a prefill and decode steps, and
the first training steps."""
import pytest
import torch

from portbench import weights
from portbench.harness import model_config
from portbench.reference import lm as reflm
from helpers_tiny import tiny_run, tiny_cfg

CONFIGS = ["granite-3-2b", "nemotron-4-15b"]


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_and_decode_match_the_port(name):
    from repro_torch.dist.plan import Plan
    from repro_torch.models.lm import LM
    cfg = tiny_cfg(name)
    seed, v = 2 ** 32 + 3, cfg["vocab_size"]
    lm = LM(model_config(cfg), weights.draw(cfg, seed, "cpu"), Plan())
    p = weights.draw(cfg, seed, "cpu")
    toks = torch.randint(0, v, (20,), generator=torch.Generator()
                         .manual_seed(1))
    logits, cache = lm.prefill({"tokens": toks[None]}, 64)
    got = [logits[0, :v]]
    seq = toks.tolist()
    for _ in range(5):
        seq.append(int(got[-1].argmax()))
        logits, cache = lm.decode_step(cache, torch.tensor([[seq[-1]]]),
                                       len(seq) - 1)
        got.append(logits[0, :v])
    h = reflm.hidden_states([torch.tensor(seq)], p, cfg)[0]
    want = reflm.logits(h[len(toks) - 1:], p, cfg, reflm.mm_fp32)
    got = torch.stack(got)
    scale = want.abs().max()
    assert float((got - want).abs().max() / scale) < 2e-5
    served = torch.tensor(seq[len(toks):])
    rows = reflm.served_logits([toks], [served], p, cfg)[0]
    assert torch.allclose(rows, want[:len(served)], rtol=0,
                          atol=1e-5 * float(scale))
    assert float(reflm.gaps(rows, served).max()) < 1e-5
    assert reflm.logit_error(got[:len(served)], rows) < 2e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_training_steps_match_the_port(name):
    from helpers_tiny import cell, tiny_mix
    from portbench import harness
    c = cell("granite-3-2b.train.s2048")
    run = harness.Run(c, 77, 0.3, False, torch.device("cpu"), 0.0,
                      cfg=tiny_cfg(name), mix=tiny_mix(c["traffic"]))
    harness.execute(run)
    for key, (value, _, _) in run.checks.items():
        assert value < 1e-4, (key, value)
    ref = run.readings["reference"]
    assert len(ref["losses"]) == 3 and ref["losses"][0] > 1.0
    assert min(ref["change_norms"].values()) > 0


def test_fp8_control_moves_the_logits():
    cfg = tiny_cfg()
    p = weights.draw(cfg, 5, "cpu")
    toks = torch.randint(0, cfg["vocab_size"], (30,),
                         generator=torch.Generator().manual_seed(2))
    hi = reflm.hidden_states([toks], p, cfg)[0]
    lo = reflm.hidden_states([toks], p, cfg, reflm.mm_fp8)[0]
    err = float((hi - lo).abs().max() / hi.abs().max())
    assert 1e-3 < err < 0.5
    ref = reflm.served_logits([toks[:10]], [toks[10:]], p, cfg)[0]
    low = reflm.served_logits([toks[:10]], [toks[10:]], p, cfg,
                              reflm.mm_fp8)[0]
    assert ref.shape == (20, cfg["vocab_size"])
    assert reflm.logit_error(low, ref) > 10 * reflm.logit_error(ref, ref)
    gaps = reflm.gaps(ref, low.argmax(-1))
    assert float(gaps.min()) >= 0 and gaps.numel() == 20
    assert float(reflm.gaps(ref[:2], torch.tensor([-1, 10 ** 6])).min()) \
        == float("inf")


def test_tiny_serving_run_judges_its_requests():
    run = tiny_run("granite-3-2b.chat.poisson")
    assert run.checks["judged_tokens"][0] > 0
    assert run.checks["gap_max"][0] < 1e-5
    assert run.checks["logit_err"][0] < 1e-4
