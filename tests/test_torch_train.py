"""The port's training forward and step against the JAX package on the CPU,
fp32, on the JAX ``Model.init`` weights carried across by
``repro_torch.models.convert`` and the JAX pipeline's batch through numpy:
``LM.train_loss`` and every parameter's gradient against
``jax.value_and_grad(Model.train_loss)`` for every config at ``reduced()``
(and recurrentgemma-2b at 5 layers, whose third block is its local
attention), the chunked loss across ``vocab_chunk``, the gradients across
``remat``, and one ``make_train_step`` (1 and 2 microbatches) against the
reference's: new parameters, moments, count, loss, lr and grad norm."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import SyntheticTokens as JaxTokens
from repro.data.pipeline import data_config_for as jax_data_config
from repro.dist.plan import Plan as JaxPlan
from repro.models.lm import Model
from repro.train import train_step as jax_train_step
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import TrainConfig
from repro_torch.dist.plan import Plan
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.lm import LM
from repro_torch.train import optimizer, train_step

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4         # of each leaf's largest gradient
# a leaf whose gradient is 0 in exact arithmetic (a key bias: softmax
# ignores a constant added to a row's scores) reads rounding noise of
# about 1e-9 on both sides: each leaf's largest gradient is floored at
# this share of the largest gradient of any leaf
GRAD_FLOOR = 1e-4
SEQ, BATCH = 16, 2
CONFIGS = sorted(ARCHS) + ["recurrentgemma-2b:5"]


def _configs(name, **plan):
    """(JAX config, port config, JAX plan, port plan) of ``name`` at
    ``reduced()`` (``arch:L`` keeps L layers)."""
    arch, _, layers = name.partition(":")
    jc, pc = jax_config(arch).reduced(), get_config(arch).reduced()
    if layers:
        jc = dataclasses.replace(jc, n_layers=int(layers))
        pc = dataclasses.replace(pc, n_layers=int(layers))
    return jc, pc, JaxPlan(**plan), Plan(**plan)


def _pair(name, seed=0, **plan):
    """(JAX model, JAX params, port LM, numpy batch) on one set of weights
    and the JAX pipeline's batch."""
    jc, pc, jplan, pplan = _configs(name, **plan)
    model = Model(jc, jplan)
    params = model.init(jax.random.PRNGKey(seed))
    lm = LM(pc, params_from_numpy(jax.tree.map(np.asarray, params), pc,
                                  device="cpu"), pplan)
    batch = JaxTokens(jax_data_config(
        jc, JaxShape("t", SEQ, BATCH, "train"), seed=seed)).batch(0)
    return model, params, lm, {k: np.asarray(v) for k, v in batch.items()}


def _port_grads(lm, batch):
    lm.requires_grad_(True)
    total, metrics = lm.train_loss(batch)
    params = lm.params()
    got = torch.autograd.grad(total, list(params.values()),
                              allow_unused=True)
    return total, metrics, {n: torch.zeros_like(p) if g is None else g
                            for (n, p), g in zip(params.items(), got)}


def _close_leaves(got, want, tol=GRAD_TOL, floor=GRAD_FLOOR):
    assert set(got) == set(want)
    top = max(w.detach().abs().max().item() for w in want.values())
    for name in want:
        w, g = want[name].detach().float(), got[name].detach().float()
        scale = max(w.abs().max().item(), floor * top)
        err = (g - w).abs().max().item()
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("name", CONFIGS)
def test_train_loss_and_grads_match_jax(name):
    model, params, lm, batch = _pair(name)
    (total, aux), grads = jax.jit(jax.value_and_grad(
        model.train_loss, has_aux=True))(params, batch)
    ptotal, pmetrics, pgrads = _port_grads(lm, batch)
    assert ptotal.item() == pytest.approx(float(total), rel=LOSS_RTOL)
    assert float(pmetrics["loss"]) == pytest.approx(float(aux["loss"]),
                                                    rel=LOSS_RTOL)
    assert float(pmetrics["aux_loss"]) == pytest.approx(
        float(aux["aux_loss"]), rel=LOSS_RTOL, abs=1e-7)
    if lm.cfg.moe is not None:          # the Switch term reaches the total
        assert float(pmetrics["aux_loss"]) > 0
    want = params_from_numpy(jax.tree.map(np.asarray, grads), lm.cfg,
                             device="cpu")
    _close_leaves(pgrads, want)


def test_chunked_loss_is_the_same_across_vocab_chunks():
    """tests/test_lm_consistency.py:67 on the port, gradients too."""
    _, _, base, batch = _pair("granite-3-2b", seed=1)
    state = {n: p.detach().clone() for n, p in base.params().items()}
    want_loss, _, want_grads = _port_grads(base, batch)
    for chunk in (4, 8, 16):
        lm = LM(base.cfg, state, Plan(vocab_chunk=chunk))
        loss, _, grads = _port_grads(lm, batch)
        assert float(loss) == pytest.approx(float(want_loss), rel=1e-6)
        _close_leaves(grads, want_grads, tol=1e-5)


@pytest.mark.parametrize("name", ["granite-3-2b", "moonshot-v1-16b-a3b"])
def test_grads_are_the_same_under_every_remat(name):
    _, _, base, batch = _pair(name, seed=2, remat="none")
    base.eval().train()          # nn.Module's modes still walk the blocks
    state = {n: p.detach().clone() for n, p in base.params().items()}
    want_loss, _, want = _port_grads(base, batch)
    for remat in ("block", "full"):
        lm = LM(base.cfg, state, Plan(remat=remat))
        loss, _, grads = _port_grads(lm, batch)
        assert float(loss) == float(want_loss), remat
        _close_leaves(grads, want, tol=1e-6)


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax(micro):
    """One step of each package's ``make_train_step``, AdamW with clipping
    and a master-free fp32 update, from the same weights and batch.  The
    first Adam step is g / (|g| + eps): at the default eps of 1e-8 it
    turns the two sides' rounding noise (about 1e-10) in a near-zero
    gradient into a step change of 1e-2; eps 1e-4 keeps that under 1e-6 of
    a step.  ``optimizer.update`` at the default eps is held to the
    reference's on the same gradients in tests/test_torch_substrate.py."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, microbatches=micro,
              grad_clip=0.5, eps=1e-4)
    model, params, lm, batch = _pair("granite-3-2b", seed=3,
                                     microbatches=micro)
    jt, tcfg = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = jax_train_step.optimizer.init(params, jt)
    new_params, new_opt, metrics = jax.jit(
        jax_train_step.make_train_step(model, jt))(params, jstate, batch,
                                                   jnp.int32(0))
    step = train_step.make_train_step(lm, tcfg)
    pparams, popt, pmetrics = step(lm.params(), optimizer.init(lm.params(),
                                                                tcfg),
                                   batch, 0)
    for key in ("loss", "aux_loss", "lr", "grad_norm"):
        assert float(pmetrics[key]) == pytest.approx(
            float(metrics[key]), rel=1e-5, abs=1e-7), key
    assert int(popt["count"]) == int(new_opt["count"]) == 1
    cfg = lm.cfg
    _close_leaves(pparams, params_from_numpy(
        jax.tree.map(np.asarray, new_params), cfg, device="cpu"), tol=1e-5)
    for moment in ("m", "v"):
        _close_leaves(popt[moment], params_from_numpy(
            jax.tree.map(np.asarray, new_opt[moment]), cfg, device="cpu"))
