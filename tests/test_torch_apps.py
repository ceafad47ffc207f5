"""The port's apps against the JAX package's, nest by nest and impl by impl
at small size, on the same numpy state; and the FPGA-analogue narrowing and
function-block detection against the JAX package's."""
import jax
import numpy as np
import pytest
import torch

from repro.apps import APPS as JAX_APPS
from repro.core import function_blocks as jax_fb
from repro.core import intensity as jax_intensity
from repro_torch.apps import APPS, state_from_numpy, state_to_numpy
from repro_torch.core import function_blocks, intensity
from repro_torch.core.measure import outputs_close

APP_NAMES = ("3mm", "NAS.BT", "tdFIR")
# fp32 on both sides, summed in another order
TOL = 1e-4

CASES = [(app, nest.name, impl) for app in APP_NAMES
         for nest in APPS[app]().nests for impl in sorted(nest.impls)]


def _jax_small_state(name):
    return {k: np.asarray(v) for k, v in
            JAX_APPS[name]().make_inputs(seed=0, small=True).items()}


@pytest.fixture(scope="module")
def nest_inputs():
    """For every app, the numpy state each nest receives in the JAX
    package's seq chain at small size."""
    out = {}
    for name in APP_NAMES:
        app = JAX_APPS[name]()
        state = JAX_APPS[name]().make_inputs(seed=0, small=True)
        for nest in app.nests:
            out[(name, nest.name)] = {k: np.asarray(v)
                                      for k, v in state.items()}
            state = jax.jit(nest.impls["seq"])(state)
    return out


def _nest(apps, app, nest_name):
    return next(n for n in apps[app]().nests if n.name == nest_name)


@pytest.mark.parametrize("app,nest_name,impl", CASES)
def test_nest_impl_matches_jax(nest_inputs, app, nest_name, impl):
    state = nest_inputs[(app, nest_name)]
    want = _nest(JAX_APPS, app, nest_name).impls[impl](
        {k: jax.numpy.asarray(v) for k, v in state.items()})
    got = _nest(APPS, app, nest_name).impls[impl](
        state_from_numpy(state, "cpu"))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=TOL, atol=TOL, err_msg=key)


def test_smoother_parallel_impl_stays_wrong(nest_inputs):
    """NAS.BT's Jacobi dp/tp smoother is the paper's hazard: it equals the
    JAX package's dp and is not outputs_close to the sequential sweep."""
    state = state_from_numpy(nest_inputs[("NAS.BT", "seidel_relax")], "cpu")
    nest = _nest(APPS, "NAS.BT", "seidel_relax")
    assert not nest.parallel_safe
    seq = nest.impls["seq"](state)["u_smooth"]
    for impl in ("dp", "tp"):
        assert not outputs_close(nest.impls[impl](state)["u_smooth"], seq)


def test_state_round_trips_through_numpy():
    state = _jax_small_state("tdFIR")
    back = state_to_numpy(state_from_numpy(state, "cpu"))
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])


def test_make_inputs_on_the_cpu():
    for name in APP_NAMES:
        state = APPS[name]().make_inputs(seed=0, small=True, device="cpu")
        want = _jax_small_state(name)
        assert sorted(state) == sorted(want)
        for k, v in state.items():
            assert v.device.type == "cpu" and v.dtype == torch.float32
            assert tuple(v.shape) == want[k].shape


@pytest.mark.parametrize("name", APP_NAMES)
def test_narrowing_matches_jax(name):
    small = _jax_small_state(name)
    want = [p.nest.name for p in jax_intensity.narrow(
        JAX_APPS[name](), {k: jax.numpy.asarray(v)
                           for k, v in small.items()})]
    got = [p.nest.name for p in intensity.narrow(
        APPS[name](), state_from_numpy(small, "cpu"))]
    assert got == want


def _matches(matches):
    return [(m.nest.name, m.entry.name, m.method) for m in matches]


@pytest.mark.parametrize("name,rename", [(n, False) for n in APP_NAMES]
                         + [("tdFIR", True)])
def test_function_blocks_match_jax(name, rename):
    """Name matching, and the Deckard-style similarity path once the FIR
    nest is renamed so the name cannot match."""
    small = _jax_small_state(name)
    jax_app, app = JAX_APPS[name](), APPS[name]()
    if rename:
        jax_app.nests[0].name = app.nests[0].name = "mystery_block_A"
    want = jax_fb.detect(jax_app, {k: jax.numpy.asarray(v)
                                   for k, v in small.items()})
    got = function_blocks.detect(app, state_from_numpy(small, "cpu"))
    assert _matches(got) == _matches(want)
    for m in got:
        assert m.score >= function_blocks.SIMILARITY_THRESHOLD
