"""The backend and policy faces the JAX package documents, held against it
on the CPU with the same inputs through ``repro`` and ``repro_torch``:
``Backend.with_``, the registry's ``get`` / ``by_name`` / ``by_analogue``
and ``register(replace=)``, the pre-Candidate policy faces (``score``,
``score_parts``, ``score_cell``) and the bridge that ranks a policy which
overrides only one of them, the ``core.destinations`` names,
``intensity.fpga_patterns`` and ``OffloadableApp.choice_from_genes``."""
import pytest

import repro.backends as jb
import repro.core.candidates as jcand
import repro.core.destinations as jdest
import repro.core.intensity as jint
from repro.apps import APPS as JAX_APPS
import repro_torch.backends as tb
import repro_torch.core.candidates as tcand
import repro_torch.core.destinations as tdest
import repro_torch.core.intensity as tint
from repro_torch.apps import APPS

POLICIES = ("host-time", "modeled", "price-weighted", "power", "edp")
# (time_s, price, modeled_s): the reference's test_policy_scores arguments
PARTS = ((2.0, 3.0, 0.5), (2.0, 3.0, None), (1.0, 1.0, None),
         (0.25, 8.0, 0.125))
# (step_time_s, price, energy): a charged cell (test_from_cell_matches_the_
# old_score_cell_faces) and the uncharged one of
# test_uncharged_record_scores_in_joules_not_seconds
CELLS = ((0.2, 8.0, {"energy_j": 12.0, "avg_watts": 60.0, "edp": 2.4}),
         (0.4, 8.0, None), (0.4, 1.0, None))


def _fields(b):
    return (b.key, b.name, b.paper_analogue, b.price, b.verify_time,
            b.mesh_role, b.methods)


def test_with_returns_a_changed_copy():
    for mod in (jb, tb):
        gpu = mod.DEFAULT_REGISTRY.get("tp")
        cheap = gpu.with_(price=9.0, mesh_role="")
        assert cheap is not gpu and gpu.price != 9.0
        assert (cheap.price, cheap.mesh_role, cheap.key) == (9.0, "", "tp")
    assert _fields(tb.GPU.with_(price=9.0)) == _fields(jb.GPU.with_(price=9.0))


def test_registry_lookups_match_the_reference():
    jr, tr = jb.DEFAULT_REGISTRY, tb.DEFAULT_REGISTRY
    for key in ("dp", "tp", "pallas", "missing"):
        want, got = jr.get(key), tr.get(key)
        assert (got is None) == (want is None)
        if want is not None:
            assert _fields(got) == _fields(want)
    assert tr.get("pallas") is tb.FPGA
    for face in ("by_name", "by_analogue"):
        want, got = getattr(jr, face), getattr(tr, face)
        assert list(got) == list(want)
        assert all(_fields(got[k]) == _fields(want[k]) for k in want)
    assert tr.by_name["pallas_kernel"] is tb.FPGA
    assert tr.by_analogue["GPU"] is tb.GPU


def test_register_replace_swaps_by_key():
    for mod in (jb, tb):
        reg = mod.DEFAULT_REGISTRY.copy()
        clone = reg.get("dp").with_(price=9.0)
        with pytest.raises(ValueError):
            reg.register(clone)
        reg.register(clone, replace=True)
        assert reg.get("dp").price == 9.0 and len(reg) == 3
        assert [b.key for b in reg] == ["dp", "tp", "pallas"]
    assert tb.DEFAULT_REGISTRY.get("dp").price == jb.MANY_CORE.price


@pytest.mark.parametrize("name", POLICIES)
def test_score_parts_and_cells_match_the_reference(name):
    jp, tp = jb.get_policy(name), tb.get_policy(name)
    for time_s, price, modeled_s in PARTS:
        assert tp.score_parts(time_s, price=price, modeled_s=modeled_s) == \
            pytest.approx(jp.score_parts(time_s, price=price,
                                         modeled_s=modeled_s), rel=1e-12)
    for step, price, energy in CELLS:
        assert tp.score_cell(step, price=price, energy=energy) == \
            pytest.approx(jp.score_cell(step, price=price, energy=energy),
                          rel=1e-12)
    # score is score_candidate on anything with a record's fields
    for mod, pol in ((jcand, jp), (tcand, tp)):
        c = mod.Candidate(best_time_s=0.4, price=2.0, mesh_time_s=0.3)
        assert pol.score(c) == pol.score_candidate(c)
    assert tp.score(tcand.Candidate(best_time_s=0.4, price=2.0,
                                    mesh_time_s=0.3)) == pytest.approx(
        jp.score(jcand.Candidate(best_time_s=0.4, price=2.0,
                                 mesh_time_s=0.3)), rel=1e-12)


def _legacy(base, face):
    """A policy written before Candidates: it overrides only ``face``."""
    if face == "score_parts":
        def score_parts(self, time_s, price=1.0, modeled_s=None):
            return (modeled_s if modeled_s is not None else time_s) * price
        body = {"score_parts": score_parts}
    else:
        def score(self, record):
            return -record.best_time_s       # the slowest first
        body = {"score": score}
    return type(f"Legacy_{face}", (base,), dict(body, name=f"legacy-{face}"))()


def _candidates(mod):
    rows = (("a", 1.0, 1.0, None), ("b", 0.5, 3.0, None),
            ("c", 2.0, 0.5, 0.2), ("d", 0.8, 1.0, 0.9))
    return [mod.Candidate(backend=name, best_time_s=t, price=p,
                          mesh_time_s=m) for name, t, p, m in rows]


@pytest.mark.parametrize("face", ("score_parts", "score"))
def test_legacy_policy_ranks_as_in_the_reference(face):
    want = [c.backend for c in
            _legacy(jb.SelectionPolicy, face).rank(_candidates(jcand))]
    got = [c.backend for c in
           _legacy(tb.SelectionPolicy, face).rank(_candidates(tcand))]
    assert got == want
    assert len(got) == 4


def test_a_policy_with_no_face_still_raises():
    with pytest.raises(NotImplementedError):
        tb.SelectionPolicy().score_candidate(
            tcand.Candidate(best_time_s=1.0))


def test_destinations_names_match_the_reference():
    assert tdest.__all__ == jdest.__all__
    assert tdest.Destination is tb.Backend
    assert [d.key for d in tdest.ALL] == [d.key for d in jdest.ALL]
    assert list(tdest.BY_NAME) == list(jdest.BY_NAME)
    assert list(tdest.BY_ANALOGUE) == list(jdest.BY_ANALOGUE)
    assert tdest.BY_NAME["pallas_kernel"] is tdest.FPGA
    assert tdest.BY_ANALOGUE["GPU"] is tdest.GPU
    assert tdest.MANY_CORE.mesh_role == jdest.MANY_CORE.mesh_role == "data"
    assert [(d.key, m) for d, m in tdest.VERIFICATION_ORDER] == \
        [(d.key, m) for d, m in jdest.VERIFICATION_ORDER]
    assert len(tdest.VERIFICATION_ORDER) == 6


def test_fpga_patterns_match_the_reference():
    for name in ("3mm", "tdFIR", "NAS.BT"):
        japp, tapp = JAX_APPS[name](), APPS[name]()
        want = jint.fpga_patterns(jint.narrow(japp,
                                              japp.make_inputs(0, small=True)))
        got = tint.fpga_patterns(tint.narrow(
            tapp, tapp.make_inputs(0, small=True, device="cpu")))
        assert got == want
        assert len(got) == 3 and all(len(p) == 1 for p in got)


@pytest.mark.parametrize("name", ("3mm", "tdFIR", "NAS.BT"))
def test_choice_from_genes_matches_the_reference(name):
    japp, tapp = JAX_APPS[name](), APPS[name]()
    n = tapp.gene_length
    assert n == japp.gene_length
    genes_list = ([1] * n, [0] * n, [i % 2 for i in range(n)],
                  [(i + 1) % 2 for i in range(n)])
    for genes in genes_list:
        for key in ("dp", "tp", "pallas", "none"):
            assert tapp.choice_from_genes(genes, key) == \
                japp.choice_from_genes(genes, key)
