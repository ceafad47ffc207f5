"""The metric arithmetic on hand-made inputs: percentiles, latencies with
unserved requests, unions of busy intervals, rates over the window."""
import pytest

from portbench import harness, reduce, yardstick as ys
from portbench.trace import Interval, Ranges, Traced


class FakeRun:
    def __init__(self, **kw):
        self.__dict__.update(kw)


@pytest.mark.parametrize("values,p,want", [
    ([5, 1, 3, 2, 4], 50, 3), ([1, 2, 3, 4], 50, 2), ([1, 2, 3, 4], 75, 3),
    (list(range(1, 101)), 95, 95), (list(range(1, 21)), 95, 19),
    ([7], 95, 7), ([3, 1], 0, 1), ([], 95, None)])
def test_nearest_rank_percentile(values, p, want):
    assert ys.percentile(values, p) == want


def requests():
    return {"0": {"due": 9.0, "times": [9.5, 9.6], "prompt_len": 10},
            "1": {"due": 10.0, "times": [10.2, 10.3, 10.5],
                  "prompt_len": 100},
            "2": {"due": 11.0, "times": [], "prompt_len": 7},
            "3": {"due": 13.0, "times": [13.5], "prompt_len": 5}}


def test_ttft_counts_an_unserved_request_until_the_wait_ended():
    run = FakeRun(window=(10.0, 12.0), seconds=2.0, requests=requests(),
                  stop=20.0)
    got = sorted(round(x, 6) for x in reduce.ttft_s(run))
    assert got == [0.2, 9.0]
    assert ys.percentile(reduce.ttft_s(run), 95) == pytest.approx(9.0)


def test_inter_token_gaps_in_the_window():
    run = FakeRun(window=(10.0, 12.0), seconds=2.0, requests=requests())
    assert sorted(round(x, 6) for x in reduce.itl_s(run)) == [0.1, 0.2]
    assert harness.reader("itl_p95_ms")(run) == pytest.approx(200.0)


def test_tokens_per_second_over_the_window():
    run = FakeRun(window=(10.0, 12.0), seconds=2.0, requests=requests())
    # request 1: its 100 prompt tokens and 3 tokens in the window
    assert harness.reader("tokens_per_s")(run) == pytest.approx(103 / 2.0)


def test_train_rate_over_all_steps_and_time():
    run = FakeRun(window=(1.0, 5.0), train_steps=4, train_tokens=8192)
    assert harness.reader("train_tokens_per_s")(run) == \
        pytest.approx(4 * 8192 / 4.0)


def traced():
    ev = [Interval("k1", 100, 200), Interval("k2", 150, 300),
          Interval("k3", 500, 600), Interval("k4", 900, 950)]
    ranges = {"portbench.tick": Ranges([(80, 320), (440, 620)]),
              "portbench.admit": Ranges([(440, 520)])}
    return Traced(ev, ranges, 0, 1000)


def test_busy_is_the_union_of_intervals():
    t = traced()
    assert t.busy_ns() == 200 + 100 + 50
    assert t.idle_gaps() == [(0, 100), (300, 500), (600, 900),
                             (950, 1000)]
    run = FakeRun(traced=t)
    assert reduce.idle_share(run) == pytest.approx(65.0)


def test_events_placed_by_their_start():
    t = traced()
    assert [e.name for e in t.within("portbench.admit")] == ["k3"]
    assert sorted(e.name for e in t.within("portbench.tick")) == \
        ["k1", "k2", "k3"]
    spans = t.by_span("portbench.tick")
    assert sorted(len(v) for v in spans.values()) == [1, 2]


def test_decode_steps_timed_by_events():
    cfg = {"d_model": 4, "n_heads": 2, "n_kv_heads": 1, "d_head": 2,
           "d_ff": 8, "ffn_act": "swiglu", "n_layers": 3, "vocab_size": 10}
    steps = [(2.0, [3, 9], [True, False]), (4.0, [4, 10], [True, True])]
    run = FakeRun(timed_steps=steps, cfg=cfg, mix={"cache_len": 8})
    assert harness.reader("decode_step_ms.chat")(run) == pytest.approx(3.0)
    flops = ys.forward_flops(cfg, 1, 4) + ys.forward_flops(cfg, 2, 5 + 8)
    assert reduce.decode_flops(run, steps) == flops
    assert harness.reader("mfu.chat")(run) == \
        pytest.approx(100 * flops / ys.PEAK_BF16_FLOPS / 6e-3)
    assert harness.reader("mfu.chat")(FakeRun(timed_steps=[])) is None


CFG = {"d_model": 4, "n_heads": 2, "n_kv_heads": 1, "d_head": 2, "d_ff": 8,
       "ffn_act": "swiglu", "n_layers": 3, "vocab_size": 10}


@pytest.mark.parametrize("stale", [0, 7, 4000])
def test_decode_bound_counts_only_the_slots_that_serve(stale):
    # slot 1 retired: its stale position, however large, adds no rows
    steps = [(0.0, [3, stale], [True, False]), (0.0, [9, 5], [True, True])]
    run = FakeRun(cfg=CFG, mix={"cache_len": 8}, traced_steps=steps)
    want = 3 * (ys.least_seconds(*ys.decode_work(2, 2, 1, 2, 4))
                + ys.least_seconds(*ys.decode_work(2, 2, 1, 2, 8 + 6)))
    assert reduce.decode_bound_s(run) == pytest.approx(want)


def test_admissions_and_steps_timed_by_events():
    steps = [(3.0, [3, 9], [True, False])]
    run = FakeRun(timed_admits=[(4.0, 1000), (2.0, 500)], timed_steps=steps,
                  timed_span_ms=12.0, cfg=CFG, mix={"cache_len": 8})
    # busy 4 + 2 + 3 of the 12 ms between the first event and the last
    assert harness.reader("idle_share.chat")(run) == pytest.approx(25.0)
    assert harness.reader("idle_share.docqa")(run) == pytest.approx(25.0)
    assert harness.reader("prefill_ms_per_ktok.chat")(run) == \
        pytest.approx(6.0 / 1.5)
    flops = reduce.prefill_flops(run, [1000, 500]) + \
        ys.forward_flops(CFG, 1, 4)
    assert reduce.prefill_flops(run, [4]) == \
        ys.forward_flops(CFG, 4, 10)
    assert harness.reader("mfu.docqa")(run) == \
        pytest.approx(100 * flops / ys.PEAK_BF16_FLOPS / 12e-3)


@pytest.mark.parametrize("name", ["idle_share.chat", "prefill_ms_per_ktok.docqa",
                                  "mfu.docqa"])
def test_nothing_timed_reads_nothing(name):
    assert harness.reader(name)(FakeRun(timed_span_ms=0.0, timed_admits=[],
                                        timed_steps=[])) is None
    assert harness.reader(name)(FakeRun()) is None


def test_training_shares_over_the_steps_after_the_profiler():
    t = Traced([Interval("k", 0, 300), Interval("k", 500, 700)],
               {"portbench.step": Ranges([(0, 400), (450, 900)])}, 0, 1000)
    cfg = dict(CFG, d_model=8)
    run = FakeRun(traced=t, untraced_steps=4, untraced_s=2.0e-6, cfg=cfg,
                  mix={"batch": 2, "seq": 4})
    assert harness.reader("step_device_ms.train")(run) == \
        pytest.approx(250 / 1e6)
    # a step's 250 ns busy against 500 ns of wall after the profiler
    assert harness.reader("idle_share.train")(run) == pytest.approx(50.0)
    flops = 4 * ys.train_flops(cfg, 8, 2 * ys.causal_pairs(4))
    assert harness.reader("mfu.train")(run) == \
        pytest.approx(100 * flops / ys.PEAK_BF16_FLOPS / 2.0e-6)
    for name in ("idle_share.train", "mfu.train"):
        assert harness.reader(name)(FakeRun(traced=t, untraced_steps=0,
                                            cfg=cfg)) is None


def test_breakdown_names_ops_and_idle_by_host_range():
    t = traced()
    t.ranges["portbench.step"] = Ranges([(350, 450)])
    b = t.breakdown(["portbench.admit", "portbench.step", "portbench.tick"])
    assert b["device_ops"][0] == ["k2", 150 / 1e9]
    idle = dict(b["idle_gaps"])
    assert idle == {"portbench.step": pytest.approx(200 / 1e9),
                    "outside any portbench range": pytest.approx(450 / 1e9)}
    assert b["idle_gaps"][0][0] == "outside any portbench range"


def test_shares_are_never_zero_and_none_without_time():
    assert reduce.share(1.0, 0.0) is None
    assert reduce.share(0.0, 1.0) is None
    assert reduce.share(1.0, 4.0) == 25.0


def test_work_formulas():
    assert ys.causal_pairs(4) == 10
    f, b = ys.flash_fwd_work(8, 4, 16, 4)
    assert f == 4 * 8 * 10 * 16 and b == 2 * (2 * 8 * 4 * 16 + 2 * 2 * 4 * 16)
    f, b = ys.flash_bwd_work(8, 4, 16, 4)
    assert f == 10 * 8 * 10 * 16
    f, b = ys.decode_work(2, 8, 2, 16, 100)
    assert f == 4 * 8 * 16 * 100 and b == 2 * (2 * 100 * 2 * 16 + 2 * 2 * 8 * 16)
    assert ys.least_seconds(989e12, 0) == pytest.approx(1.0)
    assert ys.least_seconds(0, 3.35e12) == pytest.approx(1.0)


def test_model_flops_count_the_products():
    cfg = {"d_model": 4, "n_heads": 2, "n_kv_heads": 1, "d_head": 2,
           "d_ff": 8, "ffn_act": "swiglu", "n_layers": 3, "vocab_size": 10}
    per_layer = 4 * 2 * 2 * 2 + 4 * 1 * 2 * 2 + 4 * 8 * 3
    assert ys.matmul_params(cfg) == 3 * per_layer + 4 * 10
    assert ys.forward_flops(cfg, 5, 7) == 2 * ys.matmul_params(cfg) * 5 \
        + 4 * 7 * 2 * 2 * 3
    assert ys.train_flops(cfg, 5, 7) == 3 * ys.forward_flops(cfg, 5, 7)
