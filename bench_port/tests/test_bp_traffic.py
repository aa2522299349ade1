"""The traffic generator: repeatable per seed, the same work for every
seed, the stated distributions."""
import numpy as np
import pytest

import bp_smoke  # noqa: F401  (import paths)
from harness import spec, traffic


@pytest.mark.parametrize("name", ["chat.granite20b", "chat.dsmoe16b"])
def test_plan_repeats_per_seed(name):
    mix = spec.traffic_file(name)
    a = traffic.plan(mix, 1000, 2147483649, 20.0)
    b = traffic.plan(mix, 1000, 2147483649, 20.0)
    assert [(r.rid, r.max_new, r.arrival, r.prompt.tolist()) for r in a] \
        == [(r.rid, r.max_new, r.arrival, r.prompt.tolist()) for r in b]


@pytest.mark.parametrize("name", ["chat.granite20b", "chat.dsmoe16b"])
def test_every_seed_gets_the_same_work(name):
    mix = spec.traffic_file(name)
    a = traffic.plan(mix, 1000, 1, 30.0)
    b = traffic.plan(mix, 1000, 2 ** 31 + 11, 30.0)
    assert len(a) == len(b) == round(mix["rate_per_s"] * 30.0)
    for key in (lambda r: len(r.prompt), lambda r: r.max_new,
                lambda r: r.arrival):
        assert list(map(key, a)) == list(map(key, b))
    assert any(x.prompt.tolist() != y.prompt.tolist() for x, y in zip(a, b))
    assert a[0].arrival == 0.0
    # the arrangement is the mix's: another order seed reorders the work
    c = traffic.plan(dict(mix, order_seed=1), 1000, 1, 30.0)
    assert sorted(r.max_new for r in c) == sorted(r.max_new for r in a)
    assert [r.max_new for r in c] != [r.max_new for r in a]


def test_chat_distributions():
    """The Azure conversation trace's medians, and sigmas from its means:
    sqrt(2 ln(mean / median))."""
    mix = spec.traffic_file("chat.granite20b")
    n = 2001
    p = traffic.lengths(mix["prompt"], n)
    o = traffic.lengths(mix["output"], n)
    assert mix["prompt"]["sigma"] == pytest.approx(
        np.sqrt(2 * np.log(1155 / 1020)), abs=1e-4)
    assert mix["output"]["sigma"] == pytest.approx(
        np.sqrt(2 * np.log(211 / 129)), abs=1e-4)
    assert p.max() == 3072 and np.all(p % 64 == 0) and p.min() >= 64
    assert np.median(p) == 1024         # median 1020 on the page grid
    assert o.min() >= 8 and o.max() == 1024
    assert np.median(o) == 129
    # quantile (i + 1/2)/n of the log-normals: 1.4% of prompts at the
    # 3072 clip, 1.8% of outputs at 1024
    assert abs(np.mean(p == 3072) - 0.0135) < 0.003
    assert abs(np.mean(o == 1024) - 0.0184) < 0.003
    # the unclipped means come back to the trace's, within the clip's cut
    assert abs(np.mean(traffic.quantiles(dict(mix["prompt"], max=1e9),
                                         n)) / 1155 - 1) < 0.01
    # exponential gaps at mean 1 / rate
    plan = traffic.plan(dict(mix, rate_per_s=5.0), 100, 3, 200.0)
    gaps = np.diff([r.arrival for r in plan])
    assert abs(gaps.mean() - 0.2) < 0.01
    assert all(r.prompt.min() >= 0 and r.prompt.max() < 100 for r in plan)


def test_slot_length():
    mix = spec.traffic_file("chat")
    assert traffic.max_len(mix) == 3072 + 1024
