"""The metric arithmetic on hand-built runs: percentiles, the gap between
tokens, queue wait, the rate's time base, the MFU and roofline shares."""
import numpy as np
import pytest

import bp_smoke  # noqa: F401  (import paths)
from harness import spec, trace
from harness.serve import Served, ServeRun

MODEL = dict(n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4,
             d_ff=16, vocab=10, n_experts=0, top_k=0, n_shared_experts=0,
             d_expert=0)


def req(rid, arrival, admit, first, last, n_tok, plen=4):
    return Served(rid, np.zeros(plen, np.int64), n_tok, arrival, admit,
                  first, last, list(range(n_tok)))


def run_of(reqs, **kw):
    base = dict(model=MODEL, mix={}, device_kind="NVIDIA H100 80GB HBM3",
                requests=reqs, setup_s=12.5, decode_s=0.0, prefill_s=0.0,
                decode_steps=0, prefill_chunks=0, slots=4)
    base.update(kw)
    return ServeRun(**base)


def value(name, run):
    return spec.reader(name)(run)


REQS = [req(i, arrival=0.5 * i, admit=0.5 * i + 0.01 * i,
            first=0.5 * i + 0.1 + 0.01 * i, last=0.5 * i + 1.1 + 0.01 * i,
            n_tok=11) for i in range(10)]


def test_latency_percentiles():
    ttft = [(r.first - r.arrival) * 1e3 for r in REQS]
    assert value("ttft_p90_ms", run_of(REQS)) == pytest.approx(
        np.percentile(ttft, 90))
    # (last - first) / (tokens - 1): 1.0 s over 10 gaps
    assert value("tpot_p90_ms", run_of(REQS)) == pytest.approx(100.0)
    assert value("queue_wait_p90_ms", run_of(REQS)) == pytest.approx(
        np.percentile([10.0 * i for i in range(10)], 90))
    # a traced run: only the requests admitted before the window opened
    cut = run_of(REQS, trace_opened_at=REQS[5].admit + 1e-9)
    assert value("queue_wait_p90_ms", cut) == pytest.approx(
        np.percentile([10.0 * i for i in range(6)], 90))
    one = [req(0, 0.0, 0.0, 0.2, 0.2, 1)]
    assert value("tpot_p90_ms", run_of(one)) is None


def test_rate_spans_first_arrival_to_last_token():
    # 110 tokens from t = 0 (first arrival) to 4.5 + 1.19 s
    assert value("tokens_per_s", run_of(REQS)) == pytest.approx(
        110 / (4.5 + 1.1 + 0.09))
    assert value("setup_s", run_of(REQS)) == 12.5


def test_mfu_counts_positions():
    from harness import flops
    n_eff = 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16) + 8 * 10
    assert flops.n_eff(MODEL) == n_eff
    # one request: prompt 4, 3 tokens: decode emits positions 4 and 5
    r = [req(0, 0.0, 0.0, 0.1, 0.3, 3)]
    per = lambda pos: 2 * n_eff + 4 * (pos + 1) * 2 * 4 * 2
    run = run_of(r, decode_s=1e-9, prefill_s=2e-9)
    assert value("mfu.decode", run) == pytest.approx(
        100 * (per(4) + per(5)) / (1e-9 * 67e12))
    assert value("mfu.prefill", run) == pytest.approx(
        100 * sum(per(p) for p in range(4)) / (2e-9 * 67e12))


def window():
    ops = [("cim_tile_terms", 110.0, 120.0), ("rms_kernel", 121.0, 125.0),
           ("cim_walk", 210.0, 250.0), ("Memcpy DtoH", 252.0, 253.0)]
    ranges = [("bp.decode", 105.0, 130.0), ("bp.prefill:64", 200.0, 260.0)]
    return trace.Window(100.0, 300.0, ops, ranges)


def test_device_readers():
    w = window()
    run = run_of(REQS, window=w)
    assert trace.busy_us(w.ops) == 10 + 4 + 40 + 1
    assert value("device_idle_share.serve", run) == pytest.approx(
        100 * (1 - 55 / 200))
    assert value("glue_device_ms.decode", run) == pytest.approx(4e-3)
    from harness import flops
    p = flops.peaks(run.device_kind)
    dec = flops.layer_bound_ms(MODEL, 4, p["hbm_bytes_per_s"],
                               p["fp64_flops"])
    assert value("cim_roofline.decode", run) == pytest.approx(
        100 * dec * 1e3 / 10.0)
    pre = flops.layer_bound_ms(MODEL, 64, p["hbm_bytes_per_s"],
                               p["fp64_flops"])
    assert value("cim_roofline.prefill", run) == pytest.approx(
        100 * pre * 1e3 / 40.0)
    gaps = trace.breakdown(w)["idle_gaps"]
    # idle 125 -> 210 us, while the decode range was open
    assert gaps[0] == ["bp.decode", pytest.approx(85e-6)]
    assert gaps[-1] == ["bp.decode", pytest.approx(1e-6)]
    assert run_of(REQS).window is None
    assert value("cim_roofline.decode", run_of(REQS)) is None
