"""The program's spans on the profiler window (`harness/spans.py`) and the
readers of them, on a hand-built window and process buffer whose
clocks differ by a known offset."""
import pytest

import bp_smoke  # noqa: F401  (import paths)
from harness import flops, spans, spec, trace
from harness.serve import ServeRun
from repro_torch.obs import trace as program_trace

MODEL = dict(n_layers=2, d_model=8, n_heads=2, n_kv_heads=1, head_dim=4,
             d_ff=16, vocab=10, n_experts=4, top_k=2, n_shared_experts=1,
             d_expert=4)
ORIGIN_NS = 1_792_000_000_123_456_789      # the program's Unix zero
START_US = ORIGIN_NS / 1e3 + 5000.0        # the profiler's start (Unix us)
LAG = (20.0, 30.0, 25.0)                   # range start -> span start, us
ROUTED = ([3, 0, 4, 1], [2, 2, 0, 4])      # routed rows, layers 0 and 1


def _buffer(calls):
    """A process buffer holding `calls`: (window us of the call's start,
    kind) with the spans below each at fixed offsets."""
    buf = program_trace.TraceBuffer()
    buf.origin_ns = ORIGIN_NS

    def put(name, a, b, **args):
        rel = (a + START_US) - ORIGIN_NS / 1e3     # us since the zero
        buf.complete(name, rel / 1e6, (b - a) / 1e6,
                     tid=program_trace.SPAN_TID, cat="span", args=args)

    for (t, kind), lag in zip(calls, LAG):
        t += lag
        if kind == "prefill":
            put("serve.prefill", t, t + 560, rows=8, device_s=4e-4)
            put("serve.prefill.enqueue", t + 5, t + 280)
            for i, lay in enumerate((t + 10, t + 140)):
                put("layer", lay, lay + 120, i=i)
                put("moe.router", lay + 5, lay + 10)
                put("moe.dispatch", lay + 10, lay + 30)
                put("moe.experts", lay + 30, lay + 90,
                    routed_rows=ROUTED[i])
                put("moe.combine", lay + 90, lay + 100)
                put("moe.shared", lay + 100, lay + 115)
            put("serve.prefill.wait", t + 280, t + 480)
            put("serve.prefill.sample", t + 480, t + 555)
        else:
            put("serve.decode", t, t + 270, live=2, device_s=2e-4)
            put("serve.decode.call", t + 5, t + 80)
            put("serve.decode.wait", t + 80, t + 230)
            put("serve.decode.emit", t + 230, t + 260)
            put("serve.decode.evict", t + 260, t + 268)
    return buf


CALLS = [(1000.0, "prefill"), (2000.0, "decode"), (3000.0, "prefill")]


def _window():
    ops = [("void cim::cim_walk<1, 4>(...)", 1100.0, 1200.0),
           ("elementwise", 1210.0, 1250.0),
           ("void cim::cim_walk<1, 4>(...)", 1300.0, 1480.0),
           ("void cim::cim_tile_terms<16>(...)", 2100.0, 2200.0),
           ("void cim::cim_walk<1, 4>(...)", 3100.0, 3300.0)]
    ranges = [("bp.prefill:8", 1000.0, 1600.0), ("bp.decode", 2000.0, 2300.0),
              ("bp.prefill:8", 3000.0, 3600.0)]
    return trace.Window(1000.0, 3600.0, ops, ranges)


@pytest.fixture
def installed(monkeypatch):
    monkeypatch.setattr(program_trace, "_PROFILED", _buffer(CALLS))


def _run(window=None):
    return ServeRun(model=MODEL, mix={}, device_kind="NVIDIA H100 80GB HBM3",
                    requests=[], setup_s=1.0, decode_s=0.0, prefill_s=0.0,
                    decode_steps=0, prefill_chunks=0, slots=2, window=window)


def value(name, run):
    return spec.reader(name)(run)


def test_offset_recovered(installed):
    """window = span + offset: the clocks differ by -START_US, the fit adds
    the median lag of the ranges before their spans (25 us)."""
    off = spans.fit_offset(_window(), spans.program_spans())
    assert abs(off - (-START_US)) < 50.0
    assert off == pytest.approx(-START_US - 25.0, abs=1.0)


def test_offset_survives_a_missing_and_a_stray_pair(monkeypatch):
    """A range without its span (dropped) and a span without its range
    (outside the window) leave the fit to the pairs that remain."""
    monkeypatch.setattr(program_trace, "_PROFILED", _buffer(
        [(500.0, "decode"), (2000.0, "decode"), (3000.0, "prefill")]))
    off = spans.fit_offset(_window(), spans.program_spans())
    assert abs(off - (-START_US)) < 50.0


def test_host_readers(installed):
    found = spans.program_spans()
    # serve.prefill 560 us less its 200 us wait; serve.decode 270 less 150
    assert spans.host_ms(found, "serve.prefill") == pytest.approx(0.36)
    assert spans.host_ms(found, "serve.decode") == pytest.approx(0.12)
    # two layers of 5 + 20 + 60 + 10 + 15 us a chunk
    assert spans.moe_host_ms(found) == pytest.approx(0.22)
    assert value("moe_host_share.prefill", _run()) == \
        pytest.approx(100 * 220 / 360)


def test_moe_roofline_reader(installed):
    p = flops.peaks("H100")
    hbm, fp64 = p["hbm_bytes_per_s"], p["fp64_flops"]

    def b(rows, cols, m):
        return flops.cim_bound(rows, cols, m, hbm, fp64)[0]

    d, de, q, kv = 8, 4, 8, 4
    dense = b(d, q, 8) + 2 * b(d, kv, 8) + b(q, d, 8) \
        + 2 * b(d, de, 8) + b(de, d, 8)                # wq wk wv wo, shared
    routed = sum(2 * b(d, de, r) + b(de, d, r)
                 for lay in ROUTED for r in lay if r)
    per_chunk_ms = 2 * dense + routed
    cim_us = (100 + 180) + 200                          # the two chunks
    assert value("cim_roofline.moe_prefill", _run(_window())) == \
        pytest.approx(100 * 2 * per_chunk_ms * 1e3 / cim_us)


def test_readers_find_nothing_without_spans(monkeypatch):
    monkeypatch.setattr(program_trace, "_PROFILED", None)
    for name in ("moe_host_share.prefill", "cim_roofline.moe_prefill"):
        assert value(name, _run(_window())) is None, name
    found = spans.program_spans()
    assert spans.host_ms(found, "serve.prefill") is None
    assert spans.host_ms(found, "serve.decode") is None
    assert spans.moe_host_ms(found) is None
    # a program without the reader (the parent of the spans)
    monkeypatch.delattr(program_trace, "profiled")
    assert spans.program_spans() == []


def test_moe_readers_find_nothing_on_a_dense_model(monkeypatch):
    buf = _buffer(CALLS)
    buf.events = [e for e in buf.events if not e["name"].startswith("moe.")]
    monkeypatch.setattr(program_trace, "_PROFILED", buf)
    assert value("moe_host_share.prefill", _run()) is None
    assert value("cim_roofline.moe_prefill", _run(_window())) is None
    assert spans.moe_host_ms(spans.of_buffer(buf)) is None
    assert spans.host_ms(spans.of_buffer(buf), "serve.prefill") == \
        pytest.approx(0.36)


def test_idle_split_names_the_innermost_span(installed):
    """Idle inside the ranges, split by the innermost span open: all of
    it is counted once; the range's tail after its span closes (the
    harness's synchronize) is in no span."""
    w = _window()
    on = spans.aligned(w, spans.program_spans())
    split = spans.idle_split(w, on)
    ranges = sum(e - s for _, s, e in w.ranges)
    busy_in = 100 + 40 + 180 + 100 + 200
    assert sum(split.values()) == pytest.approx(ranges - busy_in)
    rep = spans.report(w, spans.program_spans())
    assert rep["pairs"] == 3 and rep["ranges"] == 3
    assert 0.0 < rep["idle_below_share"] <= 1.0
    # the tails: 1555-1600, 2275-2300 and 3560-3600, and 2000-2005
    assert split[spans.NO_SPAN] == pytest.approx(45 + 25 + 40 + 5)
    assert split["moe.dispatch"] > 0 and split["serve.decode.wait"] > 0
