"""A whole run of each cell at smoke size on the CPU (the harness's look
for a chip skipped), against the plain reference; then the same run with
the timed path broken underneath, which must come out not correct."""
import pytest
import torch

import bp_smoke

WORKLOADS = ["granite20b.chat", "dsmoe16b.chat"]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    line, checks = bp_smoke.run_smoke(workload)
    assert line["correct"] is True, checks
    assert line["failed"] == 0 and line["attempted"] == 18
    assert checks["logit_gap"]["value"] == 0.0
    assert set(checks) == {"short_requests", "logit_gap", "sample_tokens"}
    assert set(line["metrics"]) == {"tokens_per_s", "ttft_p90_ms",
                                    "tpot_p90_ms", "setup_s"}
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_takes_the_programs_place(monkeypatch, workload):
    """With control, the tokens the lower-precision reference puts first
    are judged in the program's place, by the same gap and limit. The
    CPU has no TF32, so the lower precision is stood in for by logits
    whose best token is moved by one; the program's own gap is reported
    beside, unjudged."""
    from reference import lm
    real = lm.logits

    def logits(*args, tf32=False, **kw):
        out = real(*args, tf32=tf32, **kw)
        return [torch.roll(lg, 1, dims=-1) for lg in out] if tf32 else out
    monkeypatch.setattr(lm, "logits", logits)
    line, checks = bp_smoke.run_smoke(workload, control=True)
    assert line["info"]["program_logit_gap"] == 0.0
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]
    assert line["correct"] is False


def _break_decode(monkeypatch, fault):
    """Replace the engine's pool decode step by the sound one followed by
    `fault(pool)`, which undoes or alters part of what it did."""
    from repro_torch.launch import scheduler
    real = scheduler.make_pool_decode_step

    def make(cfg):
        step = real(cfg)

        def broken(params, pool):
            saved = {k: v.clone() for k, v in pool.items()}
            out = step(params, pool)
            fault(pool, saved)
            return out
        return broken
    monkeypatch.setattr(scheduler, "make_pool_decode_step", make)


def state_unchanged(pool, saved):
    """The step returns the cache as it found it."""
    for k in ("k", "v", "len"):
        pool[k].copy_(saved[k])


def half_left_out(pool, saved):
    """The upper half of the slots is left out of the step."""
    h = pool["tok"].shape[0] // 2
    for k in ("k", "v"):
        pool[k][:, h:].copy_(saved[k][:, h:])
    for k in ("len", "tok"):
        pool[k][h:].copy_(saved[k][h:])


def token_altered(pool, saved):
    """Slot 0's token is changed where the step produces it."""
    pool["tok"][0] = (pool["tok"][0] + 1) % 512


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   token_altered])
def test_broken_run_is_not_correct(monkeypatch, workload, fault):
    _break_decode(monkeypatch, fault)
    line, checks = bp_smoke.run_smoke(workload)
    assert line["correct"] is False
    assert checks["logit_gap"]["value"] > checks["logit_gap"]["limit"]
