"""How a serving run's `correct` is decided: a sample of the requests it
finished, drawn from the seed with the longest among them, is run once
through the plain reference (`reference/lm.py`) over each prompt and its
served tokens, and every served token is judged by how far its logit
lies below the reference's best at its position (greedy decoding serves
the best). Besides, every request must have been served whole.

The logit gap's limit is the configuration's ("check"); how many
requests are judged and how many served tokens they must hold at least
is the mix's ("check_sample", "min_sample_tokens"). The limits' readings
are in PERF.md.

The control (`--control 1`): the reference computed in TF32, the step
below the configuration's float32, is put in the program's place. At
each served position of the same sample it chooses the token it puts
first, and those tokens, not the program's, are judged by the same gap
and limit; the line must come out not correct. The program's own gap is
then reported beside it (`program_logit_gap`), not judged.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def sample(requests, n: int, seed: int) -> List:
    """n finished requests: the one that served most tokens, and n - 1
    drawn from `seed` among the others."""
    done = [r for r in requests if r.tokens]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.tokens), len(r.prompt)))
    rest = [r for r in done if r is not longest]
    rng = np.random.Generator(np.random.PCG64(seed + 2))
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


def sequences(reqs, device) -> List[torch.Tensor]:
    """Each prompt with its served tokens but the last (teacher-forced)."""
    return [torch.as_tensor(np.concatenate(
        [r.prompt, np.asarray(r.tokens[:-1], np.int64)]), device=device)
        for r in reqs]


def gaps(ref_logits: List[torch.Tensor], reqs,
         chosen: List[torch.Tensor]) -> float:
    """Widest gap by which a chosen token's reference logit lies below
    the reference's best, over every served position of `reqs`."""
    worst = 0.0
    for lg, r, tok in zip(ref_logits, reqs, chosen):
        lg = lg[len(r.prompt) - 1:]
        best = lg.max(dim=-1).values
        at = torch.gather(lg, -1, tok.long()[:, None])[:, 0]
        worst = max(worst, float((best - at).max()))
    return worst


def served_tokens(reqs, device) -> List[torch.Tensor]:
    return [torch.as_tensor(r.tokens, device=device) for r in reqs]


def serving_checks(run, params, x_cal, seed: int, *, control: bool = False
                   ) -> Tuple[Dict[str, Dict[str, float]], Dict[str, float]]:
    """(checks, readings). checks: name -> {"value", "limit"}: the
    widest logit gap of the sample's judged tokens (the program's, or
    with control the TF32 reference's), the requests not served whole,
    and the sample's served tokens. readings: with control, the
    program's own gap, judged by nothing."""
    from reference import lm

    from .traffic import max_len
    m = run.model
    keys = max_len(run.mix)
    short = sum(len(r.tokens) != r.max_new for r in run.requests)
    out = {"short_requests": {"value": float(short), "limit": 0.0}}
    reqs = sample(run.requests, int(run.mix["check_sample"]), seed)
    dev = params["embed"].device
    seqs = sequences(reqs, dev)
    readings = {}
    with torch.no_grad():
        ref = lm.logits(params, x_cal, seqs, m, keys)
        judged = served_tokens(reqs, dev)
        if control:
            readings["program_logit_gap"] = gaps(ref, reqs, judged)
            low = lm.logits(params, x_cal, seqs, m, keys, tf32=True)
            judged = [lg[len(r.prompt) - 1:].argmax(dim=-1)
                      for lg, r in zip(low, reqs)]
        out["logit_gap"] = {"value": gaps(ref, reqs, judged),
                            "limit": float(m["check"]["max_logit_gap"])}
        out["sample_tokens"] = {"value": float(sum(len(r.tokens)
                                                   for r in reqs)),
                                "limit": float(run.mix["min_sample_tokens"])}
    return out, readings


def passed(checks: Dict[str, Dict[str, float]]) -> bool:
    """Every number within its limit: at most the limit, except
    sample_tokens, which must reach it."""
    ok = True
    for name, c in checks.items():
        if name == "sample_tokens":
            ok &= c["value"] >= c["limit"]
        else:
            ok &= c["value"] <= c["limit"]
    return bool(ok)
