"""The readings a cell's correctness limit is set from: the program's
widest gap over many seeds (the lower reading) and the control's (the
upper reading).  ``readings.py`` runs them on the chip; the benchmark's own
runs do not.

Per seed the seed's weights are drawn into the program's parameters (one
set-up serves every seed), a short window at the cell's own load is
served, and the run's sample is judged as ``run.py`` judges it; on the
control seeds the same prompts and served tokens are read again with the
reference at fp8 in the program's place: the widest gap of the tokens it
puts first.  With ``diagnose``, per seed: the reference's margin between
its best and second-best logit (quartiles) and the share of served tokens
that repeat the token before them.
"""
from __future__ import annotations

import json

import numpy as np

from . import harness, judge
from . import traffic as gen
from . import weights as wts


def margins(fam, d, w, prompts, served, device) -> list:
    """Quartiles of the reference's top-1 minus top-2 logit over the
    judged positions."""
    import torch
    G1 = served.shape[1]
    seq = np.concatenate([prompts, served[:, :-1]], axis=1)
    out = []
    for i in range(len(seq)):
        toks = torch.as_tensor(seq[i:i + 1], dtype=torch.long, device=device)
        top = fam.logits(d, w, toks, G1).topk(2, dim=-1).values
        out.append((top[..., 0] - top[..., 1]).flatten().double().cpu())
    m = torch.cat(out).numpy()
    return np.quantile(m, [0.0, 0.25, 0.5, 0.75]).tolist()


def readings(s, seeds, control_seeds, seconds, diagnose=True):
    fn = s.traffic["function"]
    ex = s.backend.executor
    params = ex._state[fn].params
    check = s.traffic["check"]
    G1 = int(s.traffic["gen_len"]) + 1
    rows = []
    for seed in seeds:
        wseed = gen.weight_seed(seed)
        wts.fill(s.fam.leaves(s.dims), wseed, s.device, into=params)
        times = gen.arrivals(s.traffic, seconds, seed)
        prompts = gen.prompts(s.traffic, len(times), s.dims["vocab_size"],
                              seed)
        run, out = harness.window(s, times, prompts, seconds, 0.0)
        got = out["got"]
        full = np.flatnonzero(~np.isnan(run.completion) & (got == G1))
        sample = full[gen.check_sample(len(full), int(check["sample"]),
                                       seed)]
        w = wts.fill(s.fam.leaves(s.dims), wseed, s.device)
        p, sv = prompts[sample], out["served"][sample]
        row = {"seed": seed, "requests": len(times),
               "finished": len(full), "judged_tokens": int(sv.size)}
        row["program_gap"] = float(judge.widest_gaps(
            s.fam, s.dims, w, p, sv, s.device).max())
        if seed in control_seeds:
            row["control_gap"] = float(judge.widest_gaps(
                s.fam, s.dims, w, p, sv, s.device, control=True).max())
        if diagnose:
            row["margin_quartiles"] = margins(s.fam, s.dims, w, p[:4],
                                              sv[:4], s.device)
            row["repeats"] = float((sv[:, 1:] == sv[:, :-1]).mean())
            row["distinct"] = int(len(np.unique(sv)))
        del w
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows
