"""The comparison that decides ``correct``.

A served token is judged by how far its logit lies below the best logit of
the float32 reference at the same position, the reference having read the
prompt and the tokens served before it (teacher forcing).  A sample of the
window's finished requests, drawn from the seed, is judged; the number
compared is the widest such gap over every served token of the sample.

The control puts the reference in the program's place at the precision
below the configuration's (every matrix product's inputs rounded to fp8):
at each position of the same prompts and served tokens it reads the gap of
the token that the fp8 forward puts first.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


BLOCK_TOKENS = 2304     # tokens of one reference forward: its memory


def _blocks(n: int, size: int) -> List[slice]:
    return [slice(i, min(n, i + size)) for i in range(0, n, size)]


def widest_gaps(fam: Any, d: Dict[str, Any], weights: Dict[tuple, Any],
                prompts: np.ndarray, served: np.ndarray,
                device: torch.device, control: bool = False
                ) -> np.ndarray:
    """Per request, the widest gap below the reference's best logit of the
    tokens ``served`` (k, G + 1) after ``prompts`` (k, P): the program's
    own tokens, or with ``control`` the fp8 forward's first choices.  The
    reference reads as many requests at once as ``BLOCK_TOKENS`` holds."""
    G1 = served.shape[1]
    seq = np.concatenate([prompts, served[:, :-1]], axis=1)
    out = []
    for sl in _blocks(len(seq), max(1, BLOCK_TOKENS // seq.shape[1])):
        toks = torch.as_tensor(seq[sl], dtype=torch.long, device=device)
        ref = fam.logits(d, weights, toks, G1)                 # (b, G1, V)
        if control:
            pick = fam.logits(d, weights, toks, G1, quant="fp8").argmax(-1)
        else:
            pick = torch.as_tensor(served[sl], dtype=torch.long,
                                   device=device)
        gap = ref.amax(-1) - ref.gather(-1, pick[..., None])[..., 0]
        out.append(gap.amax(-1).double().cpu().numpy())
        del ref, pick, gap
    return np.concatenate(out)
