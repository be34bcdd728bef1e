"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample of
the requests it finished, drawn from the seed and holding the longest of
them, goes through the reference once each: the prompt and the served
tokens.  At every served position the number read is the gap by which the
served token's reference logit lies below the reference's best there.
The widest gap over the sample is held to the cell's limit
(``served_logit_gap``); every served token is greedy, so a sound run
reads only the rounding of the served precision (bf16, and the int8 of a
swapped session's pages, which the reference repeats on its own values).

The control reads the same positions with the reference in float8
(``Reference(lowp=True)``): the token that the lower precision puts first,
and its gap under the float32 reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import Reference
from .traffic import seed_rng


def choose(finished: list, k: int, seed: int) -> list:
    """The longest finished request and k - 1 others drawn from the seed."""
    if not finished:
        return []
    order = sorted(finished, key=lambda r: (-(len(r.prompt) + len(r.out)),
                                            r.idx))
    rest = order[1:]
    pick = seed_rng(seed, 2).permutation(len(rest))[:max(k - 1, 0)]
    return [order[0]] + [rest[i] for i in sorted(pick)]


def _gaps(ref_logits, chosen) -> np.ndarray:
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, chosen[:, None])[:, 0]
    return (best - got).cpu().numpy()


@torch.no_grad()
def served_gaps(config: dict, weights: dict, sample: list, *,
                control: bool = False) -> np.ndarray:
    """Per served token of the sample, the reference's gap of that token,
    and with ``control`` the gap of the token the float8 reference puts
    first at each position (else None)."""
    ref = Reference(config, weights)
    low = Reference(config, weights, lowp=True) if control else None
    served, lowered = [], []
    for r in sample:
        seq = list(r.prompt) + list(r.out[:-1])
        first = len(r.prompt) - 1
        dev = weights["embed"].device
        tok = torch.as_tensor(r.out, dtype=torch.long, device=dev)
        exp = ref.logits(seq, first, r.packed)
        served.append(_gaps(exp, tok))
        if low is not None:
            lp = low.logits(seq, first, r.packed)
            lowered.append(_gaps(exp, lp.argmax(dim=-1)))
            del lp
        del exp
    s = np.concatenate(served) if served else np.zeros(0)
    if not control:
        return s, None
    return s, (np.concatenate(lowered) if lowered else np.zeros(0))


def reference_precision():
    """float32 products without TF32, for the reference's whole run."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
