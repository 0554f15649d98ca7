"""Whether what the timed path produced is right.

Serving: after the window, a sample drawn from the seed of the requests
that completed (always with the one that served most tokens and the one
with the longest prompt and answer) is run once through the plain
reference over its prompt and served tokens.  For each served token the
gap by which its reference logit lies below the reference's best logit
at that position is read; the number compared is the widest gap over the
sample (``max_logit_gap``).  The control reads, at the same positions,
the gap of the token that the float8 reference puts first.

Training and CTR cells compare norms leaf by leaf
(:func:`gap_by_worst_leaf`), and every cell holds each number it compares
under its upper limit (:func:`verdict_checks`, the training and CTR
drivers' own).
"""

from __future__ import annotations

import numpy as np
import torch

from harness import reference
from harness.traffic import rng


def sample_requests(outcomes, prompt_lens, served, seed: int,
                    min_tokens: int, min_requests: int = 1) -> list[int]:
    """Indices of completed requests to check: the one with most served
    tokens, the longest in all, then others in a seeded order until the
    sample holds ``min_tokens`` served tokens and ``min_requests``
    requests."""
    done = [i for i, o in enumerate(outcomes) if o == "completed"]
    if not done:
        return []
    most = max(done, key=lambda i: (len(served[i]), -i))
    longest = max(done, key=lambda i: (prompt_lens[i] + len(served[i]), -i))
    pick = list(dict.fromkeys([most, longest]))
    order = rng(seed, 2).permutation(len(done))
    for j in order:
        if (sum(len(served[i]) for i in pick) >= min_tokens
                and len(pick) >= min_requests):
            break
        if done[j] not in pick:
            pick.append(done[j])
    return pick


def served_gaps(w, m: dict, prompt: np.ndarray, served: list[int], *,
                device, control: bool = False) -> dict:
    """The gap of each token of ``served`` below the reference's best
    logit at its position, and with ``control`` the gap of the token that
    the float8 reference puts first there (float64 numpy arrays)."""
    toks = torch.as_tensor(np.concatenate([np.asarray(prompt, np.int64),
                                           np.asarray(served[:-1],
                                                      np.int64)]),
                           device=device)
    ref = reference.served_logits(w, m, toks, len(prompt))
    best = ref.max(-1).values
    got = torch.as_tensor(np.asarray(served, np.int64), device=device)
    out = {"gaps": (best - ref.gather(1, got[:, None])[:, 0]).double()
           .cpu().numpy()}
    del got
    if control:
        ctl = reference.served_logits(w, m, toks, len(prompt), quant="fp8")
        pick = ctl.argmax(-1)
        out["control_gaps"] = (best - ref.gather(1, pick[:, None])[:, 0]
                               ).double().cpu().numpy()
        del ctl
    return out


def _summary(gaps: np.ndarray, prefix: str = "") -> dict:
    return {f"{prefix}max_logit_gap": float(gaps.max()),
            f"{prefix}mean_logit_gap": float(gaps.mean()),
            f"{prefix}off_argmax_share": float((gaps > 0).mean())}


def judge_served(w, m: dict, picks, prompts, served, *, device,
                 control: bool = False) -> dict:
    """Over every served token of the sampled requests: the widest gap,
    the mean gap and the share of tokens off the reference's argmax (and
    the same of the control's choices)."""
    gaps, ctl = [], []
    for i in picks:
        g = served_gaps(w, m, prompts[i], served[i], device=device,
                        control=control)
        gaps.append(g["gaps"])
        if control:
            ctl.append(g["control_gaps"])
    if not gaps:
        return {"max_logit_gap": None, "mean_logit_gap": None,
                "checked_requests": 0, "checked_tokens": 0}
    out = {**_summary(np.concatenate(gaps)),
           "checked_requests": len(picks),
           "checked_tokens": int(sum(len(g) for g in gaps))}
    if control:
        out.update(_summary(np.concatenate(ctl), "control_"))
    return out


def gap_by_worst_leaf(prog: dict, ref: dict, keep=None) -> tuple:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref);
    (gap, leaf)."""
    names = [k for k in ref if keep is None or k in keep]
    vals = sorted(ref[k] for k in names)
    med = vals[len(vals) // 2]
    worst = max(names, key=lambda k: abs(prog[k] - ref[k])
                / max(ref[k], med, 1e-30))
    return abs(prog[worst] - ref[worst]) / max(ref[worst], med, 1e-30), worst


def verdict_checks(cell, got: dict) -> tuple[dict, bool]:
    """Each number compared beside its limit (``limits`` of the cell, all
    upper limits), and whether all hold."""
    checks = {k: {"value": got[k], "limit": v}
              for k, v in cell.params["limits"].items()}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())
