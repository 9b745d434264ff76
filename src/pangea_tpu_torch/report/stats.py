"""Per-sample diversity statistics, numpy only.

The port's copy of the parts of ``pangea_tpu/report/stats.py`` that a
classify run writes into ``stats.json`` (:func:`sample_stats`). All
functions take per-taxon direct count vectors restricted to classified
taxa.
"""
from __future__ import annotations

import numpy as np


def _counts(x) -> np.ndarray:
    c = np.asarray(x, dtype=np.int64)
    return c[c > 0]


def richness(counts) -> int:
    """Observed taxa (S_obs)."""
    return int(_counts(counts).size)


def shannon(counts) -> float:
    """Shannon H' (natural log)."""
    c = _counts(counts)
    if c.size == 0:
        return 0.0
    p = c / c.sum()
    return float(-(p * np.log(p)).sum())


def simpson(counts) -> float:
    """Simpson diversity 1 - sum(p^2)."""
    c = _counts(counts)
    if c.size == 0:
        return 0.0
    p = c / c.sum()
    return float(1.0 - (p * p).sum())


def chao1(counts) -> float:
    """Chao1 richness estimator: S_obs + F1^2 / (2*F2) (bias-corrected when
    F2 = 0: S_obs + F1*(F1-1)/2)."""
    c = _counts(counts)
    s_obs = c.size
    f1 = int((c == 1).sum())
    f2 = int((c == 2).sum())
    if f2 > 0:
        return float(s_obs + f1 * f1 / (2.0 * f2))
    return float(s_obs + f1 * (f1 - 1) / 2.0)


def ace(counts, rare_threshold: int = 10) -> float:
    """ACE richness estimator (Chao & Lee 1992)."""
    c = _counts(counts)
    rare = c[c <= rare_threshold]
    abund = c[c > rare_threshold]
    n_rare = int(rare.sum())
    s_rare = rare.size
    s_abund = abund.size
    f1 = int((c == 1).sum())
    if n_rare == 0 or n_rare == f1:
        return float(s_abund + s_rare)
    c_ace = 1.0 - f1 / n_rare
    ks = np.arange(1, rare_threshold + 1)
    fk = np.array([(c == k).sum() for k in ks], dtype=np.float64)
    gamma = max((s_rare / c_ace) * (ks * (ks - 1) @ fk)
                / (n_rare * (n_rare - 1)) - 1.0, 0.0) if n_rare > 1 else 0.0
    return float(s_abund + s_rare / c_ace + (f1 / c_ace) * gamma)


def sample_stats(counts) -> dict:
    """The standard per-sample summary block."""
    return {
        "richness": richness(counts),
        "shannon": shannon(counts),
        "simpson": simpson(counts),
        "chao1": chao1(counts),
        "ace": ace(counts),
    }
