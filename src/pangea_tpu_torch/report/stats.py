"""Per-sample diversity statistics, numpy only.

The port's copy of ``pangea_tpu/report/stats.py``: the statistics a
classify run writes into ``stats.json`` (:func:`sample_stats`), the
expected richness at subsampling depths (:func:`rarefaction`) and the
Bray-Curtis dissimilarity of two samples. All functions take per-taxon
direct count vectors restricted to classified taxa.
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


def rarefaction(counts, depths, seed: int = 0) -> list[tuple[int, float]]:
    """Expected richness at each subsampling depth (the analytic
    hypergeometric expectation: deterministic, no resampling; ``seed`` is
    unused, as in the reference)."""
    from scipy.special import gammaln

    def logc(a, b):
        return gammaln(a + 1) - gammaln(b + 1) - gammaln(a - b + 1)

    c = _counts(counts).astype(np.float64)
    n = c.sum()
    out = []
    for d in depths:
        d = min(int(d), int(n))
        if d <= 0 or n <= 0:
            out.append((d, 0.0))
            continue
        # E[S_d] = sum_i (1 - C(n - c_i, d) / C(n, d)), by log-gammas.
        with np.errstate(all="ignore"):
            term = np.where(n - c >= d,
                            np.exp(logc(n - c, d) - logc(n, d)), 0.0)
        out.append((d, float((1.0 - term).sum())))
    return out


def bray_curtis(a, b) -> float:
    """Bray-Curtis dissimilarity between two count vectors (same length)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    denom = a.sum() + b.sum()
    if denom == 0:
        return 0.0
    return float(np.abs(a - b).sum() / denom)


def sample_stats(counts) -> dict:
    """The standard per-sample summary block."""
    return {
        "richness": richness(counts),
        "shannon": shannon(counts),
        "simpson": simpson(counts),
        "chao1": chao1(counts),
        "ace": ace(counts),
    }
