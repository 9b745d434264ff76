"""The multi-k merge of two classifiers' per-read calls (SEMANTICS.md §9).

Counterpart of ``pangea_tpu/classify/merge.py`` ``merge_multik_jnp``:
``merge_multik_plain`` on any device, and ``merge_multik``, which runs
kernel K7 (``csrc/merge_multik.cu``) on CUDA tensors. The confidences
b1/n1 and b2/n2 are compared exactly as the int64 products b1·n2 and b2·n1
(best and nvalid are counts, never negative), where the reference needs
16-bit limb products.
"""
from __future__ import annotations

import torch

from ..kernels import _build
from ..kernels.lookup import narrow
from ..kernels.score import _check_tax, lca_pairs_plain

_KEYS = ("taxon", "best", "nvalid")


def merge_multik_plain(res1: dict, res2: dict, tax: dict) -> dict:
    """Plain PyTorch merge. res1/res2: dicts of int32 [B] "taxon", "best",
    "nvalid"; tax: the taxonomy's device arrays (``parent``, ``depth``,
    ``up`` are read). Agreement keeps the more confident call, a conflict
    takes the LCA with the less confident call's (best, nvalid), ties go to
    res1; a one-sided call keeps the classified one; two unclassified calls
    give (0, 0, n1 + n2), the sum wrapping in int32."""
    t1, b1, n1 = (res1[k] for k in _KEYS)
    t2, b2, n2 = (res2[k] for k in _KEYS)
    x1 = b1.long() * n2.long()
    x2 = b2.long() * n1.long()
    both0 = (t1 == 0) & (t2 == 0)
    agree = (t1 != 0) & (t1 == t2)
    conflict = (t1 != 0) & (t2 != 0) & (t1 != t2)
    lca = lca_pairs_plain(t1, t2, tax["parent"], tax["depth"], tax["up"])
    taxon = torch.where(conflict, lca, torch.where(t1 != 0, t1, t2))
    keep1 = torch.where(agree, x1 >= x2,
                        torch.where(conflict, x1 <= x2, t1 != 0))
    best = torch.where(both0, 0, torch.where(keep1, b1, b2))
    nvalid = torch.where(both0, narrow(n1.long() + n2.long()),
                         torch.where(keep1, n1, n2))
    return {"taxon": taxon.to(torch.int32), "best": best.to(torch.int32),
            "nvalid": nvalid.to(torch.int32)}


def merge_multik(res1: dict, res2: dict, tax: dict) -> dict:
    """The merge: the plain version for CPU tensors, kernel K7
    (``csrc/merge_multik.cu``) for CUDA tensors. Same contract as
    :func:`merge_multik_plain`."""
    names = ("parent", "depth", "up")
    ins = [res1[k] for k in _KEYS] + [res2[k] for k in _KEYS]
    dev = _build.dispatch_device(*ins, *(tax[n] for n in names))
    if dev is None:
        return merge_multik_plain(res1, res2, tax)
    B = ins[0].shape[0]
    for t, name in zip(ins, [f"{k}1" for k in _KEYS]
                       + [f"{k}2" for k in _KEYS]):
        _build.check(t, torch.int32, shape=(B,), name=name)
    T1 = _check_tax(tax, names)
    out = torch.empty((3, B), dtype=torch.int32, device=dev)
    _build.launch("pangea_merge_multik", dev, *(t.data_ptr() for t in ins),
                  B, tax["parent"].data_ptr(), tax["depth"].data_ptr(),
                  tax["up"].data_ptr(), tax["up"].shape[0], T1,
                  *(o.data_ptr() for o in out))
    merge_multik.launches += 1
    return dict(zip(_KEYS, out))


merge_multik.launches = 0
