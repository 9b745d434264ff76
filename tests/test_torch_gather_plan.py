"""K13's launch plan (``kernels/gather.py`` ``gather_plan``) on the CPU.

The plan is pure Python, so its promises are checked here for the shapes
the experiments and the GPU tests launch: it fits the card's shared memory,
its grid is no larger than the SMs hold, it gives at least 2,048 issuing
lanes wherever there are that many indices, and the kernel's split of the
indices (walked here as ``csrc/row_gather.cu`` ``Runs`` walks it) covers
every index exactly once.
"""
import numpy as np
import pytest

from pangea_tpu_torch.experiments import mb_gather
from pangea_tpu_torch.kernels.gather import (BARRIER_BYTES, SM_RESERVED,
                                             SMEM_OPTIN, gather_plan)

SMS = 132                 # an H100 SXM's SMs
ISSUERS = 2048            # issuing lanes the card needs (Little's law)


def _walk(plan, n: int, chunk: int) -> np.ndarray:
    """How often the kernel copies each index: block b's share of the runs,
    stepped `chunk` at a time, its warps taking runs in turn."""
    seen = np.zeros(n, dtype=np.int64)
    lanes = plan.lanes
    total = -(-n // lanes)
    per_block = -(-total // plan.grid) if plan.grid else 0
    per_chunk = -(-chunk // lanes)
    for b in range(plan.grid):
        lo = min(b * per_block * lanes, n)
        hi = min(lo + per_block * lanes, n)
        full, rest = divmod(hi - lo, chunk)
        count = full * per_chunk + -(-rest // lanes)
        for warp in range(plan.warps):
            for t in range(warp, count, plan.warps):
                c = t // per_chunk
                start = lo + c * chunk + (t - c * per_chunk) * lanes
                length = min(lanes, min(lo + (c + 1) * chunk, hi) - start)
                assert 1 <= length <= lanes
                seen[start:start + length] += 1
    return seen


def _check(n: int, depth: int, chunk: int, slot_bytes: int) -> None:
    plan = gather_plan(n, depth, chunk, slot_bytes, SMS, SMEM_OPTIN)
    assert plan.smem == plan.warps * plan.slots * (slot_bytes + BARRIER_BYTES)
    assert plan.smem <= SMEM_OPTIN
    assert 1 <= plan.lanes <= 32 and plan.slots % plan.lanes == 0
    assert 1 <= plan.warps <= 32
    per_sm = min((SMEM_OPTIN + SM_RESERVED) // (plan.smem + SM_RESERVED),
                 2048 // (32 * plan.warps), 32)
    assert plan.grid <= SMS * per_sm
    if slot_bytes <= 4096:          # the shared memory allows them
        assert plan.grid * plan.warps * plan.lanes >= min(ISSUERS, n)
    seen = _walk(plan, n, chunk)
    assert (seen == 1).all(), np.flatnonzero(seen != 1)[:10]


@pytest.mark.parametrize("variant", [v for v in mb_gather.VARIANTS
                                     if not v.startswith("gather4")])
def test_plan_of_each_experiment_variant(variant):
    """The seven gathers of experiments.mb_gather at their own shapes: the
    grid is the card's, not n / chunk."""
    n, depth, chunk, _ = mb_gather.VARIANTS[variant]
    _check(n, depth, chunk, mb_gather.D * 4)
    plan = gather_plan(n, depth, chunk, mb_gather.D * 4, SMS, SMEM_OPTIN)
    assert plan.lanes == 32 and plan.slots >= depth
    for other in (32, 512, 8192):        # the chunk never sets the grid
        assert gather_plan(n, depth, other, mb_gather.D * 4, SMS,
                           SMEM_OPTIN) == plan
    # rows in flight on the card: past the ~9,000 rows of 256 B that
    # 3.35 TB/s times ~0.7 us of latency asks for
    assert plan.grid * plan.warps * plan.slots >= 9000


@pytest.mark.parametrize("slot_bytes", [512, 4096], ids=["512B", "4KB"])
@pytest.mark.parametrize("chunk", [1, 5, 100, 4096])
@pytest.mark.parametrize("depth", [1, 3, 64])
@pytest.mark.parametrize("n", [0, 3, 77, 1000, 70_000])
def test_plan_of_the_gpu_tests_shapes(n, depth, chunk, slot_bytes):
    """The GPU tests' shapes: 8 rows of 64 B or of 512 B a copy."""
    _check(n, depth, chunk, slot_bytes)


def test_plan_of_the_block_copy():
    """mb_gather4's block copy: one index of 8 rows, a plan of one lane."""
    plan = gather_plan(1, 1, 1, 8 * 128 * 4, SMS, SMEM_OPTIN)
    assert (plan.grid, plan.warps, plan.lanes, plan.slots) == (1, 1, 1, 1)
    _check(1, 1, 1, 8 * 128 * 4)


def test_plan_near_the_slot_limits():
    """The largest copy that fits one slot takes one lane; a copy near the
    1 MB bulk-copy limit fits no block's shared memory and is refused."""
    largest = SMEM_OPTIN - BARRIER_BYTES
    for n in (1, 70_000):
        plan = gather_plan(n, 64, 4096, largest, SMS, SMEM_OPTIN)
        assert (plan.warps, plan.lanes, plan.slots) == (1, 1, 1)
        _check(n, 64, 4096, largest)
    with pytest.raises(ValueError, match="does not fit"):
        gather_plan(10, 1, 1, (1 << 20) - 16, SMS, SMEM_OPTIN)
    with pytest.raises(ValueError, match="does not fit"):
        gather_plan(10, 1, 1, largest + 16, SMS, SMEM_OPTIN)


@pytest.mark.parametrize("args", [(-1, 1, 1, 256), (10, 0, 1, 256),
                                  (10, 1, 0, 256), (10, 1, 1, 8)])
def test_plan_refuses_bad_arguments(args):
    with pytest.raises(ValueError):
        gather_plan(*args, SMS, SMEM_OPTIN)


def test_sweep_plans_fit_and_hold_the_plans_choice():
    """kernels.gather_sweep's plans fit a block, and the sweep includes
    what gather_plan picks for the experiments' 256-B rows."""
    from pangea_tpu_torch.kernels import gather_sweep
    swept = list(gather_sweep.plans(SMS, 256))
    for grid, warps, lanes, slots, per_sm in swept:
        assert warps * slots * (256 + BARRIER_BYTES) <= SMEM_OPTIN
        assert grid == SMS * per_sm
    plan = gather_plan(1 << 20, 16, 4096, 256, SMS, SMEM_OPTIN)
    assert any((w, lanes, s) == (plan.warps, plan.lanes, plan.slots)
               and grid >= plan.grid for grid, w, lanes, s, _ in swept)


def test_sweep_refuses_a_missing_card(monkeypatch):
    import torch

    from pangea_tpu_torch.kernels import gather_sweep
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert gather_sweep.main([]) == 1
