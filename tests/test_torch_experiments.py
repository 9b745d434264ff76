"""The port's B16 plain versions against the Pallas kernels of experiments/.

``experiments/mb_pallas.py`` is loaded as a module (with
``JAX_COMPILATION_CACHE_DIR=0``, so that ``enable_compile_cache`` leaves
JAX's config alone) and its shape globals set small. The gather scripts run
their whole experiment when imported, so their kernel functions are taken
out of the file by ``ast`` and compiled with small shape globals. Every
Pallas kernel runs on the CPU under ``pltpu.force_tpu_interpret_mode()``.
Outputs are integers and copied bits: the tolerance is exact equality
throughout. On CPU tensors the wrappers take their plain versions and
launch nothing.
"""
import ast
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pangea_tpu_torch.experiments import mb_gather as port_gather
from pangea_tpu_torch.experiments import mb_pallas as port_pallas
from pangea_tpu_torch.kernels import (block_copy, kernel_launches,
                                      reset_kernel_launches, row_gather,
                                      row_gather_direct, row_gather_plain,
                                      rowprobe_onehot, rowprobe_onehot_plain,
                                      rowprobe_plain, rowprobe_smem)

EXPERIMENTS = Path(__file__).resolve().parents[1] / "experiments"
# mb_pallas's globals, cut: NB rows, N queries, QT queries a grid step.
SMALL = {"NB": 256, "N": 4096, "QT": 512}
# The gathers: a [GATHER_ROWS, D] uint32 table, GATHER_N indices.
D, GATHER_ROWS, GATHER_N = 64, 1024, 1024


@pytest.fixture(scope="module")
def ref_pallas():
    """experiments/mb_pallas.py as a module, its shapes cut to SMALL."""
    path = list(sys.path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", "0")
        spec = importlib.util.spec_from_file_location(
            "ref_mb_pallas", EXPERIMENTS / "mb_pallas.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    sys.path[:] = path                   # the script prepends src/ paths
    for name, value in SMALL.items():
        setattr(mod, name, value)
    return mod


def _set_w(mod, w):
    mod.W, mod.LANES = w, 2 * w


def _tensors(world):
    return port_pallas.world_tensors(world, "cpu")


@pytest.mark.parametrize("w", [64, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_make_world_equals_the_reference(ref_pallas, seed, w):
    _set_w(ref_pallas, w)
    want = ref_pallas.make_world(seed)
    got = port_pallas.make_world(seed, SMALL["NB"], SMALL["N"], w)
    for a, b in zip(want, got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _reference(mod, name, world):
    fn = getattr(mod, name)
    args = tuple(jnp.asarray(a) for a in world)
    if name == "xla_lookup":
        return np.asarray(jax.jit(fn)(*args))
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*args))


@pytest.mark.parametrize("kernel", ["take_lookup", "oneh_lookup",
                                    "xla_lookup"])
@pytest.mark.parametrize("w", [64, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_rowprobe_plain_equals_the_pallas_kernels(ref_pallas, kernel, seed,
                                                   w):
    """rowprobe_plain and the one-hot product step by step, and both
    wrappers on CPU tensors, equal take_lookup, oneh_lookup (interpret
    mode) and xla_lookup bit for bit."""
    _set_w(ref_pallas, w)
    world = port_pallas.make_world(seed, SMALL["NB"], SMALL["N"], w)
    want = _reference(ref_pallas, kernel, world).view(np.int32)
    assert np.count_nonzero(want) > SMALL["N"] // 4          # planted hits
    args = _tensors(world)
    reset_kernel_launches()
    for fn in (rowprobe_plain, rowprobe_onehot_plain, rowprobe_smem,
               rowprobe_onehot):
        assert np.array_equal(fn(*args).numpy(), want), fn.__name__
    assert not any(kernel_launches().values())


def test_rowprobe_row_numbers_as_xla_takes_them(ref_pallas):
    """Row numbers past the table and below 0 as XLA's gather in
    xla_lookup takes them: from the end below 0, then clamped."""
    _set_w(ref_pallas, 64)
    t, b, rem = port_pallas.make_world(2, SMALL["NB"], SMALL["N"])
    nb = SMALL["NB"]
    b[:8] = [-1, -7, nb, nb + 5, -nb, -nb - 9, 2**31 - 1, -2**31]
    want = _reference(ref_pallas, "xla_lookup", (t, b, rem)).view(np.int32)
    args = _tensors((t, b, rem))
    for fn in (rowprobe_plain, rowprobe_onehot_plain):
        assert np.array_equal(fn(*args).numpy(), want), fn.__name__


def _gather_namespace(script, names, **shapes):
    """The functions ``names`` of experiments/``script``, compiled alone
    with the shape globals ``shapes``: importing the script would run its
    whole experiment."""
    tree = ast.parse((EXPERIMENTS / script).read_text())
    body = [n for n in tree.body
            if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in body) == sorted(names)
    ns = {"jax": jax, "jnp": jnp, "pl": pl, "pltpu": pltpu, **shapes}
    exec(compile(ast.Module(body=body, type_ignores=[]), script, "exec"), ns)
    return ns


# name -> (script, its functions, the call's (depth, chunk), direct)
GATHERS = {
    "gather2_pallas_gather": ("mb_gather2.py", ("gather_kernel",
                                                "pallas_gather"),
                              (16, 512), False),
    "gather3_d8_c512": ("mb_gather3.py", ("make_pallas_gather",), (8, 512),
                        False),
    "gather3_d32_c1024": ("mb_gather3.py", ("make_pallas_gather",),
                          (32, 1024), False),
    "gather5_hbm2hbm_d16_c512": ("mb_gather5.py", ("variant_hbm2hbm",),
                                 (16, 512), True),
    "gather5_hbm2hbm_d64_c1024": ("mb_gather5.py", ("variant_hbm2hbm",),
                                  (64, 1024), True),
    "gather5_vmem_out_d16_c512": ("mb_gather5.py", ("variant_vmem_out",),
                                  (16, 512), False),
}


def _pallas_gather(name):
    script, names, (depth, chunk), _ = GATHERS[name]
    ns = _gather_namespace(script, names, D=D, DEPTH=depth, CHUNK=chunk,
                           NP_Q=GATHER_N, NQ=GATHER_N)
    if names[0] == "gather_kernel":
        return ns["pallas_gather"]
    return ns[names[0]](depth, chunk)


@pytest.mark.parametrize("name", list(GATHERS))
def test_row_gather_plain_equals_the_pallas_gathers(name):
    """row_gather_plain, and row_gather in the call's mode on CPU tensors,
    equal each Pallas row gather (interpret mode) bit for bit."""
    table, idx = port_gather.make_world(5, GATHER_ROWS, GATHER_N)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_gather(name)(jnp.asarray(idx),
                                               jnp.asarray(table)))
    assert np.array_equal(want, table[idx])
    t, ix = port_gather.world_tensors((table, idx), "cpu")
    _, _, (depth, chunk), direct = GATHERS[name]
    reset_kernel_launches()
    for got in (row_gather_plain(t, ix),
                row_gather(t, ix, depth=depth, chunk=chunk, direct=direct)):
        assert np.array_equal(got.numpy().view(np.uint32), want)
    assert not any(kernel_launches().values())


def test_row_gather_indices_as_xla_takes_them():
    """Indices past the table and below 0 as XLA's gather takes them."""
    table, idx = port_gather.make_world(6, 100, 300)
    idx[:6] = [-1, -100, -101, 100, 2**31 - 1, -2**31]
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    t, ix = port_gather.world_tensors((table, idx), "cpu")
    for got in (row_gather_plain(t, ix),
                row_gather_direct(t, ix, depth=4, chunk=8)):
        assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("start", [0, 4], ids=["static", "dynamic"])
def test_block_copy_equals_the_gather4_slices(start):
    """mb_gather4's two DMA probes: rows [0, 8) and [4, 12) of x, the
    slices the script checks against (:99, :125)."""
    x = torch.from_numpy(port_gather.block_world())
    s = torch.tensor([start], dtype=torch.int32)
    reset_kernel_launches()
    got = block_copy(x, s, port_gather.BLOCK_ROWS)
    assert torch.equal(got, x[start:start + 8])
    assert block_copy.launches == 0


@pytest.mark.parametrize("module,argv", [
    (port_pallas, ["--nb", "128", "--queries", "3000"]),
    (port_gather, ["--nb", "512", "--queries", "1500"]),
], ids=["mb_pallas", "mb_gather"])
def test_entry_points_run_on_the_cpu(capsys, module, argv):
    """Each entry point with --device cpu: every variant at 0 mismatches,
    no kernel launched, the launches last."""
    assert module.main(["--device", "cpu", *argv]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    variants = lines[:-1]
    assert len(variants) == (3 if module is port_pallas
                             else len(port_gather.VARIANTS))
    for line in variants:
        assert line["mismatches"] == 0 and line["device"] == "cpu", line
        if module is port_pallas:             # every variant on every query
            assert line["queries"] == 3000, line
        else:                                 # the gathers' bound and ratio
            assert line["bound_ms"] > 0, line
            assert line["vs_yardstick"] == (line["ms"]
                                            / line["yardstick_ms"]), line
    assert not any(lines[-1]["kernel_launches"].values())


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """The experiments and `cli classify` share one rule: --device cuda
    without a card exits, with no fallback."""
    from pangea_tpu_torch import cli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((port_pallas.main, []), (port_gather.main, []),
                       (cli.main, ["classify", "--index", "absent"])):
        with pytest.raises(SystemExit, match="no CUDA device"):
            main(argv)
