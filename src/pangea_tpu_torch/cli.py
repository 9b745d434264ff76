"""CLI of the PyTorch/CUDA port.

    python -m pangea_tpu_torch.cli classify --index idx/ [idx2/ ...] \\
        --reads r1.fq [--mates r2.fq] [--samples s] [--out dir] \\
        [--config run.json] [--device cuda] [key.dotted=value ...]

The flags are those of ``pangea-tpu classify``; every argument after the
known ones is a dotted config override (``config.py``), e.g.
``input.batch_size=8192``. Several indexes (built on one taxonomy) are
classified together and merged per read (SEMANTICS.md §9), as config 4
does with k=21 and k=31. ``--device`` names the torch device (default
``cuda``); there is no fallback to another device.

As the reference's CLI, a run takes the fast path (the native reader's
packed rows; reads past ``input.max_read_len`` are cut and counted) unless
``input.long_reads=true`` or ``PANGEA_NO_NATIVE`` is set, which take the
general path (the Python reader; long reads classified whole in length
buckets). The run names its path on stderr, and its result line, printed
last on stdout, carries ``fast_path`` and ``truncated_reads``.
"""
from __future__ import annotations

import argparse
import json
import re
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="pangea-tpu-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("classify", help="classify reads against an index")
    c.add_argument("--config", default=None, help="RunConfig JSON")
    c.add_argument("--index", nargs="+", default=None, help="index dir(s)")
    c.add_argument("--reads", nargs="+", default=None)
    c.add_argument("--mates", nargs="+", default=None,
                   help="mate-2 files (paired-end)")
    c.add_argument("--samples", nargs="+", default=None)
    c.add_argument("--out", default=None)
    c.add_argument("--resume", action="store_true")
    c.add_argument("--device", default="cuda",
                   help="torch device to classify on (default cuda)")
    c.add_argument("overrides", nargs="*",
                   help="dotted config overrides key.path=value")
    args = p.parse_args(argv)
    _rescue_overrides(args, sys.argv[1:] if argv is None else argv)
    return _cmd_classify(args)


# Dotted override shape: section.key=...; every real override has a dot.
_OVERRIDE_RE = re.compile(r"^[A-Za-z_]\w*(\.[A-Za-z_]\w*)+=")


def _rescue_overrides(args, argv) -> None:
    """argparse's greedy nargs='+' options swallow trailing overrides
    (``--samples m input.batch_size=32``): move anything shaped like a
    dotted override back into args.overrides, in original argv order."""
    argv = list(argv or [])
    used: set = set()

    def pos_of(tok):
        for i, a in enumerate(argv):
            if a == tok and i not in used:
                used.add(i)
                return i
        return len(argv) + len(used)

    rescued = []
    for name, val in vars(args).items():
        if name == "overrides" or not isinstance(val, list):
            continue
        keep, moved = [], []
        for v in val:
            (moved if isinstance(v, str) and _OVERRIDE_RE.match(v)
             else keep).append(v)
        if moved:
            setattr(args, name, keep)
            rescued += [(pos_of(v), v) for v in moved]
    rescued.sort(key=lambda t: t[0])
    args.overrides = [v for _, v in rescued] + list(args.overrides)


def _cmd_classify(args) -> int:
    import torch

    from .config import load_config
    from .pipeline import run_classify_basic
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available "
                         "(pass --device cpu to run the plain versions)")
    cfg = load_config(args.config, args.overrides)
    if args.index:
        cfg.classify.index = args.index
    if args.reads:
        cfg.input.reads = args.reads
    if args.mates:
        cfg.input.mates = args.mates
    if args.samples:
        cfg.input.samples = args.samples
    if args.out:
        cfg.classify.out_dir = args.out
    if args.resume:
        cfg.classify.resume = True
    result = run_classify_basic(cfg, device)
    print(json.dumps(result, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
