"""later_index_enqueue_ms: host milliseconds a multi-k step call spends in
the spans of the indexes after the first (``pangea_tpu_torch/trace.py``
``index_steps``: ``step.index1`` and on), the process's totals over its
calls. Those totals span every multi-k step of the process: the warm-up's,
the measured window's and, in a traced run, the profiler window's, which
adds the profiler's host cost to each launch (the harness reads metrics
after that window). A later index's span holds its extract, lookup and
scorer launches and any wait of the host inside them. None
where the program keeps no such totals or ran no multi-k step."""


def read(run):
    try:
        from pangea_tpu_torch.trace import index_steps
    except ImportError:
        return None
    recs = index_steps()
    calls = sum(r["calls"] for r in recs if r["index"] == 0)
    later = [r["host_s"] for r in recs if r["index"] > 0]
    if not calls or not later:
        return None
    return sum(later) / calls * 1e3
