"""The program's spans in a traced stretch, and the rule that gives each
device record to one of them.

The program names its stages with ``torch.profiler.record_function``
ranges whose names start with ``gs.`` (``SPANS`` in
``gsplat_tpu_torch/utils/profiling.py``; the benchmark imports nothing of
the program). :func:`read_spans` takes them from the Chrome trace's
events, with each device record's launching call, as a
``tracing.Trace``'s ``ranges`` and ``calls`` would hold them. A trace
without those fields, or without the span a reader asks for, gives
``None`` from every function here, and the reader leaves its metric out.

The rule (a frozen copy of ``profiling.owners`` and ``profiling.nested``
in the program): a device record (kernel, copy or fill) belongs to the
runtime or driver call with the same ``correlation`` id; it is credited
to the innermost ``gs.*`` range that holds that call's start on the
call's own thread; failing that (work that autograd's device thread
launches while the caller waits in ``backward()``), to the innermost
``gs.*`` range on any thread that holds it; failing that, to none. Of
nested ranges the innermost is the one that starts last (of two that
start together, the shorter). A range's device time is the merged union
of the records credited to it and to the ranges inside its interval.

The readers of the spans, each per traced unit (``layer_metrics/``):

* ``host_enqueue_ms.serve``: host ms inside ``gs.frame``;
* ``idle_in_program_ms.serve`` / ``.train``: device idle ms inside
  ``gs.frame`` / ``gs.step``;
* ``binning_device_ms.serve``: device ms of ``gs.bin``;
* ``gather_device_ms.serve``: device ms of ``gs.gather``;
* ``pair_grads_device_ms.train``: device ms of ``gs.pair_grads``;
* ``update_device_ms.train``: device ms of ``gs.update``.

``tracing.capture`` fills a traced stretch's ``ranges`` and ``calls``
from :func:`read_spans`; ``tracing.read_events`` alone leaves them
empty.
"""

from __future__ import annotations

import bisect

from .stats import merged

PREFIX = "gs."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_CATS = ("cuda_runtime", "cuda_driver")


def read_spans(events: list):
    """(ranges, calls) from Chrome-trace events (times in microseconds):
    ``ranges`` ``[(name, tid, start_s, dur_s)]`` of the ``gs.*``
    ``user_annotation`` events; ``calls`` one ``(tid, start_s)`` or None
    per device record, in the order ``tracing.read_events`` keeps its
    ``device`` list."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    us = 1e-6
    ranges = [(e["name"], e.get("tid"), float(e["ts"]) * us,
               float(e["dur"]) * us) for e in xs
              if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(PREFIX)]
    call_of = {_corr(e): (e.get("tid"), float(e["ts"]) * us) for e in xs
               if e.get("cat") in CALL_CATS and _corr(e) is not None}
    calls = [call_of.get(_corr(e)) for e in xs
             if e.get("cat") in DEVICE_CATS]
    return ranges, calls


def _corr(e):
    return e.get("args", {}).get("correlation")


def _fields(tr):
    ranges = getattr(tr, "ranges", None) or []
    calls = getattr(tr, "calls", None) or []
    return ranges, calls


def owners(ranges: list, calls: list) -> list:
    """The index in ``ranges`` of the range each call's device record is
    credited to, or None (the rule above)."""
    def order(i):
        _, _, s, d = ranges[i]
        return (s, -d, i)

    def index(ix):
        ix = sorted(ix, key=order)
        return ix, [ranges[i][2] for i in ix]

    by_tid = {}
    for i, r in enumerate(ranges):
        by_tid.setdefault(r[1], []).append(i)
    per_tid = {tid: index(ix) for tid, ix in by_tid.items()}
    every = index(range(len(ranges)))

    def innermost(ix, starts, t):
        for k in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            _, _, s, d = ranges[ix[k]]
            if t <= s + d:
                return ix[k]
        return None

    out = []
    for call in calls:
        if call is None:
            out.append(None)
            continue
        tid, t = call
        own = innermost(*per_tid[tid], t) if tid in per_tid else None
        out.append(own if own is not None else innermost(*every, t))
    return out


def _inside(ranges: list, i: int) -> set:
    """The ranges inside range ``i``'s interval, itself included; of two
    with the same interval the later is inside the earlier."""
    _, _, s0, d0 = ranges[i]
    return {j for j, (_, _, s, d) in enumerate(ranges)
            if s0 <= s and s + d <= s0 + d0
            and ((s, d) != (s0, d0) or j >= i)}


def device_s(tr, name: str):
    """Device seconds of the ranges named ``name`` (each range's merged
    union of the records credited to it and to the ranges inside it,
    summed over the ranges), or None."""
    ranges, calls = _fields(tr)
    mine = [i for i, r in enumerate(ranges) if r[0] == name]
    if not mine or len(calls) != len(tr.device):
        return None
    by_owner = {}
    for rec, own in zip(tr.device, owners(ranges, calls)):
        by_owner.setdefault(own, []).append((rec[2], rec[2] + rec[3]))
    total = 0.0
    for i in mine:
        iv = [x for j in _inside(ranges, i) for x in by_owner.get(j, ())]
        total += sum(e - s for s, e in merged(iv))
    return total


def host_s(tr, name: str):
    """Host seconds inside the ranges named ``name``, or None."""
    ranges, _ = _fields(tr)
    durs = [d for n, _, _, d in ranges if n == name]
    return sum(durs) if durs else None


def idle_s(tr, name: str):
    """Seconds inside the ranges named ``name`` in which no device record
    (of any owner) ran, or None."""
    ranges, _ = _fields(tr)
    mine = [(s, s + d) for n, _, s, d in ranges if n == name]
    if not mine:
        return None
    busy = merged((s, s + d) for _, _, s, d in tr.device)
    total = 0.0
    for s0, s1 in mine:
        over = merged((max(s, s0), min(e, s1)) for s, e in busy
                      if s < s1 and e > s0)
        total += (s1 - s0) - sum(e - s for s, e in over)
    return total


def owned_share(tr):
    """Share of the device's merged busy time that belongs to some range,
    in [0, 1], or None."""
    ranges, calls = _fields(tr)
    if not ranges or len(calls) != len(tr.device):
        return None
    iv = [(s, s + d) for _, _, s, d in tr.device]
    held = [(rec[2], rec[2] + rec[3]) for rec, own in
            zip(tr.device, owners(ranges, calls)) if own is not None]
    busy = sum(e - s for s, e in merged(iv))
    return sum(e - s for s, e in merged(held)) / busy if busy else None
