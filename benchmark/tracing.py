"""The traced window: harness spans around the program's layers, the
profiler over the window, and the reduction of its trace to device time.

`spans()` wraps the calls into a few of the program's layers in
`torch.profiler.record_function` ranges named `bench.<layer>` while the
traced run lasts, so that an idle gap of the device can be put down to
what the host was doing.  A function the program no longer has is left
out: its time falls to the span around it.

`Trace` reads the profiler's chrome trace: the device's kernels, copies
and fills in the window (the harness's `bench.window` range), their
union (busy time), the idle gaps and the spans that hold them, and device
time by layer.  A device event's layer is the first entry of
`kernel_layers.json` whose name pattern its name matches and whose span
is the innermost harness span around the host call that launched it (the
profiler's correlation id links the two).  An event that no entry
matches is `other`: it is never counted in a layer.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import json
import os
import re

import numpy as np

# (module, attribute path, span name): the calls into the program's layers
SPANS = (
    ("dsk_tpu_torch.engine.run", "plan_resources", "plan"),
    ("dsk_tpu_torch.dist.engine", "DistCountEngine.count_stream", "stream"),
    ("dsk_tpu_torch.dist.engine", "DistCountEngine.gather_tables", "gather"),
    ("dsk_tpu_torch.dist.engine", "DistCountEngine.hist_shard", "hist"),
)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAYERS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "kernel_layers.json")


@contextlib.contextmanager
def spans():
    """Wrap each SPANS call in a record_function range while the block
    runs, and restore the program's functions after it."""
    from torch.profiler import record_function

    undo = []
    for mod_name, path, span in SPANS:
        owner = importlib.import_module(mod_name)
        *outer, name = path.split(".")
        for part in outer:
            owner = getattr(owner, part, None)
        fn = getattr(owner, name, None) if owner is not None else None
        if fn is None:
            continue

        def wrap(f, label=f"bench.{span}"):
            @functools.wraps(f)
            def inner(*a, **kw):
                with record_function(label):
                    return f(*a, **kw)
            return inner

        setattr(owner, name, wrap(fn))
        undo.append((owner, name, fn))
    try:
        yield
    finally:
        for owner, name, fn in reversed(undo):
            setattr(owner, name, fn)


def load_layers() -> list[tuple[str, re.Pattern, str | None]]:
    """(layer, name pattern, launching span or None for any)."""
    with open(LAYERS_FILE) as f:
        table = json.load(f)["layers"]
    return [(e["layer"], re.compile(e["name"]), e.get("span"))
            for e in table]


def gaps(iv: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """(start, end) of the gaps in [lo, hi] that no interval of `iv`
    ((n, 2) starts and ends) covers."""
    if iv.shape[0] == 0:
        return np.array([[lo, hi]])
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    # a gap runs from the latest end so far to the next start
    ends = np.maximum.accumulate(iv[:, 1])
    g = np.stack([np.concatenate([[lo], ends]),
                  np.concatenate([iv[:, 0], [hi]])], axis=1)
    g = np.clip(g, lo, hi)
    return g[g[:, 1] > g[:, 0]]


class Trace:
    """The device events and harness spans of one traced window."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans_ = [e for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and str(e.get("name", "")).startswith("bench.")]
        win = [e for e in spans_ if e["name"] == "bench.window"]
        if not win:
            raise ValueError("the trace holds no bench.window range")
        self.lo = float(win[0]["ts"])
        self.hi = self.lo + float(win[0]["dur"])
        dev = [e for e in events if e.get("ph") == "X"
               and e.get("cat") in DEVICE_CATS]
        self.names = [str(e.get("name", "")) for e in dev]
        iv = np.array([[float(e["ts"]), float(e["ts"]) + float(e["dur"])]
                       for e in dev]).reshape(-1, 2)
        iv = np.clip(iv, self.lo, self.hi)
        self.iv = iv
        self.dur_us = iv[:, 1] - iv[:, 0]
        self.spans = [(e["name"][len("bench."):], float(e["ts"]),
                       float(e["ts"]) + float(e["dur"])) for e in spans_
                      if e["name"] != "bench.window"]
        launched = {(e.get("args") or {}).get("correlation"): float(e["ts"])
                    for e in events if e.get("ph") == "X"
                    and e.get("cat") in LAUNCH_CATS
                    and (e.get("args") or {}).get("correlation") is not None}
        launch_ts = np.array([launched.get(
            (e.get("args") or {}).get("correlation"), np.nan) for e in dev])
        self.span_of = self.innermost(launch_ts)
        self.layers = load_layers()
        self.layer_of = [self._layer(n, sp)
                         for n, sp in zip(self.names, self.span_of)]

    def _layer(self, name: str, span: str) -> str:
        for layer, pat, want in self.layers:
            if pat.search(name) and want in (None, span):
                return layer
        return "other"

    def innermost(self, t: np.ndarray) -> np.ndarray:
        """The innermost harness span that holds each time of `t`
        ('harness' outside every span)."""
        label = np.full(t.shape[0], "harness", dtype=object)
        since = np.full(t.shape[0], -np.inf)
        # spans in start order, the longer first where two start together,
        # so that the innermost span holding a time is the last to match
        for name, s0, s1 in sorted(self.spans, key=lambda x: (x[1], -x[2])):
            inside = (t >= s0) & (t < s1) & (s0 >= since)
            label[inside] = name
            since[inside] = s0
        return label

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) * 1e-6

    @property
    def busy_s(self) -> float:
        idle = gaps(self.iv[self.dur_us > 0], self.lo, self.hi)
        return (self.hi - self.lo - float((idle[:, 1] - idle[:, 0]).sum())
                ) * 1e-6

    def device_s(self, layer: str) -> float:
        """Summed device time of the events of one layer."""
        return float(sum(d for d, lay in zip(self.dur_us, self.layer_of)
                         if lay == layer)) * 1e-6

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [name, seconds]."""
        tot: dict[str, float] = {}
        for n, d in zip(self.names, self.dur_us):
            tot[n] = tot.get(n, 0.0) + float(d)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:200], v * 1e-6] for n, v in best]

    def idle_by_span(self, top: int = 10) -> list[list]:
        """Idle device time by the innermost harness span that held the
        gap's midpoint ('harness' outside every span): [span, seconds]."""
        g = gaps(self.iv[self.dur_us > 0], self.lo, self.hi)
        label = self.innermost((g[:, 0] + g[:, 1]) / 2)
        tot: dict[str, float] = {}
        for lab, length in zip(label, g[:, 1] - g[:, 0]):
            tot[lab] = tot.get(lab, 0.0) + float(length)
        best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n, v * 1e-6] for n, v in best]
