"""The benchmark's own instrumentation of calls into the program.

Spans are patched onto module attributes of the port from outside (the
method of the port's ``tools/torch_profile_main_path.py``): in a *staged*
pass each span synchronises the device before and after its call and adds
its host-clock time under its name; in a *profiled* pass each span is a
``torch.profiler.record_function`` range and synchronises nothing, so
that device idle time and the host span it falls in can be read from the
profiler's trace. The staged pass also counts, at the ``bp_run``
boundary, the work of every fused-BP call (``WorkCounter``) and the
shots handed to OSD.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import time
from collections import defaultdict

import torch

from .roofline import span_bound_s

PORT = "slidingwindowdecoder_torch"


def resolve(target: str):
    """``"pkg.module"`` or ``"pkg.module:Class"`` -> the object."""
    mod, _, cls = target.partition(":")
    obj = importlib.import_module(mod)
    return getattr(obj, cls) if cls else obj


class Patches:
    """Module attributes replaced for the life of a ``with`` block."""

    def __init__(self):
        self.saved = []

    def set(self, owner, attr, value):
        self.saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, attr, value in reversed(self.saved):
            setattr(owner, attr, value)
        self.saved.clear()


class Spans:
    """Named spans, ``mode`` "staged" (synchronised host-clock totals),
    "profiled" (profiler ranges) or "off" (none). ``names`` holds every
    name used."""

    def __init__(self, mode: str, cuda: bool):
        self.mode = mode
        self.sync = torch.cuda.synchronize if cuda else (lambda: None)
        self.totals = defaultdict(float)
        self.names = set()

    @contextlib.contextmanager
    def span(self, name):
        if self.mode == "off":
            yield
            return
        self.names.add(name)
        if self.mode == "profiled":
            with torch.profiler.record_function(name):
                yield
            return
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.totals[name] += time.perf_counter() - t0

    def wrap(self, name_of, fn):
        if self.mode == "off":
            return fn

        def wrapper(*a, **k):
            with self.span(name_of(*a, **k)):
                return fn(*a, **k)
        return wrapper


def port_bp_run():
    """Every (module, attribute) of the loaded port that holds ``ops.bp.
    bp_run`` (the decoders import it by name)."""
    original = importlib.import_module(f"{PORT}.ops.bp").bp_run
    return [(mod, "bp_run") for mod_name, mod in list(sys.modules.items())
            if mod_name.split(".")[0] == PORT and getattr(mod, "bp_run", None) is original]


class WorkCounter:
    """The work of the fused BP calls, counted at the ``bp_run`` boundary
    and accumulated on the device: the bound in seconds of each call that
    launched a ``bp_span`` kernel (``roofline.span_bound_s``), and the
    shots that OSD decoded."""

    def __init__(self, device):
        self.bound_s = torch.zeros((), dtype=torch.float64, device=device)
        self.osd_shots = torch.zeros((), dtype=torch.int64, device=device)
        self.calls = 0
        self._edges = {}
        self._launch_counter = resolve(f"{PORT}.ops.bp_cuda").bp_span

    def _launches(self):
        c = self._launch_counter
        return sum(getattr(c, a, 0) for a in ("launches", "pinned_launches", "wide_launches",
                                              "pinned_wide_launches", "plain_calls"))

    def wrap_bp_run(self, fn):
        def counted(garr, mv, prior, syndrome, history, error, done, iters, **k):
            key = id(garr["cn_valid"])
            if key not in self._edges:
                self._edges[key] = int(garr["cn_valid"].sum())
            live = (~done).sum().double()
            it0 = iters.clone()
            vn = k.get("vn_state")
            if k.get("masked") and vn is not None:
                undecided = (vn == -1).sum(dim=0 if k.get("state_layout") == "transposed"
                                           else 1)
            else:
                undecided = torch.full_like(it0, garr["n"])
            before = self._launches()
            out = fn(garr, mv, prior, syndrome, history, error, done, iters, **k)
            if self._launches() == before:
                return out
            num_iter = k["num_iter"]
            hist_from = {"full": 0, "tail": max(num_iter - 4, 0), "none": num_iter}[
                k.get("history_mode", "full")]
            its = (out[4] - it0).to(torch.int64)
            writes = ((its - hist_from).clamp_min(0) * undecided).sum()
            self.bound_s += span_bound_s(
                live=live, shot_iters=its.sum().double(), hist_writes=writes.double(),
                edges=self._edges[key], n=garr["n"], m=garr["m"],
                msg_bytes=2 if k.get("msg_dtype", "float32") == "bfloat16" else 4,
                ring_bytes=2 if k.get("hist_dtype", "float32") == "bfloat16" else 4,
                masked=bool(k.get("masked")))
            self.calls += 1
            return out
        return counted

    def count_core(self, out):
        if "osd_applied" in out:
            self.osd_shots += out["osd_applied"].sum()
