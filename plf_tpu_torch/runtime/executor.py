"""Streaming PLF executor: host->device transfer overlapped with compute.

Counterpart of ``plf_tpu/runtime/executor.py``, the re-design of the
reference's async queue pipeline (``app/src/host_mem.cpp:249-394``):
there, per instance, two xrt::queues chain ``bo.write(left) ||
bo.write(right) -> {mm2sleft, mm2sright, s2mm} -> bo.read(out)``, so call
k+1's PCIe writes overlap call k's compute.  JAX got that overlap from
async dispatch; here it is spelled out with CUDA streams:

* each call's site-major inputs are copied into pinned host buffers of
  its own and uploaded with ``non_blocking`` copies on a side stream,
  which records an event;
* the compute stream waits on that event, converts the layout on the
  device (site-major ``(n, C*S)`` to lane-major ``(S*C, n_pad)``, so the
  host does no transpose), runs kernel 1 (kernel 1m in fp32 mode at
  S != 4: ``plf_node(..., variant="vpu")``), turns the parent back to
  site-major and downloads it into a pinned buffer;
* so call k+1's upload runs while call k's kernel does.

A pinned buffer set is written only after the upload from it has ended
(its event), and the executor keeps ``inflight + 1`` sets, so a result's
download buffer is read on the host before a later call writes it.  On
the CPU (``device="cpu"``) the same steps run in order, with the plain
versions of the kernels.

Two timing modes (``timing_mode=``), as in the JAX executor:

* ``"pipelined"`` (default): maximum overlap; the per-phase timestamps
  are enqueue times, so only ``total`` and the wall clock are
  trustworthy (the reference's "roundtrip" mode has the same property,
  ``host_mem.cpp:349-378``).
* ``"fenced"``: each phase is synchronised before its timestamp, so
  hm/msm/mh are per-phase times at the cost of serialisation (the
  reference's "intermediate" mode, ``host_mem.cpp:294-318``).
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from ..config import PLFConfig
from ..devices import resolve_device
from ..ops import layout as L
from ..ops.plf_node import plf_node
from ..utils.timing import Timer, TimingData

__all__ = ["StreamingExecutor"]


class _Slot:
    """One call's pinned host buffers and the event that ends its
    upload."""

    def __init__(self):
        self.host = {}
        self.uploaded = None

    def buffer(self, name, shape, dtype, pin):
        t = self.host.get(name)
        if t is None or tuple(t.shape) != tuple(shape):
            t = torch.empty(shape, dtype=dtype, pin_memory=pin)
            self.host[name] = t
        return t


class StreamingExecutor:
    """Pipelines a stream of PLF calls with host<->device overlap.

    Example::

        ex = StreamingExecutor(PLFConfig())          # on the card
        for x3, scaler_inc in ex.run(calls):         # calls yields inputs
            ...
    """

    def __init__(self, config: Optional[PLFConfig] = None,
                 inflight: int = 2,
                 device: Union[str, torch.device] = "cuda",
                 timing_mode: str = "pipelined"):
        if timing_mode not in ("pipelined", "fenced"):
            raise ValueError(f"unknown timing_mode {timing_mode!r}")
        self.config = config or PLFConfig()
        # fenced mode serialises phases by construction; more in flight
        # would only blur the attribution it exists to provide
        self.inflight = 1 if timing_mode == "fenced" else max(1, inflight)
        self.timing_mode = timing_mode
        self.device = resolve_device(device)
        self.timing = TimingData()
        cuda = self.device.type == "cuda"
        self._cuda = cuda
        self._copy_stream = torch.cuda.Stream(self.device) if cuda else None
        self._slots = [_Slot() for _ in range(self.inflight + 1)]
        self.calls = 0

    def _sync(self):
        if self._cuda:
            torch.cuda.synchronize(self.device)

    def _upload(self, call, slot: _Slot):
        """Host->device: pinned staging and non_blocking copies on the
        side stream (in order on the CPU).  Returns ``n`` and the device
        tensors, site-major."""
        cfg = self.config
        S, C = cfg.states, cfg.categories
        e = S * C
        x1, x2, left, right, ev, wgt = call
        x1 = np.asarray(x1, np.float32).reshape(-1, e)
        x2 = np.asarray(x2, np.float32).reshape(-1, e)
        n = x1.shape[0]
        if x2.shape[0] != n:
            raise ValueError(f"x1/x2 site count mismatch: {n} vs "
                             f"{x2.shape[0]}")
        host = dict(
            x1=x1, x2=x2,
            lc=L.branch_to_lane_constants(np.asarray(left, np.float32), S, C),
            rc=L.branch_to_lane_constants(np.asarray(right, np.float32), S,
                                          C),
            ec=L.ev_to_lane_constants(np.asarray(ev, np.float32), S, C),
            w=np.asarray(wgt if wgt is not None else np.ones(n), np.int32))
        if slot.uploaded is not None:
            slot.uploaded.synchronize()   # the last upload from these buffers
        dev = {}
        stream = self._copy_stream
        with torch.cuda.stream(stream) if self._cuda else nullcontext():
            for name, a in host.items():
                buf = slot.buffer(name, a.shape, torch.from_numpy(a).dtype,
                                  self._cuda)
                buf.numpy()[...] = a
                dev[name] = buf.to(self.device, non_blocking=self._cuda)
            if self._cuda:
                slot.uploaded = torch.cuda.Event()
                slot.uploaded.record(stream)
        return n, dev

    def _compute(self, n, dev, slot: _Slot):
        """Layout in, kernel, layout out on the device; the download into
        the slot's pinned buffer is enqueued.  Returns the host buffer of
        the parent, the device scaler increment and the event that ends
        the download."""
        cfg = self.config
        S, C = cfg.states, cfg.categories
        rows = S * C
        if self._cuda:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(slot.uploaded)
            for t in dev.values():
                t.record_stream(cur)
        n_pad = L.sites_padding(n, cfg.block_sites)
        lane = []
        for name in ("x1", "x2"):
            x = torch.zeros((rows, n_pad), dtype=torch.float32,
                            device=self.device)
            x[:, :n].view(S, C, n).copy_(
                dev[name].view(n, C, S).permute(2, 1, 0))
            lane.append(x)
        x3, sc = plf_node(lane[0], lane[1], dev["lc"], dev["rc"], dev["ec"],
                          n, states=S, categories=C, out=lane[0],
                          variant="vpu")
        inc = (sc[0, :n].to(torch.int64) * dev["w"].to(torch.int64)).sum()
        site = torch.empty((n, C, S), dtype=torch.float32,
                           device=self.device)
        site.copy_(x3[:, :n].view(S, C, n).permute(2, 1, 0))
        out = slot.buffer("x3", (n, C, S), torch.float32, self._cuda)
        out.copy_(site, non_blocking=self._cuda)
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record(cur)
        return out, inc, done

    def run(self, calls: Iterable[Tuple]) -> Iterator[Tuple]:
        """Stream calls through the device; yields ``(x3, scaler_increment)``.

        ``calls`` yields ``(x1, x2, left, right, ev, wgt)`` in site-major
        host layout; results come back site-major as numpy arrays.  Keeps
        ``inflight`` calls queued so the upload of call k+1 overlaps the
        compute of call k (``host_mem.cpp:287-325``).
        """
        t = Timer()
        pending = []
        it = iter(calls)
        fenced = self.timing_mode == "fenced"

        def launch(call):
            slot = self._slots[self.calls % len(self._slots)]
            self.calls += 1
            begin = t.elapsed_ms()
            n, dev = self._upload(call, slot)
            if fenced:
                self._sync()
            t1 = t.elapsed_ms()
            out, inc, done = self._compute(n, dev, slot)
            if fenced:
                self._sync()
            t2 = t.elapsed_ms()
            return out, inc, done, begin, t1, t2

        def drain(entry):
            out, inc, done, begin, t1, t2 = entry
            if done is not None:
                done.synchronize()
            x3 = out.numpy().copy()
            inc_h = int(inc)
            self.timing.record(begin, t1, t2, t.elapsed_ms())
            return x3, inc_h

        exhausted = False

        def try_launch():
            nonlocal exhausted
            if exhausted:
                return
            try:
                call = next(it)
            except StopIteration:
                exhausted = True
                return
            pending.append(launch(call))

        while not exhausted and len(pending) < self.inflight:
            try_launch()
        while pending:
            entry = pending.pop(0)
            try_launch()   # refill before the blocking drain: overlap
            yield drain(entry)

    def run_repeated(self, call, plf_calls: int) -> Tuple:
        """The reference benchmark shape: the same node pair, K times
        (host_mem.cpp plf_calls loop).  Returns the last result."""
        out = None
        for out in self.run(call for _ in range(plf_calls)):
            pass
        return out

    def run_chunked(self, x1, x2, left, right, ev, wgt=None,
                    chunk_sites: int = 1 << 22):
        """One giant PLF split into device-sized site chunks streamed
        through :meth:`run` (the reference sweeps up to 1e9 sites from host
        RAM, ``Makefile:16``).  ``chunk_sites`` is rounded down to the
        config's padding unit (at least one).  Returns ``(x3 (n, C, S),
        summed weighted rescale count)``."""
        cfg = self.config
        S, C = cfg.states, cfg.categories
        x1 = np.asarray(x1, np.float32).reshape(-1, C * S)
        x2 = np.asarray(x2, np.float32).reshape(-1, C * S)
        n = x1.shape[0]
        wgt = np.asarray(np.ones(n) if wgt is None else wgt, np.int32)
        chunk_sites = max(cfg.block_sites,
                          chunk_sites // cfg.block_sites * cfg.block_sites)

        def calls():
            for lo in range(0, n, chunk_sites):
                hi = min(lo + chunk_sites, n)
                yield (x1[lo:hi], x2[lo:hi], left, right, ev, wgt[lo:hi])

        outs, inc_total = [], 0
        for x3, inc in self.run(calls()):
            outs.append(x3.reshape(-1, C * S))
            inc_total += inc
        return np.concatenate(outs, axis=0).reshape(n, C, S), inc_total

