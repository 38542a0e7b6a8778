"""Spans and counters of the port's detectors.

Spans mark the layer boundaries of the detect paths (``eval``,
``proposals``, ``ops/bev``, ``faster_rcnn_2d``), named by layer with dots:
``detect``, ``detect.proposals``, ``detect.proposals.nms``, ... A span
opened while no other is open is a root and starts a request.

Tracing is off by default and switched by ``enable()``, ``disable()`` or
the ``tracing()`` context; nothing else turns it on. Off, ``span(name)``
checks one flag and returns one shared null context: it records nothing
and enters no ``torch.profiler.record_function``, which costs some 13 us
an enter and exit even with no profiler running. On, a span records in
memory its name, parent, request, start and end (``time.perf_counter_ns``)
and the change of every counter over it, and enters
``record_function(name)``, so that under a running ``torch.profiler`` it
is an event on the clock of the device's kernels and copies.
``records()`` hands the finished spans to a reader and ``clear()`` drops
them; nothing is written to disk. Spans are one thread's: the detectors
run on the thread that calls them.

Counters are plain ints, counted whether tracing is on or off:
  * ``host_syncs``: blocking device-to-host reads on the detect paths:
    each tensor ``eval.frame_detections`` copies to the host, and each
    ``torch.equal`` round of ``ops/nms.nms_matrix`` and ``nms_blocked``;
  * ``assembly_boxes`` and ``assembly_kept``: the boxes
    ``eval.frame_detections`` hands to its per-class NMS (those above the
    score threshold), and those the NMS keeps (before the per-frame cap).
    ``counters()`` leaves these two out: a span reader takes every name
    there but ``host_syncs`` and ``nms_rounds`` for a kernel's launches;
  * ``nms_rounds``: fixpoint rounds of ``nms_matrix``, ``nms_blocked`` and
    ``nms_blocked_fixed`` (a step of the greedy ``nms_plain`` is no round;
    300 spans a call would cost some 4 ms, so steps are not spanned);
  * the hand kernels' launches, the ``launches`` ints of the
    ``ops/*_cuda.py`` wrappers, read where they are (``nms_greedy_cuda``
    counts its two kernels a call, so that the count matches the trace's
    kernel events).
"""

import contextlib
import itertools
import time

import torch

host_syncs = 0
assembly_boxes = 0
assembly_kept = 0
nms_rounds = 0

_NULL = contextlib.nullcontext()
_on = False
_open = []        # the spans open now, outermost first
_records = []     # finished spans, in the order they ended
_ids = itertools.count(1)
_requests = itertools.count(1)
_wrappers = None


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def enabled():
    return _on


@contextlib.contextmanager
def tracing():
    """Tracing on inside the block, as it was after it."""
    global _on
    was, _on = _on, True
    try:
        yield
    finally:
        _on = was


def counters():
    """{counter: value} now: host_syncs, nms_rounds and each hand-kernel
    wrapper's launches under the wrapper's name."""
    global _wrappers
    if _wrappers is None:
        # imported here: the ops modules import this one
        from mv3d_tf_tpu_torch.ops import (bev_cuda, conv_s8_cuda, nms_cuda,
                                           roi_pool_cuda, stem_s2d_cuda,
                                           vgg_stem_cuda)
        _wrappers = (bev_cuda.bev_place_cuda, conv_s8_cuda.conv2x2_s8_cuda,
                     conv_s8_cuda.conv3x3_s8_cuda,
                     conv_s8_cuda.matmul_s8_cuda, nms_cuda.nms_greedy_cuda,
                     roi_pool_cuda.roi_pool_bwd_cuda,
                     roi_pool_cuda.roi_pool_cuda,
                     stem_s2d_cuda.stem_s2d_fused_cuda,
                     vgg_stem_cuda.vgg_stem_cuda)
    out = {"host_syncs": host_syncs, "nms_rounds": nms_rounds}
    for fn in _wrappers:
        out[fn.__name__] = fn.launches
    return out


class Span:
    """One span: ``name``, ``id``, ``parent`` (the enclosing span's id, or
    None for a root), ``request``, ``start_ns`` and ``end_ns``
    (perf_counter_ns), and ``counts``, each counter's change over it."""

    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns",
                 "counts", "_before", "_rf")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        if _open:
            self.parent, self.request = _open[-1].id, _open[-1].request
        else:
            self.parent, self.request = None, next(_requests)
        self.id = next(_ids)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self._before = counters()
        _open.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _open.pop()
        after = counters()
        self.counts = {k: after[k] - v for k, v in self._before.items()}
        self._rf.__exit__(*exc)
        self._before = self._rf = None
        _records.append(self)
        return False


def span(name):
    """A span named ``name`` when tracing is on; the shared null context
    when it is off."""
    if not _on:
        return _NULL
    return Span(name)


def records():
    """The finished spans, in the order they ended."""
    return list(_records)


def clear():
    """Drops the finished spans."""
    _records.clear()
