"""Tracing (counterpart of `gsrt.utils.profiling`).

`TRACER`, the program's one `StageTimer`, holds the spans and counters
the port's layers open round their stages (`render.frame`,
`render.project`, `serve.sync`, `train.step`, ...). A span records only
while a `torch.profiler` session records, as under `torch_trace` below:
otherwise it costs one check of the profiler's flag and records
nothing. On, a span records

- its name, its parent (the innermost span open on its thread, or, on a
  thread with none open, such as autograd's backward thread, the
  innermost span open on the thread of the root) and its root item;
- a `torch.profiler.record_function` range of its name, so the
  profiler's trace shows it on the clock of the kernels and idle gaps;
- the host's milliseconds (`time.perf_counter`) and the device's, from
  two CUDA events on the current stream (the host's where CUDA is not
  initialised).

A span opened with `root=True` outside every other span is a root: one
item, a frame or a training step. It also counts `device_allocs`, the
caching allocator's new device allocations over it, read before its
profiler range opens and after it closes, so that the read stays out of
the item. `count` attaches an int or a 0-d tensor to the innermost open
span; a tensor is read only in `report()`, so a counter adds no host
synchronisation.

`span(name)` is a `with` block. Where a stage starts in one callback and
ends in a later one, `h = begin(name)` opens the span and `end(h)`
closes it, on the same thread; spans on one thread nest, so `end` closes
the innermost span open there. `begin` returns None while no profiler
records and `end(None)` does nothing, so a profiler that starts between
the two records nothing of the stage; one that stops between them still
gets the span closed and recorded, with its events and its host time,
and its range's end falls outside the profiler's trace.

`backward_stages()` splits an autograd backward into such spans.
`stages.mark(name, *tensors)` passes the tensors through an identity
node; autograd runs its backward once the gradients of all of them are
in, and there it closes the stage span it opened last and opens `name`
(None: it only closes). A traced training step marks its loss, image,
projection outputs, cloud and leaves (`models/trainer.py`); while no
profiler records, `backward_stages()` is None and no node is added.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def _device_allocs() -> int:
    return torch.cuda.memory_stats_as_nested_dict().get("num_device_alloc",
                                                        0)


class _Record:
    __slots__ = ("name", "parent", "root", "t0", "t1", "ev0", "ev1",
                 "allocs0", "counters")

    def __init__(self, name, parent, root):
        self.name, self.parent, self.root = name, parent, root
        self.t1 = self.ev0 = self.ev1 = self.allocs0 = None
        self.counters = {}


class _Span:
    __slots__ = ("timer", "name", "root", "rec", "stack", "fn")

    def __init__(self, timer, name, root):
        self.timer, self.name, self.root = timer, name, root

    def __enter__(self):
        tm = self.timer
        stack = tm._stack()
        with tm._lock:
            up = stack or tm._root_stack
            parent = up[-1] if up else None
            idx = len(tm._spans)
            if parent is not None:
                root = tm._spans[parent].root
            elif self.root:
                root, tm._root_stack = idx, stack
            else:
                root = None
            rec = _Record(self.name, parent, root)
            tm._spans.append(rec)
        stack.append(idx)
        self.rec, self.stack = rec, stack
        cuda = torch.cuda.is_initialized()
        if cuda and root == idx:
            rec.allocs0 = _device_allocs()
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        if cuda:
            rec.ev0 = torch.cuda.Event(enable_timing=True)
            rec.ev0.record()
        rec.t0 = time.perf_counter()

    def __exit__(self, *exc):
        rec = self.rec
        if rec.ev0 is not None:
            rec.ev1 = torch.cuda.Event(enable_timing=True)
            rec.ev1.record()
        rec.t1 = time.perf_counter()
        self.stack.pop()
        self.fn.__exit__(*exc)
        if rec.allocs0 is not None:
            rec.counters["device_allocs"] = _device_allocs() - rec.allocs0
        return False


class _StageMark(torch.autograd.Function):
    """Identity on its tensors. Autograd runs its backward once every
    output's gradient is in (a gradient never computed is passed on as
    None), and there it moves `stages` on to the stage `name`."""

    @staticmethod
    def forward(ctx, stages, name, *xs):
        ctx.stages, ctx.name = stages, name
        ctx.set_materialize_grads(False)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.stages.enter(ctx.name)
        return (None, None, *grads)


class BackwardStages:
    """The stage spans of one backward pass (`StageTimer.backward_stages`):
    at most one open at a time, on the thread that runs the backward."""

    def __init__(self, timer):
        self.timer, self.open = timer, None

    def mark(self, name, *tensors) -> tuple:
        """The tensors, through a node whose backward ends the open stage
        and opens `name` (None: none)."""
        return _StageMark.apply(self, name, *tensors)

    def enter(self, name) -> None:
        """End the open stage span, if any, and open one named `name`."""
        self.timer.end(self.open)
        self.open = None if name is None else self.timer.begin(name)


class StageTimer:
    """Spans and counters of named stages, recorded while a profiler
    records. `span(name)` is a context manager; `report()` reads what was
    recorded, `reset()` drops it."""

    def __init__(self):
        self._spans: list[_Record] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        self._root_stack: list[int] = []   # the stack of the open root

    def _stack(self) -> list[int]:
        s = getattr(self._local, "stack", None)
        if s is None:
            s = self._local.stack = []
        return s

    def span(self, name: str, root: bool = False):
        """A span named `name` round the `with` block; `root=True` makes
        it an item of its own where no span is open."""
        if not _profiling():
            return _OFF
        return _Span(self, name, root)

    def begin(self, name: str):
        """Open a span named `name` for `end` to close later on this
        thread; None while no profiler records."""
        if not _profiling():
            return None
        s = _Span(self, name, False)
        s.__enter__()
        return s

    def end(self, handle) -> None:
        """Close a span that `begin` opened (nothing for None)."""
        if handle is not None:
            handle.__exit__(None, None, None)

    def backward_stages(self):
        """A `BackwardStages` for one backward pass while a profiler
        records, else None."""
        return BackwardStages(self) if _profiling() else None

    def recording(self) -> bool:
        """Whether spans and counters record now: a caller whose counter
        needs work of its own (a reduction) asks first."""
        return _profiling()

    def count(self, **values) -> None:
        """Add each value (int or 0-d tensor) to the innermost open span's
        counter of its name; nothing while no profiler records."""
        if not _profiling():
            return
        up = self._stack() or self._root_stack
        if up:
            c = self._spans[up[-1]].counters
            for name, v in values.items():
                c[name] = c[name] + v if name in c else v

    def report(self) -> list[dict]:
        """Every span, in the order they opened: `name`, `parent` and
        `root` (indices into this list; None at the top and outside every
        root), `host_ms` and `device_ms` (None while it is open) and
        `counters` (name → int). Waits for the device once; the same
        records give the same report."""
        spans = list(self._spans)
        if any(r.ev1 is not None for r in spans):
            torch.cuda.synchronize()
        out = []
        for r in spans:
            host = None if r.t1 is None else (r.t1 - r.t0) * 1e3
            out.append(dict(
                name=r.name, parent=r.parent, root=r.root, host_ms=host,
                device_ms=r.ev0.elapsed_time(r.ev1) if r.ev1 is not None
                else host,
                counters={k: int(v) for k, v in r.counters.items()}))
        return out

    def reset(self) -> None:
        """Drop every record (spans still open are dropped too)."""
        with self._lock:
            self._spans = []
            self._root_stack = []
        self._local = threading.local()


TRACER = StageTimer()


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """torch.profiler trace of the block, written to
    `log_dir/trace.json` (open in Perfetto or chrome://tracing). The
    program's spans record while it runs (`TRACER.report()`)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
