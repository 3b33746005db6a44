"""Captured chunk programs: the counterpart of the JAX package's compiled
chunk steps (``_fit_chunk``, ``_reconstruct_chunk``, the mean refit
``fit_moffat_cube_packed``) and of its per-process ``_WARM_MEMO``.

The JAX package runs each chunk step as ONE compiled dispatch, because
the per-chunk op count, not the FLOPs, sets the steady state.  On the
card the counterpart of a jitted fixed-shape step is a CUDA graph.  A
program is keyed as the JAX package keys its executables: ``(kind,
group config, chunk size, nl, dtype, h, wind_speed, npsflin,
fit_dtype)`` for ``kind`` "fit" or "recon", ``("mean", shape, dtype,
fit_dtype)`` for the mean refit, each plus the device.  :func:`run`
dispatches a step:

* on the CPU, or with ``graphs=False``, the step runs eagerly;
* on a CUDA device a key's first dispatch runs eagerly, on the device's
  capture stream: that run builds the kernels, makes the cuFFT plans and
  gives cuBLAS its workspace on that stream, so that nothing is made
  during a capture, and its outputs are that chunk's results;
* its second dispatch captures the step as a CUDA graph on the same
  stream and replays it, and every later dispatch replays.

The step's tensor arguments (a chunk's telemetry, ``n_valid``, the
wavelengths and the crop sizes, or the mean PSF) are the graph's static
inputs, copied in before each replay, so the wavelengths are values as
they are traced values in JAX, never baked into a graph.  The outputs
are cloned after each replay: the next replay of the same graph (the
next chunk of the group) overwrites them.  Every program on a device
allocates from one memory pool; replays run in series on the caller's
stream, and a program's intermediates are written before they are read,
so programs may replay in any order.  A graph holds the addresses of the
device constants it read (``utils/device.py:host_const``), so
``clear_device_consts`` drops the programs too (:func:`clear`).

A capture or a replay that fails raises; nothing gives way to the eager
step.  Kernel launch counters (``ops/_build.py``) grow in the Python
wrappers, which a replay never calls: a program records the counts its
capture made, takes them back (the capture launched nothing), and adds
them at each replay.

Each dispatch is a ``replay`` span (``utils/profiling.py``), with the
program's kind and, for a chunk program, its rows: on the card the copy
in, the graph launch and the clone out of a replay (or the eager first
dispatch and the capture); on the CPU the step itself.
"""

import time

import torch

from ..ops import _build
from ..utils import profiling

#: {key: None once dispatched eagerly, then the captured Program}
_PROGRAMS = {}
#: {device: graph memory pool shared by the device's programs}
_POOLS = {}
#: {device: stream of the eager first dispatches and of the captures}
_STREAMS = {}


class Program:
    """One captured step: the graph, its static inputs and outputs, the
    kernel launches one replay stands for, and what the capture cost."""

    def __init__(self, key, graph, inputs, outputs, launches, capture_s,
                 reserved):
        self.key = key
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.capture_s = capture_s
        #: ``torch.cuda.max_memory_reserved`` before and after the capture,
        #: and ``torch.cuda.memory_reserved`` after it [bytes]
        self.reserved = reserved
        self.replays = 0

    def __call__(self, args):
        for buf, x in zip(self.inputs, args):
            buf.copy_(x)
        self.graph.replay()
        _build.add_launch_counts(self.launches)
        self.replays += 1
        return tuple(o.clone() for o in self.outputs)


def _stream(dev):
    if dev not in _STREAMS:
        _STREAMS[dev] = torch.cuda.Stream(device=dev)
    return _STREAMS[dev]


def _eager(dev, fn, args):
    """``fn(*args)`` on the capture stream of ``dev``, ordered after the
    caller's stream and before its next work."""
    stream, caller = _stream(dev), torch.cuda.current_stream(dev)
    stream.wait_stream(caller)
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        out = fn(*args)
    caller.wait_stream(stream)
    return out


def _capture(key, dev, fn, args):
    inputs = tuple(x.clone() for x in args)
    if dev not in _POOLS:
        _POOLS[dev] = torch.cuda.graph_pool_handle()
    before = _build.launch_counts()
    reserved = [torch.cuda.max_memory_reserved(dev)]
    graph = torch.cuda.CUDAGraph()
    t0 = time.perf_counter()
    with torch.cuda.device(dev):
        with torch.cuda.graph(graph, pool=_POOLS[dev], stream=_stream(dev)):
            outputs = fn(*inputs)
    capture_s = time.perf_counter() - t0
    reserved += [torch.cuda.max_memory_reserved(dev),
                 torch.cuda.memory_reserved(dev)]
    after = _build.launch_counts()
    launches = {k: after[k] - before[k] for k in after}
    _build.add_launch_counts({k: -n for k, n in launches.items()})
    return Program(key, graph, inputs, tuple(outputs), launches, capture_s,
                   tuple(reserved))


def run(key, fn, args, graphs=True):
    """``fn(*args)`` (a tuple of tensors) as the program ``key`` on the
    arguments' device: eagerly on the CPU, with ``graphs=False``, or at
    the key's first dispatch; captured at its second and replayed from
    then on.  ``fn`` returns a tuple of tensors."""
    rows = {} if key[0] == "mean" else {"rows": int(args[0].shape[0])}
    with profiling.span("replay", kind=key[0], **rows):
        dev = args[0].device
        if not graphs or dev.type != "cuda":
            return fn(*args)
        key = key + (str(dev),)
        if key not in _PROGRAMS:
            _PROGRAMS[key] = None
            return _eager(dev, fn, args)
        prog = _PROGRAMS[key]
        if prog is None:
            prog = _PROGRAMS[key] = _capture(key, dev, fn, args)
        return prog(args)


def programs():
    """The captured programs of this process, in the order of their keys'
    first dispatch."""
    return [p for p in _PROGRAMS.values() if p is not None]


def clear():
    """Drop every program and its memory pool."""
    _PROGRAMS.clear()
    _POOLS.clear()
