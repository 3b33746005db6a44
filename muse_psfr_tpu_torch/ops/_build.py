"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in ``muse_psfr_tpu_torch/csrc/*.cu`` with a plain C
interface.  :func:`library` compiles them on first use with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, links
the objects into one shared library under :data:`BUILD_DIR` (the
checkout's ``build/muse_psfr_tpu_torch/``, or the user's cache for an
installed package; named by a hash of the sources, their headers and the
flags, so an edit rebuilds) and loads
it with ``ctypes``.  Importing this module builds nothing: the CPU tests
import every module on machines without ``nvcc``.

Each kernel keeps a plain integer counter on its module (:data:`KERNELS`),
incremented by its wrapper right after a successful launch;
:func:`launch_counts` and :func:`reset_launch_counts` read and clear them
together, and :func:`add_launch_counts` adds the launches of a replayed
CUDA graph, whose kernels no wrapper sees (``parallel/programs.py``).
The stage markers of ``csrc/stage_mark.cu`` (:func:`mark_stage`) have no
counter: they are instrumentation, not work.
"""

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"


def build_dir() -> Path:
    """Where the kernels are built: ``<checkout>/build/muse_psfr_tpu_torch``
    when the package sits in a source checkout (its ``pyproject.toml``
    beside it), else the user's cache, ``$XDG_CACHE_HOME`` (default
    ``~/.cache``) ``/muse_psfr_tpu_torch/build``: an installed package
    never writes into ``site-packages``."""
    if (PACKAGE.parent / "pyproject.toml").is_file():
        return PACKAGE.parent / "build" / "muse_psfr_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "muse_psfr_tpu_torch" / "build"


BUILD_DIR = build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: {kernel: (module under ``muse_psfr_tpu_torch.ops``, its launch counter)}
KERNELS = {"zoom_dft": ("zoom_dft", "LAUNCHES"),
           "zoom_dft_rowsplit": ("zoom_dft", "ROWSPLIT_LAUNCHES"),
           "zoom_dft_disc": ("zoom_dft", "DISC_LAUNCHES"),
           "zoom_dft_tc": ("zoom_dft", "TC_LAUNCHES"),
           "zoom_dft_tc_rowsplit": ("zoom_dft", "TC_ROWSPLIT_LAUNCHES"),
           "zoom_dft_tc_disc": ("zoom_dft", "TC_DISC_LAUNCHES"),
           "zoom_dft_anchor": ("zoom_dft", "ANCHOR_LAUNCHES"),
           "zoom_dft_tc_anchor": ("zoom_dft", "TC_ANCHOR_LAUNCHES"),
           "conv_dft": ("conv_dft", "LAUNCHES"),
           "conv_dft_tc": ("conv_dft", "TC_LAUNCHES")}

_LOCK = threading.Lock()
_LIB = None
#: ptxas report (registers, shared memory, spills) of the loaded library's
#: build, kept beside it
BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # dphi, dl, A2's three bf16 parts, alpha, w, live, ws, u, 3 dphi
    # strides, B, ndir, n, ncols, nl, m2, n_pad, row_splits, exp2, and the
    # launch plan: warpgroups, stages, staged; stream
    "muse_fused_exp_zoom": [_P] * 10 + [ctypes.c_longlong] * 3 + [_I] * 12
    + [_P],
    # the same with A2's two bf16 parts (hi, lo)
    "muse_fused_exp_zoom_tc": [_P] * 9 + [ctypes.c_longlong] * 3 + [_I] * 12
    + [_P],
    # x, its parts p0, p1, p2 (or null), rows, n, n_pad, stream
    "muse_split_bf16": [_P] * 4 + [ctypes.c_longlong] + [_I] * 2 + [_P],
    # dphi, dl, A2's three bf16 parts, centre, astar, coef, u, 3 dphi
    # strides, B, ndir, n, ncols, nl, m2, n_pad, group, deg1, and the
    # launch plan: stages, staged; stream
    "muse_fused_exp_zoom_anchor": [_P] * 9 + [ctypes.c_longlong] * 3
    + [_I] * 11 + [_P],
    # the same with A2's two bf16 parts (hi, lo)
    "muse_fused_exp_zoom_anchor_tc": [_P] * 8 + [ctypes.c_longlong] * 3
    + [_I] * 11 + [_P],
    # planes, gtt_r, gtt_i, gi_r, gi_i, C, S, out, B, nl, n, L, off, stream
    "muse_fused_conv_chain": [_P] * 8 + [_I] * 5 + [_P],
    # the same with the persistent grid's blocks before the stream
    "muse_fused_conv_chain_tc": [_P] * 8 + [_I] * 6 + [_P],
    # stage id, stream
    "muse_stage_mark": [_I, _P],
}


def _nvcc() -> str:
    path = (os.environ.get("NVCC") or shutil.which("nvcc")
            or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "nvcc"))
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME): the "
                           "CUDA kernels build on first use")
    return path


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    """What the sources include from their own directory."""
    return sorted(CSRC.glob("*.cuh"))


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is not None:
            return _LIB
        srcs = sources()
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for p in srcs + headers():
            digest.update(p.name.encode() + p.read_bytes())
        so = BUILD_DIR / f"libmuse_psfr_kernels-{digest.hexdigest()[:16]}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tag = f"{so.stem}.{os.getpid()}"
            objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in srcs]
            procs = [subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(p)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for p, o in zip(srcs, objs)]
            logs = [proc.communicate()[0] for proc in procs]
            failed = [f"{p.name} ({proc.returncode}):\n{log}"
                      for p, proc, log in zip(srcs, procs, logs)
                      if proc.returncode]
            if failed:
                raise RuntimeError("nvcc failed: " + "\n".join(failed))
            tmp = so.with_name(f"{tag}.so.tmp")
            proc = subprocess.run(
                [_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            so.with_suffix(".log").write_text("".join(logs))
            os.replace(tmp, so)
            for o in objs:
                o.unlink()
        log = so.with_suffix(".log")
        BUILD_LOG = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        return lib


def check_launch(err: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def check_operands(name, device, operands, unit_stride_only=False):
    """Device, dtype, shape and contiguity of a kernel's inputs; with
    ``unit_stride_only`` a view whose last dimension has unit stride is
    enough (the kernel takes the other strides)."""
    if device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on CPU or CUDA, "
                         f"got {device}")
    for key, (t, shape) in operands.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if t.dtype != torch.float32:
            raise ValueError(
                f"{name}: the CUDA kernel takes float32, got {key} in "
                f"{t.dtype}; run float64 on the CPU, or switch the fused "
                "kernels off (cfg.use_fused_zoom / cfg.use_fused_conv)")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if unit_stride_only:
            if t.stride(-1) != 1:
                raise ValueError(f"{name}: {key} needs unit stride in its "
                                 "last dimension")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def mark_stage(stage_id: int, device):
    """Launch the empty marker kernel of stage ``stage_id`` on the current
    stream of ``device``; no launch counter counts it."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    check_launch(lib.muse_stage_mark(stage_id, stream), "muse_stage_mark")


def launch_counts() -> dict:
    """{kernel: launches since the last reset}."""
    return {k: getattr(importlib.import_module(f"{__package__}.{mod}"), attr)
            for k, (mod, attr) in KERNELS.items()}


def reset_launch_counts():
    for mod, attr in KERNELS.values():
        setattr(importlib.import_module(f"{__package__}.{mod}"), attr, 0)


def add_launch_counts(delta: dict):
    """Add ``delta`` {kernel: launches} to the counters."""
    for k, n in delta.items():
        if not n:
            continue
        mod, attr = KERNELS[k]
        m = importlib.import_module(f"{__package__}.{mod}")
        setattr(m, attr, getattr(m, attr) + n)
