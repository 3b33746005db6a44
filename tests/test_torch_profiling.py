"""The port's tracing (``utils/profiling.py``): the spans and counters of
``process_batch`` on the CPU, and on the card the stage markers that the
chunk programs' CUDA graphs replay.

CPU: a night under ``torch.profiler`` records one ``batch`` span with its
``plan``, ``push``, ``replay`` and ``pull`` children under one batch id,
and the counters' growth; a night without a profiler records no span but
counts; a tripped window guard records a ``redo`` span around the nested
``batch``; the buffer keeps its bound; a marker does nothing on the CPU.

Card (marked ``cuda``, skipped here): a replayed program shows its stage
markers in stage order at each replay; the markers leave the launch
counters alone; no device event of a traced night carries a span's name.
On a GPU machine:

    python -m pytest --noconftest tests/test_torch_profiling.py -m cuda

(this file imports no JAX)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from muse_psfr_tpu_torch.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG  # noqa: E402
from muse_psfr_tpu_torch.ops import _build  # noqa: E402
from muse_psfr_tpu_torch.parallel import batch as tbatch  # noqa: E402
from muse_psfr_tpu_torch.utils import profiling  # noqa: E402

#: every kind of group at a small grid: reduced window, full window, exact
#: transform (``tests/test_torch_batch.py``); at chunk 6 the reduced-window
#: group's two rows run as a tail chunk of 3, one row of it padding
SMALL = GalacsiConfig(dim=512, dim_pup=16, dimpsf=12, lambda_chunk=2)
LB4 = np.linspace(500.0, 900.0, 4)
MIXED = (np.array([0.9, 1.4, 0.5, 1.0, 1.3, 0.6]),
         np.array([0.85, 0.8, 0.85, 0.7, 0.5, 0.3]),
         np.array([25.0, 25.0, 25.0, 18.0, 2.0, 12.0]), np.ones((6, 4)))
#: row 2 outgrows a pinned 128-px window at 930 nm: its chunk is redone
GUARD_CFG = GalacsiConfig(dim=512, dim_pup=24, dimpsf=12, otf_support=128)
TRIP = (np.array([1.0, 1.3, 0.2, 1.1]), np.array([0.7, 0.5, 0.01, 0.6]),
        np.array([25.0, 18.0, 30.0, 22.0]), np.ones((4, 4)))
NAMES = {"batch", "plan", "push", "replay", "pull", "redo"}


def _tiny_night(rows=6):
    rng = np.random.default_rng(0)
    return (rng.uniform(0.6, 1.6, rows), rng.uniform(0.3, 0.9, rows),
            rng.uniform(9.0, 29.0, rows), np.ones((rows, 4)))


def _traced(fn, activities=(ProfilerActivity.CPU,)):
    """``fn()`` under ``torch.profiler``; returns (result, spans, prof)."""
    profiling.reset()
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, profiling.spans(), prof


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_a_traced_night_records_one_batch_and_its_children():
    plan = tbatch.plan_batch(*MIXED, LB4, cfg=SMALL, chunk=6, device="cpu")
    sizes = [s for g in plan.groups for s in g.sizes]
    tail = [g for g in plan.groups if g.cfg.otf_support]
    assert len(tail) == 1 and tail[0].sizes == (3,) and tail[0].n_pad == 1
    _, spans, _ = _traced(lambda: tbatch.process_batch(
        *MIXED, LB4, cfg=SMALL, chunk=6, device="cpu"))
    top = [s for s in spans if s.parent is None]
    assert [s.name for s in top] == ["batch"]
    night = top[0]
    assert {s.batch for s in spans} == {night.id}
    kids = _children(spans, night)
    assert len(kids) == len(spans) - 1
    assert [s.name for s in kids] == (["plan", "push"]
                                      + ["replay"] * (len(sizes) + 1)
                                      + ["pull"])
    for s in kids:
        assert night.t0 <= s.t0 <= s.t1 <= night.t1
    assert [(s.attrs["kind"], s.attrs.get("rows")) for s in kids
            if s.name == "replay"] == [("fit", n) for n in sizes] + [
        ("mean", None)]
    # the plan was made above: the night's own plan_batch is a memo hit;
    # its chunks computed 15 rows for 6: the full groups' padding to 6 and
    # the tail chunk's one row
    assert sum(sizes) == 15 and night.attrs["rows"] == 6
    assert night.attrs["counts"] == {
        "rows": 6, "rows_computed": 15, "guard_trips": 0, "redo_rows": 0,
        "plan_memo_hits": 1, "plan_memo_misses": 0, "plan_psd_rows": 0}


def test_no_span_is_recorded_without_a_profiler():
    profiling.reset()
    tbatch.process_batch(*_tiny_night(), [750.0, 800.0], cfg=TINY_CONFIG,
                         chunk=4, device="cpu")
    assert not torch._C._autograd._profiler_enabled()
    assert profiling.spans() == []
    # the counters are always on: two padded chunks of 4 for 6 rows
    got = profiling.counters()
    assert got["rows"] == 6 and got["rows_computed"] == 8
    assert got["plan_memo_misses"] + got["plan_memo_hits"] == 1


def test_a_tripped_guard_records_a_redo_around_the_nested_batch(caplog):
    _, spans, _ = _traced(lambda: tbatch.process_batch(
        *TRIP, [930.0], cfg=GUARD_CFG, chunk=1, device="cpu"))
    assert "guard tripped" in caplog.text
    night = next(s for s in spans if s.parent is None)
    assert {s.batch for s in spans} == {night.id}
    kids = _children(spans, night)
    assert [s.name for s in kids] == (["plan", "push"] + ["replay"] * 5
                                      + ["pull", "redo", "pull"])
    redo = kids[-2]
    assert redo.attrs["rows"] == 1
    nested = _children(spans, redo)
    assert [s.name for s in nested] == ["batch", "replay"]
    assert nested[0].attrs["rows"] == 1
    assert [s.name for s in _children(spans, nested[0])] == [
        "plan", "push", "replay"]
    # only row 2's chunk trips; the nested batch delivers nothing itself
    assert nested[0].attrs["counts"]["rows"] == 0
    assert nested[0].attrs["counts"]["rows_computed"] == 1
    counts = night.attrs["counts"]
    assert (counts["guard_trips"], counts["redo_rows"]) == (1, 1)
    assert (counts["rows"], counts["rows_computed"]) == (4, 5)
    assert profiling.counters()["guard_trips"] == 1


def test_the_span_buffer_keeps_its_bound():
    def many():
        for _ in range(profiling.MAX_SPANS + 10):
            with profiling.span("tick"):
                pass

    _, spans, _ = _traced(many)
    assert len(spans) == profiling.MAX_SPANS
    ids = [s.id for s in spans]
    assert ids == list(range(ids[0], ids[0] + profiling.MAX_SPANS))
    # the ten oldest went first
    assert ids[-1] - ids[0] == profiling.MAX_SPANS - 1
    assert all(s.parent is None and s.batch is None for s in spans)


def test_a_marker_does_nothing_on_the_cpu(monkeypatch):
    def no_library():
        raise AssertionError("a CPU marker built the kernel library")

    monkeypatch.setattr(_build, "library", no_library)
    before = _build.launch_counts()
    for name in profiling.STAGES:
        profiling.stage(name, torch.device("cpu"))
    assert _build.launch_counts() == before


# ---- on the card ----------------------------------------------------------

@pytest.fixture(scope="module")
def card_night():
    """A TINY full-window night on the card: two warm-up nights (the
    programs' eager dispatch, then their capture), then two traced nights
    of replays.  Returns (traced spans, the profiler's events)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from muse_psfr_tpu_torch.parallel import programs
    programs.clear()

    def night():
        return tbatch.process_batch(*_tiny_night(4), [750.0, 800.0],
                                    cfg=TINY_CONFIG, chunk=4,
                                    device="cuda", _force_full=True)

    night()
    night()
    torch.cuda.synchronize()
    _, spans, prof = _traced(lambda: (night(), night()),
                             (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    return spans, prof.events()


def _device_events(events):
    from torch.autograd import DeviceType
    return sorted((e for e in events if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


@pytest.mark.cuda
def test_replayed_programs_show_their_markers_in_stage_order(card_night):
    _, events = card_night
    marks = [e.name for e in _device_events(events)
             if "psfr_stage<" in e.name]
    stages = [m.split("stage::")[1].split(">")[0] for m in marks]
    one = ["psd", "otf", "conv", "fit", "reduce", "end", "fit", "end"]
    assert stages == one * 2, stages


@pytest.mark.cuda
def test_markers_leave_the_launch_counts_alone():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    _build.library()
    _build.reset_launch_counts()
    for name in profiling.STAGES:
        profiling.stage(name, dev)
    torch.cuda.synchronize()
    assert set(_build.launch_counts().values()) == {0}


@pytest.mark.cuda
def test_no_device_event_carries_a_span_name(card_night):
    spans, events = card_night
    assert {s.name for s in spans} >= {"batch", "plan", "push", "replay",
                                       "pull"}
    assert sum(s.name == "batch" and s.parent is None for s in spans) == 2
    dev = _device_events(events)
    assert dev and not [e.name for e in dev if e.name in NAMES]
