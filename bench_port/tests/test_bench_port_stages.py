"""The readers of the program's stage markers, spans and counters
(``metrics/_stages.py``) on a known record: two traced batches, each with
the markers of a chunk program and of the mean refit, kernels between
them, copies outside them and the program's spans; nothing read without
markers, spans or a device trace.  Also the readings of
``tools/trace_stages.py`` on the same record: the spans' host time, their
clock offset from the ``bench_port.batch`` ranges, and the device's idle
time by host span."""

import importlib.util
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import harness, tracing  # noqa: E402
from bench_port.metrics import _stages  # noqa: E402
from muse_psfr_tpu_torch.utils.profiling import Span  # noqa: E402

NEW = ("psd_us_per_row", "otf_us_per_row", "conv_us_per_row",
       "fit_us_per_row", "row_yield_pct")
#: the program's clock at the first batch's range [ns]
T0 = 10 ** 12
#: a batch's stages [us], as the kernels below give them
ONE = {"psd": 11.0, "otf": 101.0, "conv": 21.0, "fit": 132.0,
       "reduce": 6.0, "outside": 32.0}


def _tool():
    path = os.path.join(ROOT, "tools", "trace_stages.py")
    spec = importlib.util.spec_from_file_location("trace_stages", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


trace_stages = _tool()


def _mark(stage):
    return f"void psfr_stage<stage::{stage}>()"


def _batch(r):
    """One batch's device events [us] from its range's start ``r``."""
    ev = [("Memcpy HtoD (Pageable -> Device)", 100, 110),
          (_mark("psd"), 200, 201),
          ("vectorized_elementwise_kernel", 201, 211),
          (_mark("otf"), 211, 212),
          ("void (anonymous namespace)::fused_exp_zoom_wg_kernel<3, true>",
           212, 312),
          (_mark("conv"), 312, 313), ("void regular_fft<64u>", 313, 333),
          (_mark("fit"), 333, 334), ("reduce_kernel<512, 1>", 334, 434),
          (_mark("reduce"), 434, 435), ("sm80_xmma_gemm_f32f32", 435, 440),
          (_mark("end"), 440, 441), ("direct_copy_kernel_cuda", 441, 451),
          (_mark("fit"), 500, 501),
          ("vectorized_elementwise_kernel", 501, 531),
          (_mark("end"), 531, 532),
          ("Memcpy DtoH (Device -> Pageable)", 900, 910)]
    return [(n, float(r + a), float(r + b)) for n, a, b in ev]


def _spans(k, r, skew_us, rows_computed):
    """Batch ``k``'s spans, its range at ``r`` [us] on the profiler's
    clock, its program clock ``skew_us`` later."""
    base = T0 + (r + skew_us) * 1000
    sid = 10 * k + 1

    def at(name, i, a, b, **attrs):
        return Span(name, sid, sid + i, sid if i else None,
                    base + a * 1000, base + b * 1000, attrs)

    return [at("plan", 1, 5, 95), at("push", 2, 95, 115),
            at("replay", 3, 150, 460, kind="fit", rows=50),
            at("replay", 4, 480, 540, kind="mean"),
            at("pull", 5, 560, 990),
            at("batch", 0, 0, 1000, rows=100,
               counts={"rows": 100, "rows_computed": rows_computed,
                       "guard_trips": 0, "redo_rows": 0,
                       "plan_memo_hits": 1, "plan_memo_misses": 0})]


def _record(kernels, cpu_ops):
    classes = harness.load_json(os.path.join(ROOT, "bench_port", "metrics",
                                             "kernel_classes.json"))
    busy = tracing.merged([(a, b) for _, a, b in kernels])
    return {"classes": classes, "kernels": kernels, "rows": 200,
            "window_s": 3e-3, "plans": [], "npsflin": 1,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "cpu_ops": cpu_ops, "plan_ms": [], "host_samples": []}


def _traced(skew_us=0.0):
    """Two traced batches at 0 and 2000 us, the second's program clock
    ``skew_us`` later than the first's; the record and the spans."""
    kernels = _batch(0) + _batch(2000)
    cpu_ops = [(tracing.SPAN, 0.0, 1000.0), ("aten::mul", 5.0, 6.0),
               (tracing.SPAN, 2000.0, 3000.0)]
    spans = _spans(0, 0, 0.0, 112) + _spans(1, 2000, skew_us, 125)
    return _record(kernels, cpu_ops), spans


@pytest.fixture
def traced(monkeypatch):
    rec, spans = _traced()
    monkeypatch.setattr(_stages, "program_spans", lambda: spans)
    return rec


def test_each_kernel_goes_to_the_stage_of_its_marker(traced):
    got = _stages.stage_us(traced)
    assert got == {k: 2 * v for k, v in ONE.items()}
    # with reduce and outside the stages account for the busy time
    assert sum(got.values()) == pytest.approx(traced["busy_s"] * 1e6)
    read = lambda n: harness.reader(n)(traced)  # noqa: E731
    assert read("psd_us_per_row") == pytest.approx(22.0 / 200)
    assert read("otf_us_per_row") == pytest.approx(202.0 / 200)
    assert read("conv_us_per_row") == pytest.approx(42.0 / 200)
    # the chunk program's fit and the mean refit's
    assert read("fit_us_per_row") == pytest.approx(264.0 / 200)


def test_span_readers_take_the_traced_batches_spans(traced):
    assert harness.reader("row_yield_pct")(traced) == pytest.approx(
        100.0 * 200 / 237)
    # the tool's host time [ms] of each span, a traced batch
    got = trace_stages.span_ms(traced, _stages.program_spans())
    assert got == pytest.approx({"plan": 0.090, "push": 0.020,
                                 "replay": 0.370, "pull": 0.430,
                                 "batch": 1.0})


def test_an_earlier_batch_span_is_not_a_traced_one(monkeypatch):
    rec, spans = _traced()
    old = Span("batch", 1, 1, None, T0 - 10 ** 9, T0 - 10 ** 8,
               {"rows": 100, "counts": {"rows": 0, "rows_computed": 100}})
    monkeypatch.setattr(_stages, "program_spans", lambda: [old] + spans)
    assert [b.id for b, _ in _stages.batches(rec)] == [1, 11]
    assert harness.reader("row_yield_pct")(rec) == pytest.approx(
        100.0 * 200 / 237)


def test_the_clock_offset_and_its_residual(monkeypatch):
    rec, spans = _traced(skew_us=4.0)
    off, residual = trace_stages.clock_offset(rec, spans)
    assert off == pytest.approx(-T0 * 1e-3 - 2.0)
    assert residual == pytest.approx(2.0)


def test_idle_time_by_the_host_span_open_over_it():
    rec, spans = _traced()
    got = trace_stages.idle_by_span(rec, spans)
    # a batch's gaps: [0, 100] plan 90, push 5; [110, 200] push 5, replay
    # 50; [451, 500] replay 9 + 20; [532, 900] replay 8, pull 340; [910,
    # 1000] pull 80; between the batches' ranges nothing is counted
    assert got == pytest.approx({"plan": 180.0, "push": 20.0,
                                 "replay": 174.0, "pull": 840.0,
                                 "none": 180.0})
    assert sum(got.values()) == pytest.approx(2000.0 - 2 * 303.0)


def test_nothing_is_read_without_markers_spans_or_a_device_trace(
        monkeypatch):
    rec, spans = _traced()
    bare = dict(rec, kernels=[k for k in rec["kernels"]
                              if "psfr_stage" not in k[0]])
    monkeypatch.setattr(_stages, "program_spans", lambda: spans)
    for name in NEW[:4]:
        assert harness.reader(name)(bare) is None
    # a program older than the spans records none
    monkeypatch.setattr(_stages, "program_spans", lambda: [])
    for name in NEW[4:]:
        assert harness.reader(name)(rec) is None
    assert trace_stages.clock_offset(rec, []) is None
    assert trace_stages.idle_by_span(rec, []) is None
    assert trace_stages.span_ms(rec, []) is None
    # a run with no device trace (the CPU) reads none of them
    monkeypatch.setattr(_stages, "program_spans", lambda: spans)
    cpu = dict(rec, kernels=[], busy_s=0.0)
    for name in NEW:
        assert harness.reader(name)(cpu) is None


def test_the_program_has_spans_to_read():
    assert _stages.program_spans() == [] or all(
        isinstance(s, Span) for s in _stages.program_spans())
    man = harness.manifest(ROOT)
    cell = harness.load_cell(man, "wfm1-night100")
    assert set(NEW) <= {m["name"] for m in cell["per_layer"]}


def test_an_untraced_window_records_no_span():
    """A whole untraced run (TINY, CPU) leaves the program's span buffer
    empty: spans are kept only under the profiler."""
    import dataclasses
    from muse_psfr_tpu_torch.config import TINY_CONFIG
    from muse_psfr_tpu_torch.utils import profiling
    cell = harness.load_cell(harness.manifest(ROOT), "wfm1-night100")
    prog = {f.name: getattr(TINY_CONFIG, f.name)
            for f in dataclasses.fields(TINY_CONFIG)}
    cell["config"] = dict(cell["config"], program=prog)
    cell["mix"] = dict(cell["mix"], rows=6, pool=2, check_batches=1)
    cell["cell"] = dict(cell["cell"], chunk=4)
    profiling.reset()
    res = harness.run_cell(cell, 2 ** 31 + 99, 0.5, False, device="cpu")
    assert res["correct"] and res["attempted"] >= 1
    assert profiling.spans() == []
    assert profiling.counters()["rows"] >= 6 * res["attempted"]
