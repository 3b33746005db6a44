"""The harness's batch loop, output check and metric readers, on the CPU at
the tests' ``TINY_CONFIG`` sizes through ``harness.run_cell`` (the entry
itself refuses the CPU), with the program sound and broken underneath."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import harness, tracing  # noqa: E402

CELL = "wfm1-night100"
SEED = 2 ** 31 + 4242


def tiny_cell():
    from muse_psfr_tpu_torch.config import TINY_CONFIG
    cell = harness.load_cell(harness.manifest(ROOT), CELL)
    prog = {f.name: getattr(TINY_CONFIG, f.name)
            for f in dataclasses.fields(TINY_CONFIG)}
    cell["config"] = dict(cell["config"], program=prog)
    cell["mix"] = dict(cell["mix"], rows=6, pool=2, trace_batches=2)
    cell["cell"] = dict(cell["cell"], chunk=4)
    return cell


class HalfMean(harness.Program):
    """Half of the batch left out of the mean, the mean taken over the
    rest."""

    def process(self, rows, *a):
        fit, _, _ = super().process(rows, *a)
        half = tuple(x[: len(rows[0]) // 2] for x in rows)
        _, mean, fit_mean = super().process(half, *a)
        return fit, mean, fit_mean


class Altered(harness.Program):
    """One answer altered where it is produced: row 0 gets row 1's fits."""

    def process(self, rows, *a):
        fit, mean, fit_mean = super().process(rows, *a)
        fit = fit.copy()
        fit[0] = fit[1]
        return fit, mean, fit_mean


class Stale(harness.Program):
    """A step that hands back its state unchanged: every batch after the
    first gets the first batch's answer."""

    first = None

    def process(self, rows, *a):
        out = super().process(rows, *a)
        if self.first is None:
            self.first = out
        return self.first


@pytest.fixture(scope="module")
def sound():
    cell = tiny_cell()
    return harness.run_cell(cell, SEED, 1.0, False, device="cpu")


def test_a_sound_run_is_correct_and_reports_its_metrics(sound):
    assert list(sound) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
    assert sound["correct"] is True
    assert sound["failed"] == 0 and sound["attempted"] >= 1
    assert set(sound["metrics"]) == {"rows_per_s", "night_p95_ms",
                                     "peak_mem_gib", "setup_s"}
    assert all(m["value"] >= 0 for m in sound["metrics"].values())
    checks = sound["checks"]
    assert set(checks) == {"mean_psf_rel", "fwhm_rel", "beta_rel",
                           "mean_fwhm_rel", "mean_beta_rel"}
    for c in checks.values():
        assert c["value"] <= c["limit"]
    json.dumps(sound)


@pytest.mark.parametrize("broken", [HalfMean, Altered, Stale],
                         ids=["half_mean", "altered_answer", "stale_state"])
def test_a_broken_program_is_not_correct(broken, sound):
    cell = tiny_cell()
    prog = broken(cell["config"]["program"], "cpu")
    # enough batches that the stale answer is the one drawn for the check
    res = harness.run_cell(cell, SEED, 1.0, False, device="cpu",
                           program=prog)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_the_traced_run_reads_its_per_layer_metrics():
    cell = tiny_cell()
    res = harness.run_cell(cell, SEED + 1, 0.5, True, device="cpu")
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert res["correct"] is True
    # on the CPU no device kernel is traced: those readers read nothing
    assert set(res["metrics"]) == {"plan_ms.night"}
    assert res["metrics"]["plan_ms.night"]["value"] > 0
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _record(kernels, rows=100, window_s=1.0):
    classes = harness.load_json(os.path.join(ROOT, "bench_port", "metrics",
                                             "kernel_classes.json"))
    busy = tracing.merged([(a, b) for _, a, b in kernels])
    rec = {"classes": classes, "kernels": kernels, "rows": rows,
           "window_s": window_s, "plans": [], "npsflin": 1,
           "busy_s": sum(b - a for a, b in busy) * 1e-6,
           "cpu_ops": [("aten::copy_", 0.0, 10.0), ("outer", 0.0, 1e6)],
           "plan_ms": [300.0, 500.0], "host_samples": []}
    rec["breakdown"] = tracing.breakdown(rec, busy)
    return rec


def test_readers_on_a_known_record():
    ks = [("void (anonymous namespace)::fused_exp_zoom_wg_kernel<3, true>",
           0.0, 5000.0),
          ("(anonymous namespace)::split_bf16(float const*)", 5000.0, 5100.0),
          ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x32x8", 6000.0,
           8000.0),
          ("void regular_fft<64u, EPT<8u>>", 8000.0, 8500.0),
          ("void at::native::vectorized_elementwise_kernel<4, Mul>", 8500.0,
           20000.0),
          ("Memcpy DtoD (Device -> Device)", 20000.0, 20100.0)]
    rec = _record(ks)
    read = lambda n: harness.reader(n)(rec)  # noqa: E731
    assert read("small_ops_us_per_row") == pytest.approx(11500.0 / 100)
    assert read("library_us_per_row") == pytest.approx(2500.0 / 100)
    assert read("device_idle_pct") == pytest.approx(
        100 * (1 - (20100.0 - 900.0) * 1e-6))
    assert read("plan_ms.night") == read("plan_ms.campaign") == 400.0
    assert read("zoom_roofline_pct") is None          # no plan recorded
    gaps = rec["breakdown"]["idle_gaps"]
    assert gaps[0][0] == "host: outer" and gaps[0][1] == pytest.approx(
        (1e6 - 20100.0) * 1e-6)
    assert rec["breakdown"]["device_ops"][0][1] == pytest.approx(0.0115)


def test_readers_read_nothing_without_a_trace():
    rec = _record([])
    for name in ("small_ops_us_per_row", "library_us_per_row",
                 "device_idle_pct", "zoom_roofline_pct"):
        assert harness.reader(name)(rec) is None


def test_zoom_launches_of_the_bench_night():
    """The zoom launches that the roofline counts for the 100-row night at
    chunk 50 (``tests/data/golden_plan_night100.json``): 57 rows on S=256
    with 14 blue wavelengths on S=128 (chunk 50 and a 12-row tail), 43 on
    the full window (one chunk of 50)."""
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.parallel.batch import plan_batch
    from muse_psfr_tpu_torch.utils.telemetry import night_rows
    zr = harness.reader("zoom_roofline_pct").__globals__
    plan = plan_batch(*night_rows(100), np.linspace(490, 930, 35),
                      npsflin=1, cfg=GalacsiConfig(), chunk=50,
                      device="cuda")
    got = sorted(zr["launches"](plan, 1))
    assert got == sorted([
        (50, 1, 256, 256, 14, 160, "high"), (50, 1, 512, 384, 21, 160,
                                             "high"),
        (12, 1, 256, 256, 14, 160, "high"), (12, 1, 512, 384, 21, 160,
                                             "high"),
        (50, 1, 1280, 768, 35, 160, "high")])
    assert harness.has_tail(plan)                     # the 12-row tail
    # the full-window launch's bound, as chip_smoke's K1 row has it
    bound, by = zr["_roof"].roofline(**zr["_roof"].zoom_work(
        50, 1, 1280, 768, 35, 160, "high"))
    assert bound == pytest.approx(1.6699, abs=1e-4) and by == "operations"


def test_the_check_takes_a_batch_with_a_tail_chunk():
    from bench_port import check
    win = {"outputs": dict.fromkeys(range(40))}
    mix = {"check_batches": 3}
    for seed in range(20):
        got = check.check_batches(win, mix, seed, tail=[37])
        assert 37 in got and len(set(got)) == 3
    # a draw that already holds a tail batch, or no tail batch, stands
    drawn = check.check_batches(win, mix, 5)
    assert check.check_batches(win, mix, 5, tail=drawn[:1]) == drawn
    assert check.check_batches(win, mix, 5, tail=[99]) == drawn


def _entry(cwd, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "bench_port", "run.py"),
         "--workload", CELL, "--seed", "7", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env or {})))


def test_the_entry_refuses_a_machine_without_a_card():
    out = _entry(ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench_port"),
                    tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _entry(str(tmp_path), env={"PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout == ""
