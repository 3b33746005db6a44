"""The benchmark's manifest (``BENCHMARK.json``) and the files it names."""

import dataclasses
import json
import os
import re
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402
from bench_port.reference import oracle_numpy as onp  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


@pytest.fixture(scope="module")
def man():
    return harness.manifest(ROOT)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits(man):
    assert set(man) == KEYS
    assert man["command"] == ["python3", "bench_port/run.py"]
    assert man["paths"] == ["bench_port"]
    assert all(PATH.match(p) for p in man["paths"])
    assert isinstance(man["run_seconds"], int)
    assert 1 <= man["run_seconds"] <= 51
    n = len(man["workloads"])
    assert (2 + 14 * 24) * (man["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= n <= 24 and 1 <= len(man["configs"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16
    assert 1 <= len(man["per_layer"]) <= 128
    assert len(json.dumps(man)) <= 64 * 1024


@pytest.mark.parametrize("kind,keys", [
    ("configs", CONFIG_KEYS), ("workloads", WORKLOAD_KEYS),
    ("end_to_end", E2E_KEYS), ("per_layer", LAYER_KEYS)])
def test_entries_have_exactly_their_keys(man, kind, keys):
    for e in man[kind]:
        extra = set(e) - keys
        assert set(e) >= keys
        assert extra <= ({"workloads"} if kind in ("end_to_end", "per_layer")
                         else set()), (kind, e["name"], extra)


def test_names_units_and_text(man):
    names = [e["name"] for kind in ("configs", "workloads", "end_to_end",
                                    "per_layer") for e in man[kind]]
    assert all(NAME.match(n) for n in names)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in man[kind]]
        assert len(ns) == len(set(ns)), kind
    for w in man["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
    for c in man["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert all(_line(w) for w in man["command"]) and len(man["command"]) <= 32


def test_every_cell_finds_its_files(man):
    for w in man["workloads"]:
        cell = harness.load_cell(man, w["name"])
        assert cell["config"]["name"] == w["config"]
        assert int(cell["cell"]["chunk"]) > 0
        assert set(cell["cell"]["limits"]) == {
            "mean_psf_rel", "fwhm_rel", "beta_rel", "mean_fwhm_rel",
            "mean_beta_rel"}
        for m in cell["per_layer"]:
            assert callable(harness.reader(m["name"]))


def test_each_cell_reports_what_its_metrics_move(man):
    by_cell = {w["name"]: harness.cell_metrics(man, w["name"])
               for w in man["workloads"]}
    for w, (e2e, per) in by_cell.items():
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2, w
        assert per, w
    for m in man["per_layer"]:
        for w in m.get("workloads", by_cell):
            assert w in by_cell, (m["name"], w)
            assert m["moves"] in {x["name"] for x in by_cell[w][0]}, \
                (m["name"], w)
    for m in man["end_to_end"]:
        for w in m.get("workloads", ()):
            assert w in by_cell


def test_each_configuration_has_a_cell_and_its_file(man):
    used = {w["config"] for w in man["workloads"]}
    files = set()
    for c in man["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("bench_port/")
        assert c["file"] not in files
        files.add(c["file"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def test_configurations_are_the_published_system():
    """The program runs the reference's GALACSI constants, and the
    configuration files state every field of the program's config."""
    from muse_psfr_tpu_torch.config import GalacsiConfig
    fields = {f.name for f in dataclasses.fields(GalacsiConfig)}
    for name in ("muse-wfm-1dir", "muse-wfm-9dir"):
        conf = harness.load_json(os.path.join(ROOT, "bench_port", "configs",
                                              name + ".json"))
        p = conf["program"]
        assert set(p) == fields
        cfg = GalacsiConfig(**p)
        assert cfg == GalacsiConfig()
        assert (p["dpup"], p["occ"], p["alt_dm"], p["lambda_ref"], p["nact"],
                p["fsamp"], p["delay_ms"], p["sep_lgs"], p["noise_lgs2"],
                p["wind_speed"], p["dim_pup"]) == (
            onp.DPUP, onp.OCC, onp.ALT_DM, onp.LAMBDA_REF, onp.NACT,
            onp.FSAMP, onp.DELAY_MS, onp.SEP_LGS, onp.NOISE_LGS2,
            onp.WIND_SPEED, onp.DIM_PUP)
        assert [p["wind_dir_0"], p["wind_dir_1"]] == list(onp.WIND_DIR)
        assert conf["reduced"] == []
        assert len(harness.wavelengths(conf)) == 35
