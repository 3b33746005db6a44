"""What ``pip install .`` ships of the port, and where an installed port
builds its kernels.

Every kernel source and every header it includes is package data, every
subpackage is in the package list, a wheel of the tree holds them, and
the package laid out as an install outside a checkout builds into
``$XDG_CACHE_HOME`` (default ``~/.cache``), never into ``site-packages``
and never into a checkout.  Nothing is compiled here: the CPU has no
``nvcc``; the card builds the installed copy in ``chip_smoke.py``
(phase 16c), whose layout helper these tests also check against the
wheel.
"""

import fnmatch
import os
import re
import shutil
import subprocess
import sys
import tomllib
import zipfile
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from muse_psfr_tpu_torch.ops import _build  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "muse_psfr_tpu_torch"
CSRC = os.path.join(ROOT, PKG, "csrc")


def _setuptools():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        return tomllib.load(fh)["tool"]["setuptools"]


def _shipped(name):
    return any(fnmatch.fnmatch(f"csrc/{name}", g)
               for g in _setuptools()["package-data"][PKG])


def test_every_kernel_source_is_package_data():
    files = sorted(os.listdir(CSRC))
    assert {"mma_common.cuh", "wgmma_common.cuh"} <= set(files)
    assert [f for f in files if not _shipped(f)] == []


def test_every_include_resolves_to_a_shipped_file():
    found = {}
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name)) as fh:
            for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', fh.read(),
                                  re.M):
                found.setdefault(inc, []).append(name)
    assert {"mma_common.cuh", "wgmma_common.cuh"} <= set(found)
    for inc, by in found.items():
        assert os.path.isfile(os.path.join(CSRC, inc)), (inc, by)
        assert _shipped(inc), (inc, by)


def test_every_subpackage_is_in_the_package_list():
    on_disk = {".".join(Path(base).relative_to(ROOT).parts)
               for base, _, files in os.walk(os.path.join(ROOT, PKG))
               if "__init__.py" in files}
    listed = {p for p in _setuptools()["packages"]
              if p.split(".")[0] == PKG}
    assert f"{PKG}.examples" in on_disk
    assert on_disk == listed


def test_a_wheel_ships_the_headers_and_the_examples(tmp_path):
    pytest.importorskip("setuptools")
    src, out = tmp_path / "src", tmp_path / "out"
    src.mkdir()
    for name in ("pyproject.toml", "README.md", "LICENSE"):
        shutil.copy2(os.path.join(ROOT, name), src / name)
    for pkg in ("muse_psfr", "muse_psfr_tpu", PKG):
        shutil.copytree(os.path.join(ROOT, pkg), src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from setuptools import build_meta; "
            "print(build_meta.build_wheel(sys.argv[1]))")
    proc = subprocess.run([sys.executable, "-c", code, str(out)],
                          cwd=str(src), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    wheel = out / proc.stdout.split()[-1]
    with zipfile.ZipFile(wheel) as zf:
        shipped = sorted(n for n in zf.namelist()
                         if n.startswith(PKG + "/"))
    for name in ("csrc/mma_common.cuh", "csrc/wgmma_common.cuh",
                 "examples/full_night.py", "examples/sensitivity_sweep.py"):
        assert f"{PKG}/{name}" in shipped
    assert [n for n in shipped if n.startswith(f"{PKG}/csrc/")] == \
        sorted(f"{PKG}/csrc/{f}" for f in os.listdir(CSRC))
    # the chip check lays the port out as this wheel does
    assert chip_smoke.installed_layout(str(tmp_path / "site")) == shipped


def test_the_checkout_builds_into_its_own_build_dir():
    assert _build.BUILD_DIR == Path(ROOT) / "build" / PKG
    assert _build.CSRC == Path(CSRC)


_PROBE = """
import muse_psfr_tpu_torch as m
from muse_psfr_tpu_torch.ops import _build
print(m.__file__)
print(_build.BUILD_DIR)
print(_build.CSRC)
print(sorted(p.name for p in _build.headers()))
print(_build._LIB)
"""


@pytest.mark.parametrize("xdg", [True, False],
                         ids=["XDG_CACHE_HOME", "HOME"])
def test_an_installed_port_builds_into_the_user_cache(tmp_path, xdg):
    site, run, home = tmp_path / "site", tmp_path / "run", tmp_path / "home"
    chip_smoke.installed_layout(str(site))
    run.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "XDG_CACHE_HOME"}
    env.update(PYTHONPATH=str(site), HOME=str(home))
    if xdg:
        env["XDG_CACHE_HOME"] = str(tmp_path / "cache")
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          cwd=str(run), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    init, build, csrc, headers, lib = proc.stdout.splitlines()[:5]
    cache = tmp_path / "cache" if xdg else home / ".cache"
    assert init == str(site / PKG / "__init__.py")
    assert build == str(cache / PKG / "build")
    assert csrc == str(site / PKG / "csrc")
    assert headers == "['mma_common.cuh', 'wgmma_common.cuh']"
    assert lib == "None" and not cache.exists()


def test_the_installed_cli_runs_on_the_cpu(tmp_path):
    """``python -m muse_psfr_tpu_torch`` from the installed layout alone
    prints the CLI block and builds nothing on the CPU."""
    site, run = tmp_path / "site", tmp_path / "run"
    chip_smoke.installed_layout(str(site))
    run.mkdir()
    env = dict(os.environ, PYTHONPATH=str(site),
               XDG_CACHE_HOME=str(tmp_path / "cache"))
    proc = subprocess.run(
        [sys.executable, "-m", PKG, "--device", "cpu", "--no-color",
         "--values", "1,0.7,25", "--logfile", "run.log"], env=env,
        cwd=str(run), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = (run / "run.log").read_text().splitlines()
    assert lines[2:] == chip_smoke.CLI_LOG
    assert not (tmp_path / "cache").exists()
