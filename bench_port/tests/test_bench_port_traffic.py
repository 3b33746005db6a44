"""The seeded traffic of the benchmark, and the import check."""

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402
from bench_port.traffic.generator import (  # noqa: E402
    JITTER_REL, PIN, Traffic)

MIXES = ("night100", "campaign1000")
BIG = 2 ** 31 + 977


def mix(name):
    return harness.load_json(os.path.join(ROOT, "bench_port", "traffic",
                                          name + ".json"))


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_batches(name):
    a, b = Traffic(mix(name), BIG), Traffic(mix(name), BIG)
    for k in (0, 1, 7, 12345):
        for x, y in zip(a.batch(k), b.batch(k)):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("name", MIXES)
def test_other_seeds_and_batches_differ(name):
    a, b = Traffic(mix(name), BIG), Traffic(mix(name), BIG + 1)
    assert not np.array_equal(a.batch(0)[0], b.batch(0)[0])
    assert not np.array_equal(a.batch(0)[0], a.batch(len(a.pool))[0])


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_pools_conditions(name):
    """A batch is a pool batch in another row order, each value moved by
    the tiny jitter alone: the same work for every seed."""
    m = mix(name)
    t = Traffic(m, BIG)
    for k in range(3):
        s, g, l0, mask = t.batch(k)
        ps, pg, pl, pm = t.pool[t.pool_index(k)]
        order = np.argsort(s)
        assert np.allclose(s[order], np.sort(ps), rtol=2 * JITTER_REL,
                           atol=0)
        assert np.allclose(np.sort(g), np.sort(pg), rtol=2 * JITTER_REL,
                           atol=0)
        assert np.allclose(np.sort(l0), np.sort(pl), rtol=2 * JITTER_REL,
                           atol=0)
        assert mask.sum() == pm.sum()
        assert s.shape == (m["rows"],) and mask.shape == (m["rows"], 4)
    # each cycle hands out every pool batch once
    n = len(t.pool)
    assert sorted(t.pool_index(k) for k in range(n, 2 * n)) == list(range(n))


def test_the_pool_follows_the_night_distribution():
    m = mix("night100")
    t = Traffic(m, 1)
    s = np.concatenate([p[0] for p in t.pool])
    l0 = np.concatenate([p[2] for p in t.pool])
    mask = np.concatenate([p[3] for p in t.pool])
    assert 0.6 <= s.min() and s.max() <= 1.6
    assert 9.0 <= l0.min() and l0.max() <= 29.0        # no exact-group row
    assert 0.05 < np.mean(mask[:, 3] == 0) < 0.15
    assert PIN == (1.0, 0.7, 25.0)
    assert all(tuple(p[i][0] for i in range(3)) == PIN for p in t.pool)


def test_a_new_order_plans_the_same_programs():
    """The planner gives every batch of a pool night the same groups and
    chunk sizes, so the programs warmed in set-up serve the window."""
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.parallel.batch import plan_batch
    t = Traffic(mix("night100"), BIG)
    lb = np.linspace(490, 930, 35)
    k0 = 0
    j = t.pool_index(k0)
    k1 = next(k for k in range(1, 40) if t.pool_index(k) == j)

    def shape(rows):
        p = plan_batch(*rows, lb, npsflin=1, cfg=GalacsiConfig(), chunk=50,
                       device="cuda")
        return [(g.cfg, g.sizes) for g in p.groups]
    assert shape(t.batch(k0)) == shape(t.batch(k1)) == shape(t.pool[j])


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["muse_psfr_tpu_torch",
                                      "muse_psfr_tpu_torch.ops",
                                      "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["muse_psfr_tpu.core", "jax.numpy",
                                      "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "muse_psfr_tpu"]


def test_no_module_of_the_benchmark_loads_jax_or_the_jax_package():
    """Import every module of the benchmark (and the port through it) in a
    fresh process; the reference imports nothing of the port either."""
    code = (
        "import sys\n"
        "import bench_port.reference.oracle_torch\n"
        "assert not any(m.split('.')[0] == 'muse_psfr_tpu_torch' "
        "for m in sys.modules), 'the reference imports the port'\n"
        "import bench_port, bench_port.harness, bench_port.check, "
        "bench_port.tracing, bench_port.control, bench_port.roofline\n"
        "from bench_port import harness\n"
        "man = harness.manifest('.')\n"
        "for m in man['per_layer']: harness.reader(m['name'])\n"
        "p = harness.Program({}, 'cpu')\n"
        "bad = harness.forbidden_modules()\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
