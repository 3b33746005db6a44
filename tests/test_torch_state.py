"""state.py: the constants the port computes equal the JAX package's host
tables, configs carry across, and installing the JAX tables with
load_reference_constants leaves the results unchanged (and a changed
table does reach the computation)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu.config import GalacsiConfig as JConfig  # noqa: E402
from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu.core.coeff_l0 import COEFF_L0_VALUES  # noqa: E402
from muse_psfr_tpu.otf import psf as jpsf  # noqa: E402
from muse_psfr_tpu.psd import model as jpsd  # noqa: E402
from muse_psfr_tpu_torch import state  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG as TTINY  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu_torch.core import coeff_l0  # noqa: E402
from muse_psfr_tpu_torch.otf import psf as tpsf  # noqa: E402
from muse_psfr_tpu_torch.parallel.batch import process_batch  # noqa: E402
from muse_psfr_tpu_torch.psd import model as tpsd  # noqa: E402
from _one_thread import one_thread  # noqa: E402

H = (100, 10000)


def _jax_tables(jc):
    return {
        "glao_static_transfer": jpsd._glao_static_transfer(
            (100.0, 10000.0), 12.0, 1, jc),
        "fitting_dphi_basis": jpsf._fitting_dphi_basis_np(jc),
        "pupil_otf": np.asarray(jpsf.pupil_otf(jc)),
        "coeff_l0": COEFF_L0_VALUES,
    }


def _run(cfg):
    rng = np.random.default_rng(9)
    return process_batch(rng.uniform(0.6, 1.6, 3), rng.uniform(0.3, 0.9, 3),
                         rng.uniform(9, 29, 3), np.ones((3, 4)),
                         [800.0, 900.0], h=H, cfg=cfg, chunk=2,
                         device="cpu")


@pytest.fixture
def restore_tables():
    saved = (dict(tpsd._STATIC_TRANSFER_CACHE),
             dict(tpsf._DPHI_BASIS_CACHE), dict(tpsf._PUPIL_OTF_CACHE),
             coeff_l0.COEFF_L0_VALUES)
    yield
    for cache, old in zip((tpsd._STATIC_TRANSFER_CACHE,
                           tpsf._DPHI_BASIS_CACHE, tpsf._PUPIL_OTF_CACHE),
                          saved):
        cache.clear()
        cache.update(old)
    coeff_l0.COEFF_L0_VALUES = saved[3]
    state.clear_device_consts()


def test_port_constants_equal_jax_tables():
    tc, jc = TTINY.with_(dtype="float64"), JTINY.with_(dtype="float64")
    tables = _jax_tables(jc)
    ours = tpsd._glao_static_transfer(H, 12.0, 1, tc)
    for k, v in tables["glao_static_transfer"].items():
        assert np.array_equal(ours[k], v), k
    assert np.array_equal(tpsf.fitting_dphi_basis(tc),
                          tables["fitting_dphi_basis"])
    assert np.array_equal(tpsf.pupil_otf(tc), tables["pupil_otf"])
    assert np.array_equal(coeff_l0.COEFF_L0_VALUES, tables["coeff_l0"])


def test_loaded_jax_tables_leave_results_unchanged(restore_tables):
    tc = TTINY.with_(dtype="float64", fit_dtype="float64")
    with one_thread():
        before = _run(tc)
        state.load_reference_constants(
            _jax_tables(JTINY.with_(dtype="float64")), tc, h=H)
        after = _run(tc)
    for a, b in zip(before, after):
        assert np.array_equal(a, b)
    # and the installed tables are the ones used: a changed coeffL0
    # table changes the tip-tilt width and with it the PSFs
    state.load_reference_constants({"coeff_l0": COEFF_L0_VALUES * 0.5}, tc)
    changed = _run(tc)
    assert not np.allclose(changed[1], before[1])


def test_config_from_reference():
    assert state.config_from_reference(
        dataclasses.asdict(JConfig())) == GalacsiConfig()
    jc = JTINY.with_(use_pallas=False, use_pallas_conv=False,
                     pallas_lambda_chunk=7, zoom_anchor="on",
                     dtype="float64")
    assert state.config_from_reference(dataclasses.asdict(jc)) == \
        TTINY.with_(use_fused_zoom=False, use_fused_conv=False,
                    zoom_anchor="on", dtype="float64")
    with pytest.raises(ValueError):
        state.config_from_reference({"no_such_field": 1})


def test_config_from_reference_carries_anchor_and_disc():
    """The K5/K6 switches reach the port: the disc-skip knobs under their
    port names, the anchor fields as they are, the TPU lane-packing knob
    dropped."""
    jc = JConfig(zoom_anchor="auto", zoom_anchor_degree=6,
                 zoom_anchor_budget=1e-7, zoom_anchor_min_ndir=9,
                 pallas_disc_skip=True, pallas_disc_min_ndir=1,
                 pallas_conv_pack=2)
    assert state.config_from_reference(dataclasses.asdict(jc)) == \
        GalacsiConfig(zoom_anchor="auto", zoom_anchor_degree=6,
                      zoom_anchor_budget=1e-7, zoom_anchor_min_ndir=9,
                      disc_skip=True, disc_min_ndir=1)
    with pytest.raises(ValueError):
        state.load_reference_constants({"coeff_l0": np.ones(3)}, TTINY)


def test_config_from_reference_carries_zoom_precision():
    """zoom_precision reaches the port as it is; the JAX package's
    one-pass "default" is refused."""
    for prec in ("high", "highest"):
        assert state.config_from_reference(dataclasses.asdict(
            JConfig(zoom_precision=prec))).zoom_precision == prec
    with pytest.raises(ValueError, match="zoom_precision"):
        state.config_from_reference(dataclasses.asdict(
            JConfig(zoom_precision="default")))


@pytest.mark.parametrize("field", ["matmul_precision", "conv_precision"])
@pytest.mark.parametrize("tier", ["default", "high", "highest"])
def test_config_from_reference_carries_the_precision_tiers(field, tier):
    """A JAX config's ``matmul_precision``/``conv_precision`` reach the
    port as they are, so the port computes the same tier."""
    got = state.config_from_reference(dataclasses.asdict(
        JConfig(**{field: tier})))
    assert getattr(got, field) == tier
    assert got == GalacsiConfig(**{field: tier})
