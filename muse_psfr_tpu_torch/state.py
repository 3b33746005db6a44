"""Carry the JAX package's state across to the port.

The system has no weights: its parameters are a configuration and a few
host float64 tables computed from it.  :func:`config_from_reference`
builds the port's config from a JAX one (``dataclasses.asdict`` of it),
and :func:`load_reference_constants` installs the JAX package's tables,
passed as numpy arrays, into the port's caches, so that both sides
compute from the same numbers.  This module imports no JAX.
"""

import dataclasses

import numpy as np

from .config import (NOT_YET_PORTED, RENAMED, TPU_LAYOUT_ONLY,
                     GalacsiConfig)
from .core import coeff_l0
from .otf import psf as _psf
from .psd import model as _psd
from .utils.device import clear_device_consts


def config_from_reference(fields: dict) -> GalacsiConfig:
    """The port's config from a JAX ``GalacsiConfig``'s fields: renamed
    knobs carried over under their port names (:data:`RENAMED`, e.g.
    ``use_pallas`` -> ``use_fused_zoom``, ``pallas_disc_skip`` ->
    ``disc_skip``), the fields in :data:`TPU_LAYOUT_ONLY` (and in
    :data:`NOT_YET_PORTED`, now empty) dropped; the three ``*_precision``
    fields carry over as they are.  Unknown fields raise."""
    names = {f.name for f in dataclasses.fields(GalacsiConfig)}
    kw = {}
    for key, value in fields.items():
        key = RENAMED.get(key, key)
        if key in NOT_YET_PORTED or key in TPU_LAYOUT_ONLY:
            continue
        if key not in names:
            raise ValueError(f"unknown config field {key!r}")
        kw[key] = tuple(value) if isinstance(value, list) else value
    return GalacsiConfig(**kw)


def load_reference_constants(tables: dict, cfg: GalacsiConfig,
                             h=(100, 10000), npsflin: int = 1):
    """Install the JAX package's host tables for ``cfg`` (and the layer
    altitudes ``h`` / ``npsflin`` of the GLAO transfer functions).

    ``tables`` may hold any of:

    - ``"glao_static_transfer"``: the dict of arrays of
      ``psd/model.py:_glao_static_transfer(h, wind_speed, npsflin, cfg)``;
    - ``"fitting_dphi_basis"``: the full-grid (degree+1, dim, dim) basis;
    - ``"pupil_otf"``: the (dim, dim) diffraction OTF;
    - ``"coeff_l0"``: the (200,) tip-tilt attenuation values.

    Device copies made from the previous tables are dropped.
    """
    if "glao_static_transfer" in tables:
        ws = _psd.effective_wind_speed(h, cfg)
        _psd._STATIC_TRANSFER_CACHE[_psd._static_key(h, ws, npsflin, cfg)] = {
            k: np.asarray(v, np.float64)
            for k, v in tables["glao_static_transfer"].items()}
    if "fitting_dphi_basis" in tables:
        _psf._DPHI_BASIS_CACHE[_psf._basis_key(cfg)] = np.asarray(
            tables["fitting_dphi_basis"], np.float64)
    if "pupil_otf" in tables:
        _psf._PUPIL_OTF_CACHE[_psf._pupil_key(cfg)] = np.asarray(
            tables["pupil_otf"], np.float64)
        _psf._DISC_MASK_CACHE.clear()
    if "coeff_l0" in tables:
        values = np.asarray(tables["coeff_l0"], np.float64)
        if values.shape != coeff_l0.COEFF_L0_GRID.shape:
            raise ValueError(f"coeff_l0 table has shape {values.shape}, "
                             f"expected {coeff_l0.COEFF_L0_GRID.shape}")
        coeff_l0.COEFF_L0_VALUES = values
    clear_device_consts()
