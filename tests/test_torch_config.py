"""The PyTorch port's GalacsiConfig against the JAX package's, field for
field: every JAX field is ported with an equal default, renamed, or listed
in TPU_LAYOUT_ONLY (NOT_YET_PORTED is empty now), and the derived grid
properties agree; zoom_precision takes "high" and "highest" only,
matmul_precision and conv_precision what ``jax.lax.Precision`` takes."""

import dataclasses

import pytest

pytest.importorskip("torch")

from muse_psfr_tpu import config as jcfg  # noqa: E402
from muse_psfr_tpu_torch import config as tcfg  # noqa: E402


def _defaults(cls):
    return {f.name: f.default for f in dataclasses.fields(cls)}


def test_every_jax_field_is_ported_renamed_or_listed():
    port = _defaults(tcfg.GalacsiConfig)
    jax_fields = _defaults(jcfg.GalacsiConfig)
    for name, default in jax_fields.items():
        if name in tcfg.NOT_YET_PORTED or name in tcfg.TPU_LAYOUT_ONLY:
            assert name not in port, name
            continue
        pname = tcfg.RENAMED.get(name, name)
        assert pname in port, f"JAX field {name!r} missing from the port"
        assert port[pname] == default, (name, port[pname], default)
    # nothing the JAX package does not have
    carried = {tcfg.RENAMED.get(n, n) for n in jax_fields}
    assert set(port) <= carried, set(port) - carried


def test_rename_map_and_not_yet_ported_name_jax_fields():
    jax_fields = _defaults(jcfg.GalacsiConfig)
    assert tcfg.RENAMED == {"use_pallas": "use_fused_zoom",
                            "use_pallas_conv": "use_fused_conv",
                            "pallas_disc_skip": "disc_skip",
                            "pallas_disc_min_ndir": "disc_min_ndir"}
    assert set(tcfg.RENAMED) <= set(jax_fields)
    assert set(tcfg.NOT_YET_PORTED) <= set(jax_fields)
    assert tcfg.NOT_YET_PORTED == ()
    assert set(tcfg.TPU_LAYOUT_ONLY) == {"pallas_lambda_chunk",
                                        "pallas_dir_block",
                                        "pallas_conv_pack"}
    dropped = set(tcfg.NOT_YET_PORTED) | set(tcfg.TPU_LAYOUT_ONLY)
    assert not set(tcfg.RENAMED) & dropped
    assert not set(tcfg.NOT_YET_PORTED) & set(tcfg.TPU_LAYOUT_ONLY)


@pytest.mark.parametrize("kw", [{}, {"dim": 256, "dim_pup": 16, "dimpsf": 8},
                                {"otf_support": 256},
                                {"use_sym_fold": False},
                                {"use_zoom_dft": False},
                                {"nsspup": 20.0, "dim": 640}])
@pytest.mark.parametrize("prop", ["dimall", "pitch", "wfs_pitch", "fc",
                                  "fold_ncols", "otf_window", "npup"])
def test_derived_properties_match(kw, prop):
    assert (getattr(tcfg.GalacsiConfig(**kw), prop)
            == getattr(jcfg.GalacsiConfig(**kw), prop))


def test_tiny_config_and_with_():
    t, j = tcfg.TINY_CONFIG, jcfg.TINY_CONFIG
    for f in dataclasses.fields(tcfg.GalacsiConfig):
        if f.name not in tcfg.RENAMED.values():
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    c = t.with_(dtype="float64", use_fused_zoom=False)
    assert c.dtype == "float64" and not c.use_fused_zoom
    assert t.dtype == "float32"                  # frozen original
    with pytest.raises(dataclasses.FrozenInstanceError):
        t.dim = 64


@pytest.mark.parametrize("name", ["zoom_anchor", "zoom_anchor_degree",
                                  "zoom_anchor_budget",
                                  "zoom_anchor_min_ndir", "pallas_disc_skip",
                                  "pallas_disc_min_ndir"])
def test_anchor_and_disc_fields_are_ported(name):
    """The two kernel switches of K5/K6 and their parameters carry over
    with the JAX defaults (the disc-skip knobs under port names)."""
    port = _defaults(tcfg.GalacsiConfig)
    assert name not in tcfg.NOT_YET_PORTED + tcfg.TPU_LAYOUT_ONLY
    assert port[tcfg.RENAMED.get(name, name)] == \
        _defaults(jcfg.GalacsiConfig)[name]


def test_bad_support_raises_like_jax():
    for cfg in (tcfg.GalacsiConfig(otf_support=100),
                jcfg.GalacsiConfig(otf_support=100)):
        with pytest.raises(ValueError):
            cfg.otf_window


def test_zoom_precision_is_ported_and_checked():
    """The JAX default "high" and "highest" are accepted; the JAX
    package's one-pass "default" (outside the accuracy budget) and any
    other value raise."""
    assert tcfg.GalacsiConfig().zoom_precision == "high" == \
        jcfg.GalacsiConfig().zoom_precision
    assert tcfg.ZOOM_PRECISIONS == ("high", "highest")
    assert tcfg.GalacsiConfig(zoom_precision="highest").zoom_precision == \
        "highest"
    for bad in ("default", "HIGH", None):
        with pytest.raises(ValueError, match="zoom_precision"):
            tcfg.GalacsiConfig(zoom_precision=bad)
        with pytest.raises(ValueError, match="zoom_precision"):
            tcfg.TINY_CONFIG.with_(zoom_precision=bad)


@pytest.mark.parametrize("name", ["matmul_precision", "conv_precision"])
def test_precision_tier_fields_are_ported_and_checked(name):
    """Both tier fields carry the JAX default "highest" and take the three
    values ``jnp.matmul(precision=...)`` takes; anything else raises when
    the config is made."""
    port = _defaults(tcfg.GalacsiConfig)
    assert port[name] == "highest" == _defaults(jcfg.GalacsiConfig)[name]
    assert name not in tcfg.NOT_YET_PORTED + tcfg.TPU_LAYOUT_ONLY
    assert tcfg.MATMUL_PRECISIONS == ("default", "high", "highest")
    for value in tcfg.MATMUL_PRECISIONS:
        assert getattr(tcfg.GalacsiConfig(**{name: value}), name) == value
        assert getattr(tcfg.TINY_CONFIG.with_(**{name: value}), name) == value
    for bad in ("HIGH", "float32", None, 3):
        with pytest.raises(ValueError, match=name):
            tcfg.GalacsiConfig(**{name: bad})
