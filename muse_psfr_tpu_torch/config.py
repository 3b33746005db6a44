"""Static configuration of the GALACSI WFM ground-layer AO system.

PyTorch counterpart of ``muse_psfr_tpu/config.py``: the same frozen
dataclass, field for field and with the same defaults, so that a JAX
configuration carries over unchanged (``state.config_from_reference``).

Four knobs were renamed because they no longer select a Pallas kernel
(:data:`RENAMED`): ``use_pallas`` is :attr:`GalacsiConfig.use_fused_zoom`
(the hand-written exp+zoom-DFT kernel, ``ops/zoom_dft.py``),
``use_pallas_conv`` is :attr:`GalacsiConfig.use_fused_conv` (the
convolution-chain kernel, ``ops/conv_dft.py``), and ``pallas_disc_skip``/
``pallas_disc_min_ndir`` are :attr:`GalacsiConfig.disc_skip`/
:attr:`GalacsiConfig.disc_min_ndir` (the diffraction-disc skip, K5).  The
knobs that only size or lay out TPU VMEM grid steps or vector-register
lanes are listed in :data:`TPU_LAYOUT_ONLY`.

``zoom_precision`` chooses how the fused zoom kernels (K1, K3, K5, K6)
contract on the card (:data:`ZOOM_PRECISIONS`): "high" (the JAX default)
runs the 3-pass bf16 split ``hi*hi + hi*lo + lo*hi`` with float32
accumulation on tensor cores, "highest" the six bf16 passes of a
three-part split (``Precision.HIGHEST`` on the TPU's matrix unit), a
float32-grade product, in the same kernels.  The JAX package's "default"
(one bf16 pass) is outside the accuracy budget (``docs/precision.md``) and
raises.

``matmul_precision`` and ``conv_precision`` choose the tier of the plain
contractions around the kernels (the structure-function transforms and
the second zoom stage of ``otf/psf.py``; the DFT products of the final
convolutions, ``otf/convolve.py``) and of K2 (``ops/conv_dft.py``), as in
the JAX package: "highest" (the default of both) is one float32 product
(TF32 off, see ``utils/device.py``), "high" the 3-pass bf16 split with
float32 accumulation, "default" one bf16 pass
(``ops/zoom_dft.py:matmul_tier``).  ``matmul_precision`` takes all three
(:data:`MATMUL_PRECISIONS`), as ``jnp.matmul`` does; ``conv_precision``
also reaches K2, which has a "highest" and a "high" body and raises on
anything else, as the JAX package's fused chain does.  Like
``zoom_precision`` they are read only where the card runs: a CPU run
contracts in float32.
"""

from dataclasses import dataclass, replace

#: JAX config fields renamed in the port: {jax name: port name}
RENAMED = {"use_pallas": "use_fused_zoom", "use_pallas_conv": "use_fused_conv",
           "pallas_disc_skip": "disc_skip",
           "pallas_disc_min_ndir": "disc_min_ndir"}

#: JAX config fields that only size or lay out the TPU kernels' VMEM grid
#: steps (wavelengths per launch, directions per step) or pack wavelength
#: planes into the lanes of a TPU vector register; they mean nothing on
#: the card, where K1 takes every wavelength in one launch and sums every
#: direction in registers, and a K2 block loops over a group of planes
#: sized to the card
TPU_LAYOUT_ONLY = ("pallas_lambda_chunk", "pallas_dir_block",
                   "pallas_conv_pack")

#: JAX config fields with no counterpart yet: none is left
NOT_YET_PORTED = ()

#: accepted values of ``zoom_precision``
ZOOM_PRECISIONS = ("high", "highest")

#: accepted values of ``matmul_precision`` and ``conv_precision`` (what
#: ``jax.lax.Precision`` takes); K2 itself runs only the last two
MATMUL_PRECISIONS = ("default", "high", "highest")


@dataclass(frozen=True)
class GalacsiConfig:
    # --- telescope / AO system (reference psfrec.py:70-104) ---------------
    dpup: float = 8.0          # telescope diameter [m]
    occ: float = 0.14          # central obscuration (linear fraction)
    alt_dm: float = 1.0        # DM conjugation altitude [m]
    h_sodium: float = 90000.0  # sodium layer altitude [m] (debug only)
    lambda_ref: float = 0.5    # PSD reference wavelength [um]
    nact: float = 24.0         # linear number of DM actuators
    nsspup: float = 24.0       # linear number of WFS subapertures
    fsamp: float = 1000.0      # WFS sampling frequency [Hz]
    delay_ms: float = 2.5      # loop delay (readout + RTC) [ms]
    sep_lgs: float = 63.0      # LGS radial separation [arcsec]
    noise_lgs2: float = 1.0    # WFS noise a priori [rad^2]
    wind_speed: float = 12.5   # layer wind speed [m/s] (see int-h quirk)
    wind_dir_0: float = 0.628163   # layer 0 wind direction [rad] (pinned)
    wind_dir_1: float = -0.326497  # layer 1 wind direction [rad] (pinned)
    lse: bool = True           # LSE reconstructor (False -> MAP prior)

    # --- numerical grids (reference psfrec.py:103, 655-659, 899) ----------
    dim: int = 1280            # full PSD / OTF grid [px]
    dim_pup: int = 40          # correction-zone pupil size [px]
    dimpsf: int = 40           # output PSF cube size [px]
    pixscale: float = 0.2      # output PSF pixel scale [arcsec/px]
    samp: float = 2.0          # PSF sampling (Nyquist)
    lambda_chunk: int = 7      # wavelengths per step of the plain
                               # (unfused) zoom path; the fused kernel
                               # takes the whole cube in one launch

    # --- telemetry validity limits (reference psfrec.py:30-31) ------------
    min_l0: float = 8.0        # minimum valid outer scale [m]
    max_l0: float = 30.0       # maximum valid outer scale [m]

    # --- compute policy ----------------------------------------------------
    dtype: str = "float32"     # compute dtype for the heavy stages
    fit_dtype: str = "float32" # dtype of the Moffat LM solve
    use_zoom_dft: bool = True  # zoom-DFT matmuls instead of a full IFFT
    use_fft: bool = True       # torch.fft for the structure function /
                               # convolutions; False = DFT-matmul path
                               # (exact, FFT-free), which also routes the
                               # final convolutions through the fused
                               # conv-chain kernel
    matmul_precision: str = "highest"  # tier of the plain contractions of
                               # the OTF chain (structure function,
                               # second zoom stage) on the card: "highest"
                               # = one float32 product, "high" = 3-pass
                               # bf16 split, "default" = one bf16 pass
                               # (outside the accuracy budget)
    zoom_precision: str = "high"  # contraction of the fused zoom kernels
                               # (K1/K3/K5) on the card: "high" = 3-pass
                               # bf16 (hi*hi + hi*lo + lo*hi, float32
                               # accumulation) on tensor cores, "highest" =
                               # six bf16 passes on a three-part split, a
                               # float32-grade product.  Read only where
                               # the kernels run: a CPU night contracts in
                               # float32 ("highest"), as the JAX package's
                               # night off the TPU does
    zoom_exp2: bool = True     # damping as exp2(alpha*log2e*D + log2 w)
                               # instead of exp(alpha*D)*w (same math up
                               # to argument rounding)
    conv_precision: str = "highest"  # tier of the final-PSF convolution
                               # DFT products on the FFT-free route: the
                               # plain products (ops/zoom_dft.py:
                               # matmul_tier) and K2's body, float32 FMAs
                               # at "highest", the 3-pass bf16 split on
                               # tensor cores at "high"; K2 raises on
                               # "default"
    use_dphi_split: bool = True  # linearity split of the structure
                               # function: fitting-PSD transform
                               # precomputed per config, only the
                               # correction-zone block per row; rows with
                               # L0 < dphi_split_l0_min take the exact
                               # transform
    dphi_split_degree: int = 5
    dphi_split_l0_min: float = 2.5
    use_sym_fold: bool = True  # point-symmetry fold of the OTF-side
                               # contractions (columns 0..N/2 only,
                               # mirrors weighted 2); needs dim % 256 == 0
                               # and the zoom-DFT path
    otf_support: int = 0       # OTF support inf-radius [px]; 0 = full
                               # half grid, and the batch planner buckets
                               # rows into windows (parallel/batch.py)
    otf_blue: tuple = None     # (nb, S_blue): the bluest nb wavelengths
                               # run on the smaller centred sub-window
                               # S_blue; set per group by the planner
    blue_tiers: int = 0        # max blue subgroups the planner may form
                               # per support bucket; 0 = auto: 2 at
                               # ndir >= 9, else 1
    use_fused_zoom: bool = True  # hand-written exp+zoom-DFT kernel
                               # (ops/zoom_dft.py) on CUDA float32
    use_fused_conv: bool = True  # hand-written conv-chain kernel
                               # (ops/conv_dft.py) on the FFT-free route
    zoom_anchor: str = "off"   # anchored-Taylor damping (K6,
                               # ops/zoom_dft.py:fused_exp_zoom_anchor):
                               # one exponential e^x per direction and
                               # wavelength group (x = alpha* D, alpha*
                               # the group's midpoint) and each wavelength
                               # rebuilt as e^x sum_j ((rho_l - 1) x)^j/j!.
                               # "auto": the batch planner certifies the
                               # bound (otf/psf.py:zoom_anchor_bound)
                               # against zoom_anchor_budget and turns it
                               # on for nights on CUDA with at least
                               # zoom_anchor_min_ndir directions;
                               # "on"/"off" force it.  Default off, as in
                               # the JAX package
    zoom_anchor_degree: int = 8   # Taylor degree of the reconstruction
    zoom_anchor_budget: float = 1e-6  # max certified per-pixel OTF
                               # abs-error bound for "auto" to engage
    zoom_anchor_min_ndir: int = 4  # fewest directions for "auto"
    disc_skip: bool = False    # skip the fused kernel's work outside the
                               # diffraction OTF's disc (K5,
                               # ops/zoom_dft.py:fused_exp_zoom_disc):
                               # the full window's corner blocks, where
                               # dl <= 1e-12 of its peak
                               # (otf/psf.py:_disc_block_mask); a no-op
                               # on windows inside the disc
    disc_min_ndir: int = 4     # fewest directions for the disc skip

    def __post_init__(self):
        if self.zoom_precision not in ZOOM_PRECISIONS:
            raise ValueError(
                f"zoom_precision must be one of {ZOOM_PRECISIONS}, got "
                f"{self.zoom_precision!r} (one bf16 pass is outside the "
                "accuracy budget)")
        for name in ("matmul_precision", "conv_precision"):
            if getattr(self, name) not in MATMUL_PRECISIONS:
                raise ValueError(
                    f"{name} must be one of {MATMUL_PRECISIONS}, got "
                    f"{getattr(self, name)!r}")

    # --- derived ------------------------------------------------------------
    @property
    def dimall(self) -> int:
        """Correction-zone PSD grid size (2x the pupil, psfrec.py:138)."""
        return 2 * self.dim_pup

    @property
    def pitch(self) -> float:
        """DM inter-actuator distance [m] (psfrec.py:132)."""
        return self.dpup / self.nact

    @property
    def wfs_pitch(self) -> float:
        """WFS subaperture pitch ``dpup/nsspup`` [m] (psfrec.py:578)."""
        return self.dpup / self.nsspup

    @property
    def fc(self) -> float:
        """AO fitting cutoff frequency 1/(2*pitch) [1/m]."""
        return 1.0 / (2.0 * self.pitch)

    @property
    def fold_ncols(self):
        """OTF-grid columns computed under the symmetry fold
        (``dim//2 + 128``), or ``None`` when the fold does not apply."""
        if not (self.use_sym_fold and self.use_zoom_dft
                and self.dim % 256 == 0):
            return None
        return min(self.dim, self.dim // 2 + 128)

    @property
    def otf_window(self):
        """(row_lo, S): rows ``[c-S, c+S)``, columns ``[c-S, c+128)`` of
        the (dim, dim) OTF grid, ``c = dim//2``; ``None`` when the fold is
        off (full grid)."""
        if self.fold_ncols is None:
            return None
        c = self.dim // 2
        S = min(self.otf_support, c) if self.otf_support else c
        if S % 128 != 0 or S <= 0:
            raise ValueError(f"otf_support must be a positive multiple "
                             f"of 128, got {self.otf_support}")
        return (c - S, S)

    @property
    def npup(self) -> int:
        """Pupil support on the full grid [px] (psfrec.py:656)."""
        return self.dim // 2

    def with_(self, **kw) -> "GalacsiConfig":
        return replace(self, **kw)


DEFAULT_CONFIG = GalacsiConfig()

#: small configuration for fast unit tests: same code path, tiny grids
TINY_CONFIG = GalacsiConfig(dim=256, dim_pup=16, dimpsf=8)
