"""Batched circular Moffat fitting (PyTorch Levenberg-Marquardt).

Counterpart of ``muse_psfr_tpu/fit/moffat_fit.py``, replacing the
reference's per-plane ``mpdaf`` / ``scipy.optimize.leastsq`` calls
(psfrec.py:861-871): a fixed-iteration LM with analytic Jacobian fits all
planes at once, the planes being the batch dimension of every tensor (the
5x5 normal equations are explicit per-pixel reductions and an unrolled
Cholesky, so every operation is elementwise over the planes).

Model (circular, no background, as the reference pipeline uses):

    m(y, x) = peak * (1 + ((y-cy)^2 + (x-cx)^2)/alpha^2)^(-n)
"""

import numpy as np
import torch

from ..utils.device import torch_dtype

N_PARAMS = 5
# certified in the JAX package (benchmarks/measure_lm_iters.py,
# tests/test_oracle_parity.py::test_lm_iteration_count_certified)
LM_ITERS = 20

#: layout of the packed per-plane fit result; ``ok`` = 1.0 when the fit
#: converged (finite parameters, an accepted improving step or an optimal
#: start, SPD final Gram matrix)
PACKED_FIELDS = ("cy", "cx", "err_cy", "err_cx", "flux", "err_flux",
                 "peak", "err_peak", "fwhm", "err_fwhm", "n", "err_n",
                 "ok")
N_PACKED = len(PACKED_FIELDS)


def _model_and_jac(p, yy, xx):
    """Model (P, ny, nx) and its five Jacobian planes at parameters
    ``p`` (5, P)."""
    cy, cx, peak, alpha, n = (q[:, None, None] for q in p)
    dy = yy - cy
    dx = xx - cx
    rr = (dy * dy + dx * dx) / (alpha * alpha)
    u = 1.0 + rr
    lu = torch.log(u)
    un = torch.exp(-n * lu)      # u ** (-n): one log + one exp
    m = peak * un
    common = peak * n * un / u
    j_cy = common * 2.0 * dy / (alpha * alpha)
    j_cx = common * 2.0 * dx / (alpha * alpha)
    j_peak = un
    j_alpha = common * 2.0 * rr / alpha
    j_n = -m * lu
    return m, (j_cy, j_cx, j_peak, j_alpha, j_n)


def _init_params(img, yy, xx):
    """Initial guess (5, P): peak pixel, second-moment width, n = 2."""
    P, ny, nx = img.shape
    flat_img = img.reshape(P, -1)
    peak0 = torch.max(flat_img, dim=1).values
    flat = torch.argmax(flat_img, dim=1)
    cy0 = torch.div(flat, nx, rounding_mode="floor").to(img.dtype)
    cx0 = (flat % nx).to(img.dtype)
    tot = torch.sum(flat_img, dim=1)
    var = torch.sum(img * ((yy - cy0[:, None, None]) ** 2
                           + (xx - cx0[:, None, None]) ** 2),
                    dim=(1, 2)) / tot
    fwhm0 = torch.clamp_min(
        2.355 * torch.sqrt(torch.clamp_min(var, 0.25) / 2.0), 1.0)
    a0 = fwhm0 / (2.0 * np.sqrt(2.0 ** 0.5 - 1.0))
    return torch.stack([cy0, cx0, peak0, a0, torch.full_like(a0, 2.0)])


def _gram(jac_cols, r):
    """Normal-equation pieces as explicit per-plane reductions:
    ``jtj[i][j] = sum(J_i J_j)`` (lower triangle) and
    ``jtr[i] = sum(J_i r)``, each (P,)."""
    n = len(jac_cols)
    jtj = [[torch.sum(jac_cols[i] * jac_cols[j], dim=(1, 2))
            for j in range(i + 1)] for i in range(n)]
    jtr = [torch.sum(jac_cols[i] * r, dim=(1, 2)) for i in range(n)]
    return jtj, jtr


def _chol_factor(a_lower):
    """Unrolled Cholesky of a tiny SPD matrix given as a lower-triangular
    list of lists of (P,) tensors.  A non-SPD input yields NaN, which the
    LM step then rejects (NaN compares false)."""
    n = len(a_lower)
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a_lower[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve(L, b):
    """Solve ``L L^T x = b`` (lists of (P,) tensors)."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _chol_inverse(a_lower):
    """Columns of the inverse of a tiny SPD matrix (n unrolled solves)."""
    n = len(a_lower)
    L = _chol_factor(a_lower)
    one = torch.ones_like(a_lower[0][0])
    zero = torch.zeros_like(one)
    return [_chol_solve(L, [one if i == j else zero for i in range(n)])
            for j in range(n)]


def _lm_solve(img, yy, xx):
    """Fixed-iteration LM on planes ``img`` (P, ny, nx).

    Returns ``(params (5, P), cov diag (5, P), ok (P,))``: each plane
    accepts or rejects its own steps (``torch.where``), with the damping
    ``lam`` divided by 3 on acceptance, doubled on rejection and clipped
    to [1e-12, 1e8]."""
    def model_cols(p):
        m, jac = _model_and_jac(p, yy, xx)
        return m - img, jac

    def cost_of(p):
        m, _ = _model_and_jac(p, yy, xx)
        r = m - img
        return torch.sum(r * r, dim=(1, 2))

    p = _init_params(img, yy, xx)
    lam = torch.full_like(p[0], 1e-3)
    c = cost_of(p)
    acc = torch.zeros_like(c, dtype=torch.bool)
    for _ in range(LM_ITERS):
        r, cols = model_cols(p)
        jtj, jtr = _gram(cols, r)
        a = [[jtj[i][j] * ((1.0 + lam) if i == j else 1.0)
              for j in range(i + 1)] for i in range(N_PARAMS)]
        delta = _chol_solve(_chol_factor(a), [-g for g in jtr])
        p_new = p + torch.stack(delta)
        c_new = cost_of(p_new)
        better = c_new < c
        p = torch.where(better[None], p_new, p)
        c = torch.where(better, c_new, c)
        acc = acc | better
        lam = torch.clamp(torch.where(better, lam / 3.0, lam * 2.0),
                          1e-12, 1e8)

    r, cols = model_cols(p)
    jtj, _ = _gram(cols, r)
    inv_cols = _chol_inverse(jtj)
    dof = img.shape[1] * img.shape[2] - N_PARAMS
    var = torch.stack([inv_cols[k][k] for k in range(N_PARAMS)]) * (c / dof)
    # converged = finite solution with meaningful error bars AND either an
    # accepted improving step or an already optimal start
    solved = acc | (c < 1e-12 * torch.sum(img * img, dim=(1, 2)))
    ok = (solved & torch.all(torch.isfinite(p), dim=0)
          & torch.all(torch.isfinite(var), dim=0))
    return p, var, ok.to(img.dtype)


def fit_moffat_cube_packed(cube, dtype: str = "float32"):
    """Fit every (ny, nx) plane of ``cube`` (..., ny, nx) (a tensor) with a
    circular Moffat in ``dtype``.  Returns a tensor of shape
    ``cube.shape[:-2] + (N_PACKED,)`` laid out per :data:`PACKED_FIELDS`,
    on the cube's device."""
    dt = torch_dtype(dtype)
    lead = cube.shape[:-2]
    ny, nx = cube.shape[-2:]
    planes = cube.reshape((-1, ny, nx)).to(dt)
    yy = torch.arange(ny, dtype=dt, device=cube.device)[:, None]
    xx = torch.arange(nx, dtype=dt, device=cube.device)[None, :]

    p, var, ok = _lm_solve(planes, yy, xx)
    err = torch.sqrt(torch.clamp_min(var, 0.0))
    cy, cx, peak, alpha, n = p
    e_cy, e_cx, e_peak, e_alpha, e_n = err

    k_f = 2.0 * torch.sqrt(2.0 ** (1.0 / n) - 1.0)
    fwhm = alpha * k_f
    dk_dn = (-np.log(2.0) * 2.0 ** (1.0 / n)
             / (n * n * torch.sqrt(2.0 ** (1.0 / n) - 1.0)))
    err_fwhm = torch.sqrt((k_f * e_alpha) ** 2 + (alpha * dk_dn * e_n) ** 2)
    flux = peak * np.pi * alpha * alpha / (n - 1.0)
    err_flux = torch.abs(flux) * torch.sqrt((e_peak / peak) ** 2 +
                                            (2.0 * e_alpha / alpha) ** 2 +
                                            (e_n / (n - 1.0)) ** 2)

    packed = torch.stack([cy, cx, e_cy, e_cx, flux, err_flux, peak, e_peak,
                          fwhm, err_fwhm, n, e_n, ok], dim=-1)
    return packed.reshape(tuple(lead) + (N_PACKED,))


def unpack_fit(packed):
    """Packed fit array -> dict of numpy arrays with the reference's
    column shapes (center/fwhm as 2-vectors)."""
    packed = np.asarray(packed.cpu() if torch.is_tensor(packed) else packed)
    if packed.shape[-1] != N_PACKED:
        raise ValueError(
            f"packed fit array has {packed.shape[-1]} fields; expected "
            f"{N_PACKED} laid out per PACKED_FIELDS")
    f = {name: packed[..., k] for k, name in enumerate(PACKED_FIELDS)}
    dup = lambda a, b: np.stack([a, b], axis=-1)  # noqa: E731
    return {
        "center": dup(f["cy"], f["cx"]),
        "err_center": dup(f["err_cy"], f["err_cx"]),
        "flux": f["flux"], "err_flux": f["err_flux"],
        "peak": f["peak"], "err_peak": f["err_peak"],
        "fwhm": dup(f["fwhm"], f["fwhm"]),
        "err_fwhm": dup(f["err_fwhm"], f["err_fwhm"]),
        "n": f["n"], "err_n": f["err_n"],
        "ok": f["ok"] > 0.5,
    }


def fit_moffat_cube(cube, dtype: str = "float32"):
    """Fit every plane of ``cube`` (a tensor) with a circular Moffat;
    returns a dict of numpy arrays (center, flux, peak, fwhm [px], n,
    their 1-sigma errors, ok)."""
    return unpack_fit(fit_moffat_cube_packed(cube, dtype=dtype))


def fit_moffat_cube_host64(cube):
    """The same fit in float64 on the CPU, for small contract-critical
    cubes (the mean PSF, single conditions): the float32 solve leaves
    ~1e-3-level noise on the parameters, which the polynomial fit
    downstream amplifies past the reference's 1e-2 coefficient contract
    (docs/precision.md)."""
    cube = torch.as_tensor(np.asarray(
        cube.cpu() if torch.is_tensor(cube) else cube, np.float64))
    return fit_moffat_cube(cube, dtype="float64")
