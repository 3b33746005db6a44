"""The comparison that decides ``correct``.

Batches of the window, drawn from the seed once the window has closed (at
least one of them, where the window has one, a batch whose plan runs a tail
chunk), are held to the float64 reference (``reference/oracle_torch.py``), which works
every row out again from the batch's telemetry and nothing else.  What the
program handed back for each of those batches is judged:

* ``mean_psf_rel``: the mean PSF cube over the batch's rows, max |program -
  reference| over max |reference| (every stage up to the cube: PSD model,
  structure function, exp + zoom DFT with the planner's windows and blue
  split, the tip-tilt and instrument convolutions, the row mean);
* ``fwhm_rel``, ``beta_rel``: the Moffat fit of every row and wavelength
  of the batch, the largest relative gap of FWHM and of beta from the
  reference's fit of the reference's cube;
* ``mean_fwhm_rel``, ``mean_beta_rel``: the same for the refit of the
  mean.

Each has its limit in the cell's file (``cells/<cell>.json``), set from the
readings that ``PERF.md`` lists.
"""

import numpy as np

from .reference.oracle_torch import TorchOracle, fit_planes

def batch_numbers(oracle, rows, fit, mean, fit_mean, fields, device,
                  block):
    """The compared numbers of one batch: program outputs ``fit`` (B, nl,
    N_PACKED), ``mean`` (nl, n, n), ``fit_mean`` (nl, N_PACKED) against the
    reference on the batch's ``rows``."""
    i_fw, i_n = fields.index("fwhm"), fields.index("n")
    cubes = oracle.cubes(*rows, block=block)            # (B, nl, n, n)
    ref_mean = cubes.mean(axis=0)
    B, nl, n = cubes.shape[:3]
    planes = cubes.reshape(-1, n, n)
    fits = [fit_planes(planes[i:i + 4096], device=device)
            for i in range(0, len(planes), 4096)]
    fw = np.concatenate([f[0] for f in fits]).reshape(B, nl)
    be = np.concatenate([f[1] for f in fits]).reshape(B, nl)
    mfw, mbe = fit_planes(ref_mean, device=device)
    fit = np.asarray(fit, np.float64)
    fit_mean = np.asarray(fit_mean, np.float64)
    rel = lambda got, want: float(np.max(np.abs(got / want - 1.0)))  # noqa
    return {
        "mean_psf_rel": float(np.max(np.abs(np.asarray(mean, np.float64)
                                            - ref_mean))
                              / np.max(np.abs(ref_mean))),
        "fwhm_rel": rel(np.abs(fit[..., i_fw]), fw),
        "beta_rel": rel(fit[..., i_n], be),
        "mean_fwhm_rel": rel(np.abs(fit_mean[..., i_fw]), mfw),
        "mean_beta_rel": rel(fit_mean[..., i_n], mbe),
    }


def check_batches(win, mix, seed, tail=()):
    """The window's batches that are checked: ``check_batches`` of the mix,
    drawn from the seed among those that returned.  Where none drawn runs
    a tail chunk and some batch in ``tail`` does, the last one drawn gives
    way to one of those, also drawn from the seed."""
    done = sorted(win["outputs"])
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % 2 ** 64,
                                                        2]))
    n = min(int(mix["check_batches"]), len(done))
    picked = [int(k) for k in rng.choice(done, n, replace=False)]
    tail = sorted(set(tail) & set(done))
    if picked and tail and not set(picked) & set(tail):
        picked[-1] = int(rng.choice(tail))
    return sorted(picked)


def check_window(win, traffic, config, cellf, mix, seed, program, lbda, h,
                 npsflin, tail=()):
    """``{name: (value, limit)}`` over the checked batches (the worst
    batch of each number); ``tail``: the window's batches whose plan runs
    a tail chunk."""
    fields = program.fields
    prog = config["program"]
    dev = program.device
    oracle = TorchOracle(lbda, npsflin=npsflin, dim=prog["dim"],
                         dimpsf=prog["dimpsf"], pixscale=prog["pixscale"],
                         h=h, dim_pup=prog["dim_pup"], device=dev)
    block = max(1, 64 // (npsflin * npsflin))
    worst = {}
    for k in check_batches(win, mix, seed, tail):
        fit, mean, fit_mean = win["outputs"][k]
        nums = batch_numbers(oracle, traffic.batch(k), fit, mean, fit_mean,
                             fields, dev, block)
        for name, v in nums.items():
            worst[name] = max(worst.get(name, 0.0), v)
    limits = cellf["limits"]
    return {name: (v, float(limits[name])) for name, v in worst.items()}
