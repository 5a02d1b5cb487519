"""Per-epoch parameter rows of a joint multi-band fit.

The port's copy of the pieces of ``ngmix_tpu/fitting/fit_model.py``
that the batched multi-band pipeline uses: the bad-point residual
``FDIFF_BAD`` and the per-epoch parameter rows (the shared shape plus
that epoch's band flux). The simple models (exp, gauss, dev, turb) take
the 5 + nband layout (row, col, g1, g2, T, one flux a band); bdf and bd
have more shape columns.
"""
import torch

# residual value of a row at an out-of-range parameter point: large but
# finite, so the LM rejects the step without inf arithmetic
FDIFF_BAD = 1.0e10

# the first flux column of the models whose shape takes more than the
# five (row, col, g1, g2, T) parameters
_FLUX_START = {"bd": 7, "bdf": 6}


def shape_count(model):
    """the shared shape columns of the model, before its flux column(s)"""
    return _FLUX_START.get(model, 5)


def get_band_pars_device(model, pars, band):
    """the shared parameters plus the flux of one band: pars [...,
    npars], band an int or an int tensor [...] -> [..., start + 1]"""
    if model == "coellip":
        return pars
    start = _FLUX_START.get(model, 5)
    band = torch.as_tensor(band, device=pars.device).to(torch.int64)
    flux = torch.gather(
        pars[..., start:], -1,
        torch.broadcast_to(band, pars.shape[:-1])[..., None],
    )
    return torch.cat([pars[..., :start], flux], dim=-1)


def epoch_band_pars(model, pars, band):
    """[..., E, start + 1] per-epoch parameter rows: pars [..., npars],
    band [..., E] the band of each epoch. The shared shape columns
    broadcast; each epoch's flux is a one-hot contraction over the flux
    columns (exactly one 1 in a row, so the selection is exact, as in
    the reference). A band outside [0, nband) selects no flux: 0."""
    E = band.shape[-1]
    if model == "coellip":
        return pars[..., None, :].expand(pars.shape[:-1] + (E, pars.shape[-1]))
    start = _FLUX_START.get(model, 5)
    flux = pars[..., start:]
    onehot = (
        band[..., :, None] == torch.arange(flux.shape[-1], device=band.device)
    ).to(pars.dtype)
    flux_e = torch.sum(onehot * flux[..., None, :], dim=-1)
    shared = pars[..., None, :start].expand(pars.shape[:-1] + (E, start))
    return torch.cat([shared, flux_e[..., None]], dim=-1)
