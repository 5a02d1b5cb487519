"""Joint priors on a model's parameter vector: the port of
``ngmix_tpu/joint_prior.py``.

``PriorSimpleSep`` (the simple models: row, col, g1, g2, T, one flux a
band), ``PriorBDFSep`` (bdf: fracdev after T) and ``PriorBDSep`` (bd:
log10(Td/Te) and fracdev after T); ``PriorGalsimSimpleSep`` (r50 in
T's slot) and ``PriorSpergelSep`` (r50 and nu in bdf's T and fracdev
slots), whose fits (``KSpaceFitter``) take run_lm; ``PriorCoellipSame``
(ngauss T and ngauss flux slots sharing one T and one F prior, for
``CoellipFitter``, run_lm). nband is the length of the list of F
priors, one flux a band, or 1 for a single F prior.

``fill_fdiff_device(pars)`` maps pars [B, npars] to the LM's prior rows
[B, nrows], as the reference maps one vector: PriorSimpleSep takes
sqrt(max(-2 ln p, 0)) of each ln(prob) row, unsigned and 0 where chi2 =
0; PriorBDFSep and PriorBDSep take the components' signed
``get_fdiff_device`` rows. ``fill_fdiff_jacobian(pars)`` also gives
their Jacobian [B, nrows, npars] in closed form, the reference's
``jax.jacfwd`` of the same map: each row depends on one parameter, the
g row on (g1, g2); a row that is 0 by the chi2 guard, or infinite
outside a prior's support, has derivative 0. ``table()`` gives the
rows to K3 and K3-mb (``ops/lm_solve.py``) as [nrows, 8] float64: the
kind, the form, the one or two parameter indices (-1 for none) and up
to four constants of each row, evaluated by
``csrc/lm_common.cuh: prior_row`` with the same formulas.

The host methods are the reference's: ``sample``, ``get_widths``,
``get_lnprob_scalar``, ``get_prob_scalar``, ``get_lnprob_array`` and
``get_prob_array`` in numpy over the components' generators, the host
``fill_fdiff`` (one vector's rows into a numpy array, evaluated by
``fill_fdiff_device`` in float64 on the CPU), and
``get_lnprob_scalar_device`` on tensors.
"""
import numpy as np
import torch

from .gmix.tables import get_coellip_npars
from .priors.priors import FORM_FDIFF, FORM_LNP, sqrt_m2ln_grad

# the columns of a prior table row: kind, form, the two parameter
# indices, four constants
TABLE_COLS = 8


class PriorSimpleSep(object):
    """separable priors on [cen1, cen2, g1, g2, T, F...] (ref:
    joint_prior.py:28-115); the rows are sqrt(max(-2 ln p, 0)) of the
    ln(prob) of each component"""

    # the columns of the shape before the fluxes
    nshape = 5
    form = FORM_LNP

    def __init__(self, cen_prior, g_prior, T_prior, F_prior):
        self.cen_prior = cen_prior
        self.g_prior = g_prior
        self.T_prior = T_prior
        self._set_F(F_prior)

    def _set_F(self, F_prior):
        if isinstance(F_prior, (list, tuple)):
            self.nband = len(F_prior)
            self.F_priors = list(F_prior)
        else:
            self.nband = 1
            self.F_priors = [F_prior]
        self.set_bounds()

    def _extra_priors(self):
        """the priors of the columns between T and the fluxes"""
        return []

    def set_bounds(self):
        bounds = [(None, None)] * 4
        some = False
        for p in [self.T_prior] + self._extra_priors() + self.F_priors:
            if p.has_bounds():
                some = True
                bounds.append((p.bounds[0], p.bounds[1]))
            else:
                bounds.append((None, None))
        self.bounds = bounds if some else None

    @property
    def n_prior_pars(self):
        """the prior rows"""
        return self.nshape - 1 + self.nband

    @property
    def npars(self):
        """the parameters of the fit the prior is for"""
        return self.nshape + self.nband

    def _one_dim(self):
        """(prior, parameter index) of every row after cen and g"""
        priors = [self.T_prior] + self._extra_priors() + self.F_priors
        return [(p, 4 + i) for i, p in enumerate(priors)]

    def _rows(self, pars):
        """[(row [B], [(parameter index, derivative [B])...])] in the
        rows' order"""
        if pars.dim() != 2 or pars.shape[1] != self.npars:
            raise ValueError("%s takes pars [B, %d], got %s"
                             % (type(self).__name__, self.npars, tuple(pars.shape)))
        x = [pars[:, k] for k in range(self.npars)]
        lnp_form = self.form == FORM_LNP
        if lnp_form:
            cen = self.cen_prior.get_lnprob_device_sep_grad(x[0], x[1])
            cen = [sqrt_m2ln_grad(*c) for c in cen]
            g, dg1, dg2 = sqrt_m2ln_grad(*self.g_prior.get_lnprob_device2d_grad(x[2], x[3]))
        else:
            cen = self.cen_prior.get_fdiff_device_grad(x[0], x[1])
            g, dg1, dg2 = self.g_prior.get_fdiff_device_grad(x[2], x[3])
        rows = [(cen[0][0], [(0, cen[0][1])]), (cen[1][0], [(1, cen[1][1])]),
                (g, [(2, dg1), (3, dg2)])]
        for p, k in self._one_dim():
            if lnp_form:
                r, d = sqrt_m2ln_grad(*p.get_lnprob_device_grad(x[k]))
            else:
                r, d = p.get_fdiff_device_grad(x[k])
            rows.append((r, [(k, d)]))
        return rows

    def get_widths(self, nrand=10000):
        """the standard deviation of each parameter over nrand samples
        (2 for g1 and g2), drawn once and kept"""
        if not hasattr(self, "_sigma_estimates"):
            sigmas = self.sample(nrand).std(axis=0)
            sigmas[2] = 2.0
            sigmas[3] = 2.0
            self._sigma_estimates = sigmas
        return self._sigma_estimates

    def fill_fdiff(self, pars, fdiff):
        """one vector's prior rows (fill_fdiff_device in float64 on the
        CPU) into the front of the numpy array fdiff; returns their
        number"""
        x = torch.as_tensor(np.asarray(pars, dtype="f8"))[None]
        rows = self.fill_fdiff_device(x)[0].numpy()
        fdiff[: rows.size] = rows
        return rows.size

    def get_lnprob_scalar(self, pars):
        """ln(prob) of one parameter vector (numpy), the components'
        host values summed; raises GMixRangeError where a component
        does"""
        lnp = self.cen_prior.get_lnprob_scalar(pars[0], pars[1])
        lnp += self.g_prior.get_lnprob_scalar2d(pars[2], pars[3])
        for p, k in self._one_dim():
            lnp += p.get_lnprob_scalar(pars[k])
        return lnp

    def get_prob_scalar(self, pars):
        return np.exp(self.get_lnprob_scalar(pars))

    def get_lnprob_array(self, pars):
        """ln(prob) [N] of parameter vectors [N, npars] (numpy), the
        components' array forms summed"""
        lnp = self.cen_prior.get_lnprob_array(pars[:, 0], pars[:, 1])
        lnp = lnp + self.g_prior.get_lnprob_array2d(pars[:, 2], pars[:, 3])
        for p, k in self._one_dim():
            lnp = lnp + p.get_lnprob_array(pars[:, k])
        return lnp

    def get_prob_array(self, pars):
        return np.exp(self.get_lnprob_array(pars))

    def get_lnprob_scalar_device(self, pars):
        """ln(prob) [...] of pars [..., npars] on tensors: LOWVAL
        outside a component's support, never raising"""
        lnp = self.cen_prior.get_lnprob_device(pars[..., 0], pars[..., 1])
        lnp = lnp + self.g_prior.get_lnprob_device2d(pars[..., 2], pars[..., 3])
        for p, k in self._one_dim():
            lnp = lnp + p.get_lnprob_device(pars[..., k])
        return lnp

    def sample(self, nrand=None):
        """parameter vectors [nrand, npars] drawn from the components in
        the reference's order (cen, g, T, the extra shape columns, the
        fluxes); one vector [npars] for nrand None"""
        n = 1 if nrand is None else nrand
        samples = np.zeros((n, self.npars))
        samples[:, 0], samples[:, 1] = self.cen_prior.sample(n)
        samples[:, 2], samples[:, 3] = self.g_prior.sample2d(n)
        for p, k in self._one_dim():
            samples[:, k] = p.sample(n)
        return samples[0, :] if nrand is None else samples

    def fill_fdiff_device(self, pars):
        """the prior rows [B, n_prior_pars] of pars [B, npars]"""
        return torch.stack([r for r, _ in self._rows(pars)], dim=-1)

    def fill_fdiff_jacobian(self, pars):
        """(rows [B, n_prior_pars], their Jacobian [B, n_prior_pars,
        npars])"""
        rows = self._rows(pars)
        jac = pars.new_zeros((pars.shape[0], len(rows), self.npars))
        for i, (_, ders) in enumerate(rows):
            for k, d in ders:
                jac[:, i, k] = d
        return torch.stack([r for r, _ in rows], dim=-1), jac

    def table(self):
        """the rows for K3 and K3-mb: [n_prior_pars, TABLE_COLS] float64
        of (kind, form, index, second index or -1, constants)"""
        def row(kind, form, i0, i1, consts):
            consts = [float(c) for c in consts]
            return [kind, form, i0, i1] + consts + [0.0] * (4 - len(consts))

        lnp_form = self.form == FORM_LNP
        g = self.g_prior
        out = [row(self.cen_prior.kind, self.form, i, -1, self.cen_prior.consts(i))
               for i in (0, 1)]
        out.append(row(g.kind, FORM_LNP if lnp_form else g.fdiff_form, 2, 3, g.consts))
        for p, k in self._one_dim():
            out.append(row(p.kind, FORM_LNP if lnp_form else p.fdiff_form, k, -1, p.consts))
        return torch.tensor(out, dtype=torch.float64)


class PriorBDSep(PriorSimpleSep):
    """bulge+disk [c1, c2, g1, g2, T, log10(Td/Te), fracdev, F...] (ref:
    joint_prior.py:161-209); the rows are the components' signed
    get_fdiff_device"""

    nshape = 7
    form = FORM_FDIFF

    def __init__(self, cen_prior, g_prior, T_prior, logTratio_prior, fracdev_prior,
                 F_prior):
        self.cen_prior = cen_prior
        self.g_prior = g_prior
        self.T_prior = T_prior
        self.logTratio_prior = logTratio_prior
        self.fracdev_prior = fracdev_prior
        self._set_F(F_prior)

    def _extra_priors(self):
        return [self.logTratio_prior, self.fracdev_prior]


class PriorBDFSep(PriorSimpleSep):
    """bdf [c1, c2, g1, g2, T, fracdev, F...] (ref:
    joint_prior.py:263-303); the rows are the components' signed
    get_fdiff_device"""

    nshape = 6
    form = FORM_FDIFF

    def __init__(self, cen_prior, g_prior, T_prior, fracdev_prior, F_prior):
        self.cen_prior = cen_prior
        self.g_prior = g_prior
        self.T_prior = T_prior
        self.fracdev_prior = fracdev_prior
        self._set_F(F_prior)

    def _extra_priors(self):
        return [self.fracdev_prior]


class PriorGalsimSimpleSep(PriorSimpleSep):
    """PriorSimpleSep with r50 in T's slot (ref: joint_prior.py:148-154)"""

    def __init__(self, cen_prior, g_prior, r50_prior, F_prior):
        super().__init__(cen_prior, g_prior, r50_prior, F_prior)
        self.r50_prior = r50_prior


class PriorSpergelSep(PriorBDFSep):
    """spergel [c1, c2, g1, g2, r50, nu, F...]: PriorBDFSep with r50 and
    nu in T's and fracdev's slots (ref: joint_prior.py:349-357)"""

    def __init__(self, cen_prior, g_prior, r50_prior, nu_prior, F_prior):
        super().__init__(cen_prior, g_prior, r50_prior, nu_prior, F_prior)
        self.r50_prior = r50_prior
        self.nu_prior = nu_prior


class PriorCoellipSame(PriorSimpleSep):
    """ngauss coelliptical gaussians [c1, c2, g1, g2, T_1..T_n,
    F_1..F_n], every T under T_prior and every flux under F_prior, one
    band (ref: joint_prior.py:360-440)"""

    def __init__(self, ngauss, cen_prior, g_prior, T_prior, F_prior):
        self.ngauss = ngauss
        super().__init__(cen_prior, g_prior, T_prior, F_prior)
        if self.nband != 1:
            raise ValueError("coellip only supports one band")

    @property
    def npars(self):
        return get_coellip_npars(self.ngauss)

    @property
    def n_prior_pars(self):
        return 3 + 2 * self.ngauss

    def _one_dim(self):
        ng = self.ngauss
        return ([(self.T_prior, 4 + i) for i in range(ng)]
                + [(self.F_priors[0], 4 + ng + i) for i in range(ng)])

    def set_bounds(self):
        bounds = [(None, None)] * 4
        some = False
        for p in [self.T_prior] + self.F_priors:
            if p.has_bounds():
                some = True
                pb = (p.bounds[0], p.bounds[1])
            else:
                pb = (None, None)
            bounds += [pb] * self.ngauss
        self.bounds = bounds if some else None

    def get_lnprob_scalar(self, pars):
        if len(pars) != self.npars:
            raise ValueError("pars size %d expected %d" % (len(pars), self.npars))
        return super().get_lnprob_scalar(pars)

    def get_lnprob_array(self, pars):
        # the reference takes PriorSimpleSep's: T in column 4 and the
        # one flux in column 5
        lnp = self.cen_prior.get_lnprob_array(pars[:, 0], pars[:, 1])
        lnp = lnp + self.g_prior.get_lnprob_array2d(pars[:, 2], pars[:, 3])
        lnp = lnp + self.T_prior.get_lnprob_array(pars[:, 4])
        return lnp + self.F_priors[0].get_lnprob_array(pars[:, 5])

    def sample(self, nrand=None):
        """the reference's draws: column 4 takes T_prior twice (a draw,
        then a second added in the loop), each other T one, then the
        fluxes"""
        n = 1 if nrand is None else nrand
        ng = self.ngauss
        samples = np.zeros((n, self.npars))
        samples[:, 0], samples[:, 1] = self.cen_prior.sample(n)
        samples[:, 2], samples[:, 3] = self.g_prior.sample2d(n)
        samples[:, 4] = self.T_prior.sample(n)
        for i in range(ng):
            samples[:, 4 + i] += self.T_prior.sample(n)
        for i in range(ng):
            samples[:, 4 + ng + i] = self.F_priors[0].sample(n)
        return samples[0, :] if nrand is None else samples


# the joint priors whose rows the kernels take (a subclass's too)
PRIORS = (PriorSimpleSep, PriorBDFSep, PriorBDSep)
