"""The LM fitters: the batched normal-equation LM of the pipelines
(lm.run_lm_normal_batched), and the host API's fitters over the
residual form and the kernels (Fitter, CoellipFitter, PSFFluxFitter),
their fit objective and results (fit_model), the noise-power
covariance (noise_cov) and the fits of analytic k profiles
(kspace_fitters, the reference's "galsim" fitters)."""
from . import lm  # noqa: F401
from .fit_model import (  # noqa: F401
    CoellipFitModel,
    FitData,
    FitModel,
    PSFFluxFitModel,
    SIMPLE_ANALYTIC_MODELS,
    make_fdiff_fn,
    make_lnprob_fn,
    pack_fit_data,
)
from .fitters import CoellipFitter, Fitter, PSFFluxFitter  # noqa: F401
from .lm import LMConf, run_lm, run_lm_batch  # noqa: F401
from .kspace_fitters import (  # noqa: F401
    GalsimFitter,
    GalsimMoffatFitter,
    GalsimPSFFluxFitter,
    GalsimSpergelFitter,
    KSpaceFitter,
    KSpaceFitModel,
)
from . import noise_cov  # noqa: F401

# the reference's module-path aliases: leastsqbound -> lm, results ->
# fit_model, galsim_fitters and galsim_results -> kspace_fitters
from . import fit_model, kspace_fitters, lm  # noqa: F401,E402

leastsqbound = lm
results = fit_model
galsim_fitters = kspace_fitters
galsim_results = kspace_fitters
