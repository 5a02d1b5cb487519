"""Default values and numerical constants.

The port's own copy of the constants of ``ngmix_tpu/defaults.py`` that
it uses: these numbers define the objective, so they match the JAX
package exactly.
"""
# the LM's stopping settings of a Fitter without fit_pars
DEFAULT_LM_PARS = {"maxfev": 4000, "ftol": 1.0e-5, "xtol": 1.0e-5}

# parameter / covariance values reported when a fit fails
PDEF = -9.999e9
CDEF = 9.999e9
# s/n denominator of a fit whose parameter point is bad
BIGVAL = 9999.0e47

# Gaussian evaluations are smoothly apodized to zero over
# chi^2 in [APOD_CHI2, MAX_CHI2] so rendered models are C2 in the
# parameters.
FASTEXP_MAX_CHI2 = 25.0
FASTEXP_APOD_CHI2 = 20.0

# determinant floor for a 2-d gaussian covariance. In float32 this
# underflows to 0, which still behaves correctly as a floor (det <= 0
# is invalid).
GMIX_LOW_DETVAL = 1.0e-200

# ln(prob) of a point outside a prior's support
LOWVAL = float("-inf")
