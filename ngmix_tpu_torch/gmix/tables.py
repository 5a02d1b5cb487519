"""Fixed (p, f) gaussian-expansion tables of the exp, dev, gauss and
turb models, and the model registry.

The port's own copy of the tables and the registry in
``ngmix_tpu/gmix/tables.py``: they are part of the model definition
and match it exactly.
"""
import numpy as np

PVALS_EXP = np.array(
    [
        0.00061601229677880041,
        0.0079461395724623237,
        0.053280454055540001,
        0.21797364640726541,
        0.45496740582554868,
        0.26521634184240478,
    ]
)

FVALS_EXP = np.array(
    [
        0.002467115141477932,
        0.018147435573256168,
        0.07944063151366336,
        0.27137669897479122,
        0.79782256866993773,
        2.1623306025075739,
    ]
)

PVALS_DEV = np.array(
    [
        6.5288960012625658e-05,
        0.00044199216814302695,
        0.0020859587871659754,
        0.0075913681418996841,
        0.02260266219257237,
        0.056532254390212859,
        0.11939049233042602,
        0.20969545753234975,
        0.29254151133139222,
        0.28905301416582552,
    ]
)

FVALS_DEV = np.array(
    [
        2.9934935706271918e-07,
        3.4651596338231207e-06,
        2.4807910570562753e-05,
        1.4307404300535354e-04,
        7.2753169298239500e-04,
        3.4582464394427260e-03,
        1.6086645440719100e-02,
        7.7006776775654429e-02,
        4.1012562102501476e-01,
        2.9812509778548648e00,
    ]
)

PVALS_TURB = np.array(
    [0.596510042804182, 0.4034898268889178, 1.303069003078001e-07]
)

FVALS_TURB = np.array(
    [0.5793612389470884, 1.621860687127999, 7.019347162356363]
)

PVALS_GAUSS = np.array([1.0])
FVALS_GAUSS = np.array([1.0])

MODEL_TABLES = {
    "exp": (PVALS_EXP, FVALS_EXP),
    "dev": (PVALS_DEV, FVALS_DEV),
    "turb": (PVALS_TURB, FVALS_TURB),
    "gauss": (PVALS_GAUSS, FVALS_GAUSS),
}

# model registry -------------------------------------------------------

GMIX_FULL = 0
GMIX_GAUSS = 1
GMIX_TURB = 2
GMIX_EXP = 3
GMIX_DEV = 4
GMIX_BDC = 5
GMIX_BDF = 6
GMIX_COELLIP = 7
GMIX_CM = 9
GMIX_BD = 10

_gmix_model_dict = {
    "full": GMIX_FULL,
    GMIX_FULL: GMIX_FULL,
    "gauss": GMIX_GAUSS,
    GMIX_GAUSS: GMIX_GAUSS,
    "turb": GMIX_TURB,
    GMIX_TURB: GMIX_TURB,
    "exp": GMIX_EXP,
    GMIX_EXP: GMIX_EXP,
    "dev": GMIX_DEV,
    GMIX_DEV: GMIX_DEV,
    "bdc": GMIX_BDC,
    GMIX_BDC: GMIX_BDC,
    "bd": GMIX_BD,
    GMIX_BD: GMIX_BD,
    "bdf": GMIX_BDF,
    GMIX_BDF: GMIX_BDF,
    "cm": GMIX_CM,
    GMIX_CM: GMIX_CM,
    "coellip": GMIX_COELLIP,
    GMIX_COELLIP: GMIX_COELLIP,
}

_gmix_string_dict = {
    GMIX_FULL: "full",
    GMIX_GAUSS: "gauss",
    GMIX_TURB: "turb",
    GMIX_EXP: "exp",
    GMIX_DEV: "dev",
    GMIX_BDC: "bdc",
    GMIX_BD: "bd",
    GMIX_BDF: "bdf",
    GMIX_CM: "cm",
    GMIX_COELLIP: "coellip",
}
_gmix_string_dict.update({v: v for v in _gmix_string_dict.values()})

_gmix_npars_dict = {
    GMIX_GAUSS: 6,
    GMIX_TURB: 6,
    GMIX_EXP: 6,
    GMIX_DEV: 6,
    GMIX_CM: 6,
    GMIX_BD: 8,
    GMIX_BDF: 7,
    GMIX_BDC: 8,
}

_gmix_ngauss_dict = {
    GMIX_GAUSS: 1,
    "gauss": 1,
    GMIX_TURB: 3,
    "turb": 3,
    GMIX_EXP: 6,
    "exp": 6,
    GMIX_DEV: 10,
    "dev": 10,
    GMIX_CM: 16,
    GMIX_BD: 16,
    GMIX_BDF: 16,
    GMIX_BDC: 16,
    "em1": 1,
    "em2": 2,
    "em3": 3,
    "em4": 4,
    "em5": 5,
    "coellip1": 1,
    "coellip2": 2,
    "coellip3": 3,
    "coellip4": 4,
    "coellip5": 5,
}


def get_model_num(model):
    if model not in _gmix_model_dict:
        raise ValueError("unknown model: '%s'" % model)
    return _gmix_model_dict[model]


def get_model_name(model):
    if model not in _gmix_string_dict:
        raise ValueError("unknown model: '%s'" % model)
    return _gmix_string_dict[model]


def get_model_ngauss(model):
    key = model if model in _gmix_ngauss_dict else get_model_num(model)
    if key not in _gmix_ngauss_dict:
        raise ValueError("unknown model: '%s'" % model)
    return _gmix_ngauss_dict[key]


def get_model_npars(model):
    return _gmix_npars_dict[get_model_num(model)]


def get_coellip_npars(ngauss):
    return 4 + 2 * ngauss


def get_coellip_ngauss(npars):
    return (npars - 4) // 2
