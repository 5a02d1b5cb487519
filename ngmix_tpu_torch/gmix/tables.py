"""Fixed (p, f) gaussian-expansion tables of the exp and turb models.

The port's own copy of the tables in ``ngmix_tpu/gmix/tables.py``:
they are part of the model definition and match it exactly.
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

PVALS_TURB = np.array(
    [0.596510042804182, 0.4034898268889178, 1.303069003078001e-07]
)

FVALS_TURB = np.array(
    [0.5793612389470884, 1.621860687127999, 7.019347162356363]
)
