"""Moment-result assembly (the subset of ngmix_tpu/gmix/gmix.py the slice needs)."""
from .. import moments


def get_weighted_moments_stats(ares):
    """sums dict -> full moments result dict"""
    res = dict(ares)
    res.update(
        moments.make_mom_result(
            res["sums"], res["sums_cov"], sums_norm=res.get("wsum")
        )
    )
    return res
