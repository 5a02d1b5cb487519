"""Typed lists of mixtures (``ngmix_tpu/gmix/gmix_lists.py``)."""
__all__ = ["GMixList", "MultiBandGMixList"]

from .gmix import GMix


class GMixList(list):
    """list of GMix objects with type safety"""

    def append(self, gmix):
        assert isinstance(gmix, GMix), "gmix should be of type GMix"
        super().append(gmix)

    def __setitem__(self, index, gmix):
        assert isinstance(gmix, GMix), "gmix should be of type GMix"
        super().__setitem__(index, gmix)


class MultiBandGMixList(list):
    """list of GMixList per band with type safety"""

    def append(self, gmix_list):
        assert isinstance(gmix_list, GMixList), (
            "gmix_list should be of type GMixList"
        )
        super().append(gmix_list)

    def __setitem__(self, index, gmix_list):
        assert isinstance(gmix_list, GMixList), (
            "gmix_list should be of type GMixList"
        )
        super().__setitem__(index, gmix_list)
