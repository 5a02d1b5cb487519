"""Batched fitters (the normal-equation Levenberg-Marquardt)."""
