"""Gaussian mixtures as dense [..., n, 6] tensors (p, row, col, irr, irc, icc)."""
