"""Posterior post-processing: thinning, prediction, R_t, within/between."""
