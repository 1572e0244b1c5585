"""Serving entry points of the port; ``predictor.Predictor`` super-resolves
one LR/reference image pair."""
