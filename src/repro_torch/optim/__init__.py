"""Optimizers on parameter trees (port of ``repro.optim``)."""
