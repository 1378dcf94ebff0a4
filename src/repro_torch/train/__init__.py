"""Optimizers (counterpart of ``repro.train.optim``)."""
