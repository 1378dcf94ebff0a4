"""Synthetic data (numpy copy of ``repro.data.synthetic``)."""
