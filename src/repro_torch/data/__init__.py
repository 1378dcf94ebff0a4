"""Synthetic data and the token pipeline (numpy copies of
``repro.data.synthetic`` and ``repro.data.pipeline``)."""
