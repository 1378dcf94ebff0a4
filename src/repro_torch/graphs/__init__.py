"""Proximity-graph construction and Algorithm-1 search (counterpart of
``repro.graphs``)."""
