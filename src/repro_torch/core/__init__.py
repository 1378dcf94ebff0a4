"""GATE core: hubs, topology features, query-aware samples, the two-tower
model, the navigation graph and ``GateIndex`` (counterpart of
``repro.core``)."""
