"""Command-line entry points (counterpart of ``repro.launch``): ``serve``
and ``train``."""
