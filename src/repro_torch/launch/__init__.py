"""Command-line entry points and the mesh factories (counterpart of
``repro.launch``): ``serve``, ``train`` and ``mesh``."""
