"""Serving (counterpart of ``repro.serve``): ``ServeDaemon``, the LM
``ServeEngine`` and the retrieval-augmented ``RagPipeline``."""

_MODULES = {
    "GenerationResult": "engine",
    "ServeEngine": "engine",
    "RagPipeline": "retrieval",
    "RagResult": "retrieval",
    "PendingResult": "daemon",
    "SearchRequest": "daemon",
    "ServeDaemon": "daemon",
}

__all__ = sorted(_MODULES)


def __getattr__(name):
    # lazily: `python -m repro_torch.serve.daemon` would otherwise import
    # the module twice (runpy RuntimeWarning) via this package
    if name in _MODULES:
        import importlib

        module = importlib.import_module(f"repro_torch.serve.{_MODULES[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
