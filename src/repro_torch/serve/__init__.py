"""Serving (counterpart of ``repro.serve``): ``ServeDaemon``.  The RAG
pipeline and the LM engine are not ported yet (ROADMAP A7)."""

__all__ = ["PendingResult", "SearchRequest", "ServeDaemon"]


def __getattr__(name):
    # the daemon lazily: `python -m repro_torch.serve.daemon` would otherwise
    # import the module twice (runpy RuntimeWarning) via this package
    if name in __all__:
        from repro_torch.serve import daemon

        return getattr(daemon, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
