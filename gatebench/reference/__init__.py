"""The plain reference the benchmark holds the port's answers to.

Plain PyTorch, in blocks so that it fits beside nothing else on the card.
It imports no module of the program (``repro_torch``) and neither ``jax``
nor ``repro``: ``knn`` computes exact ground truth, ``walk`` follows
Algorithm 1 (the query tower, the entry hub, the beam search and the int8
walk's exact rerank) from the index's graph and tower weights, and
``graph`` checks the NSG's guarantees on the graph itself.
"""
