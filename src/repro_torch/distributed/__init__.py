"""Sharding rules and the activation-constraint context (``sharding``) and
fault tolerance (``fault``): counterpart of ``repro.distributed``."""
