"""Fault tolerance (counterpart of ``repro.distributed.fault``); the
sharding half of ``repro.distributed`` comes with ROADMAP A7."""
