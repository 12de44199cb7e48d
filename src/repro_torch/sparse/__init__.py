"""Segment reductions used by the solver (mirrors ``repro.sparse``)."""
