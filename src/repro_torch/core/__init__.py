"""Core solver modules of the port (mirrors ``repro.core``)."""
