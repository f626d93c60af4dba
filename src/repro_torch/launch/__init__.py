"""Launchers and their step functions (counterpart of ``repro/launch``):
``steps`` and ``serve`` (the fleet, async-federation and privacy modes) are
ported; the training CLI waits for ROADMAP queue A item 13."""
