"""Step functions of the launchers (counterpart of ``repro/launch``).  Only
``steps`` is ported; the training CLI waits for ROADMAP queue A item 13."""
