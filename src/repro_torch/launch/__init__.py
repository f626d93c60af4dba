"""Launchers and their step functions (counterpart of ``repro/launch``):
``steps``, ``train`` (the training CLI: LM training on synthetic token
streams) and ``serve`` (the LM decode, fleet, async-federation and
privacy modes).
The mesh launchers (``mesh``, ``shardings``) wait for ROADMAP queue A item
12; ``dryrun`` and the HLO/roofline tools have no torch meaning."""
