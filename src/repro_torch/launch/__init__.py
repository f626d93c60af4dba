"""Launchers and their step functions (counterpart of ``repro/launch``):
``steps``, ``train`` (the training CLI: LM training on synthetic token
streams), ``serve`` (the LM decode, fleet, async-federation and privacy
modes) and ``mesh`` (device meshes over ``torch.distributed`` ranks).
The model zoo's 2-D layouts (``shardings``) are still to port (ROADMAP
queue A); ``make_production_mesh``, ``dryrun`` and the HLO/roofline tools
have no torch meaning."""
