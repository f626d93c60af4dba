"""Launchers and their step functions (counterpart of ``repro/launch``):
``steps``, ``train`` (the training CLI: LM training on synthetic token
streams, ``--model-parallel`` on a ("data", "model") mesh), ``serve`` (the
LM decode, fleet, async-federation and privacy modes), ``mesh`` (device
meshes over ``torch.distributed`` ranks) and ``shardings`` (the model
zoo's 2-D layouts by parameter name, and a rank's slices of full trees).
``make_production_mesh``, ``dryrun`` and the HLO/roofline tools have no
torch meaning."""
