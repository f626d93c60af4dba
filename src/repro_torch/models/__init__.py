"""Architecture zoo: the LM families the port serves, behind one
ModelBundle interface, and the DAEF head on their pooled hidden states."""
from repro_torch.models.api import ModelBundle, cache_specs, get_bundle  # noqa: F401
