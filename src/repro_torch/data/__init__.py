"""Data generators (counterpart of ``repro.data``)."""
