"""Data generators and host batching (counterpart of ``repro.data``)."""
