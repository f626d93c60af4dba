"""The closed-form DAEF pipeline (counterpart of ``repro.core``)."""
