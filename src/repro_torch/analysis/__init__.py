"""The port's correctness tooling: static analysis + runtime auditors
(counterpart of ``repro/analysis``).

The port's speed rests on invariants that ordinary tests do not see — one
CUDA graph per serving tile shape captured at warmup and none after, one
capture per autoencoder fit, kernel libraries opened once and not again
as a streamed fit grows its chunk count, accumulators folded in place,
env resolved before a capture.  This package turns each into a checked
fact:

* :mod:`repro_torch.analysis.lint` — the AST linter with the repository's
  rules re-targeted at torch (``RPR001``..``RPR007``: deprecated
  pre-engine entry points, env reads at import/capture time, host syncs
  and Python control flow on tensors inside a ``torch.cuda.graph``
  capture, blanket warning filters, wall-clock/stdlib randomness in
  library code, literal seeds in privacy code).
  ``python -m repro_torch.analysis <paths>`` runs it.
* :mod:`repro_torch.analysis.retrace` — :func:`trace_guard`, a runtime
  budget auditor of CUDA-graph captures ("traces") and kernel-library
  loads ("compiles"), so a test or a smoke run can assert "zero captures
  after warmup" and "loads flat in the number of chunks".
* :mod:`repro_torch.analysis.donation` — :func:`~repro_torch.analysis
  .donation.probe`, which calls a function once and reports whether the
  buffers it was handed were reused (in place, or as an output's storage).

``python -m repro_torch.analysis retrace`` and ``... donation`` are the
runtime self-checks (on the card unless ``--device cpu``).
"""
from repro_torch.analysis.donation import DonationReport, probe
from repro_torch.analysis.lint import Finding, check_path, check_source
from repro_torch.analysis.retrace import TraceBudgetExceeded, TraceReport, trace_guard

__all__ = [
    "DonationReport",
    "probe",
    "Finding",
    "check_path",
    "check_source",
    "TraceBudgetExceeded",
    "TraceReport",
    "trace_guard",
]
