"""repro_torch.launch.serve against repro.launch.serve.

* Argument errors: the same argv gives the same ``error:`` line as the
  reference CLI (tests/test_serve_cli.py pins the reference's messages), and
  exit code 2.
* The LM mode raises ``NotImplementedError`` naming ROADMAP queue A item 14
  (decode), ``--mesh-tenants`` item 12.
* Every ported mode runs end to end on the host (``--device cpu``, tiny
  scale) and prints its ``... OK`` line: ``--fleet`` with continuous and pad
  packing, streamed (``--chunk-samples``), ``--async-rounds`` with
  ``--dp-epsilon`` and with ``--secagg``, and ``--privacy``.
"""
import pytest

from repro.launch import serve as jserve
from repro_torch.launch import serve


def _error_line(text: str) -> str:
    """The message after ``<prog>: error:`` (the program names differ)."""
    lines = [ln for ln in text.splitlines() if "error:" in ln]
    assert lines, text
    return lines[-1].split("error:", 1)[1]


def _errors(argv, capsys, monkeypatch) -> tuple[str, str]:
    with pytest.raises(SystemExit) as exc:
        serve.main(argv)
    assert exc.value.code == 2
    ours = _error_line(capsys.readouterr().err)
    monkeypatch.setattr("sys.argv", ["serve.py"] + argv)
    with pytest.raises(SystemExit) as exc:
        jserve.main()
    assert exc.value.code == 2
    return ours, _error_line(capsys.readouterr().err)


@pytest.mark.parametrize("argv,needle", [
    (["--fleet", "-1"], ">= 1, or 0 to serve an LM instead"),
    (["--fleet", "0"], "--arch is required"),
    (["--fleet", "4", "--mesh-tenants", "-2"], ">= 1, or 0 to disable tenant sharding"),
    (["--fleet", "4", "--chunk-samples", "-3"], ">= 1, or 0 for one-shot (non-streaming)"),
    (["--async-rounds", "-1"], ">= 1, or 0 for LM/fleet mode"),
    (["--fleet", "4", "--rounds", "0"], "--rounds must be >= 1"),
    (["--fleet", "4", "--tile-width", "0"], "--tile-width must be >= 1"),
    (["--mesh-tenants", "2"], "--mesh-tenants only applies to --fleet mode"),
    (["--stats-backend", "fused"], "--stats-backend only applies to --fleet mode"),
    (["--chunk-samples", "8"], "--chunk-samples only applies to --fleet mode"),
    (["--async-rounds", "2", "--fleet", "4"], "separate modes"),
    (["--fleet", "4", "--packing", "ragged"], "--packing"),
    (["--async-rounds", "2", "--dp-epsilon", "0"], "--dp-epsilon must be > 0"),
    (["--fleet", "4", "--secagg"], "--dp-epsilon/--secagg apply to --async-rounds"),
    (["--privacy", "--fleet", "4"], "--privacy is a standalone smoke mode"),
    (["--async-rounds", "2", "--sites", "0"], "--sites must be >= 1"),
    (["--async-rounds", "2", "--straggle", "1.0"], "--straggle must be in [0, 1)"),
    (["--async-rounds", "2", "--max-staleness", "-1"], "--max-staleness must be >= 0"),
    (["--arch", "gpt5"], "invalid choice"),
], ids=lambda v: " ".join(v) if isinstance(v, list) else None)
def test_argument_errors_match_the_reference(argv, needle, capsys, monkeypatch):
    ours, ref = _errors(argv, capsys, monkeypatch)
    assert needle in ours
    assert ours == ref


def test_lm_mode_and_mesh_tenants_name_their_items():
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 14"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 12"):
        serve.main(["--fleet", "2", "--mesh-tenants", "2", "--device", "cpu"])


@pytest.mark.parametrize("argv,ok", [
    (["--fleet", "4", "--rounds", "3", "--scale", "0.1"], "fleet serve OK"),
    (["--fleet", "3", "--rounds", "2", "--scale", "0.1", "--packing", "pad"],
     "fleet serve OK"),
    (["--fleet", "3", "--rounds", "2", "--scale", "0.1", "--chunk-samples", "64",
      "--tile-width", "8", "--stats-backend", "fused"], "fleet serve OK"),
    (["--async-rounds", "3", "--sites", "3", "--dp-epsilon", "8", "--scale", "0.1"],
     "async federation OK"),
    (["--async-rounds", "2", "--sites", "3", "--secagg", "--scale", "0.1"],
     "async federation OK"),
    (["--privacy", "--scale", "0.1"], "privacy smoke OK"),
], ids=["fleet", "fleet pad", "fleet streamed fused", "async dp", "async secagg", "privacy"])
def test_modes_run_on_the_host(argv, ok, capsys):
    serve.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.rstrip().splitlines()[-1] == ok
    if "--dp-epsilon" in argv:
        assert "cumulative epsilon spent per site" in out
    if "--secagg" in argv:
        assert "forcing max_staleness=0" in out
    if argv[:2] == ["--fleet", "4"]:
        assert "tile dispatches" in out and "scored 12 tile shapes" in out
