"""repro_torch.launch.serve against repro.launch.serve.

* Argument errors: the same argv gives the same ``error:`` line as the
  reference CLI (tests/test_serve_cli.py pins the reference's messages), and
  exit code 2.
* The LM mode of the encoder-decoder (whisper) serves on the host and
  ends in ``serve OK``; ``--mesh-tenants`` shards the fleet: one rank
  prints the reference's sharding line and serves the reference's
  traffic, two gloo ranks serve the same.
* The LM mode runs the dense, VLM, MoE, SSM and hybrid backbones on the
  host and prints the reference's lines; :func:`serve.generate` on the reference's
  own parameters gives the reference loop's greedy tokens.
* Every ported mode runs end to end on the host (``--device cpu``, tiny
  scale) and prints its ``... OK`` line: ``--fleet`` with continuous and pad
  packing, streamed (``--chunk-samples``), ``--async-rounds`` with
  ``--dp-epsilon`` and with ``--secagg``, and ``--privacy``.
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close

from repro.configs import registry as jregistry
from repro.launch import serve as jserve
from repro.models import get_bundle as jget_bundle
from repro_torch import interop
from repro_torch.configs import registry
from repro_torch.data import synthetic
from repro_torch.launch import serve
from repro_torch.models import get_bundle


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


def test_lm_mode_and_mesh_tenants_name_their_items(capsys, monkeypatch):
    """Whisper's LM mode (ROADMAP item 14, done) prints the reference's four
    lines, ending in ``serve OK``.  ``--mesh-tenants`` (item 12's DAEF part,
    done): ``1`` prints the reference's sharding line and serves the same
    requests as the reference's CLI on its one device; ``2`` starts two
    gloo ranks, which serve the same requests and flag the same anomalies
    as the one rank; on the card the ranks run under NCCL, one card a
    rank, and fewer cards than ranks raise before any rank starts."""
    serve.main(["--arch", "whisper-tiny", "--reduced", "--batch", "2", "--prompt-len", "8",
                "--gen", "4", "--device", "cpu"])
    lines = capsys.readouterr().out.rstrip().splitlines()
    assert len(lines) == 4 and lines[-1] == "serve OK", lines
    assert lines[0] == "prompts [2, 8] -> generated (2, 4)"

    argv = ["--fleet", "2", "--rounds", "2", "--scale", "0.1", "--packing", "pad"]
    monkeypatch.setattr("sys.argv", ["serve.py", *argv, "--mesh-tenants", "1"])
    jserve.main()
    ref = capsys.readouterr().out.splitlines()
    runs = {}
    for d in ("1", "2"):
        serve.main([*argv, "--mesh-tenants", d, "--device", "cpu"])
        runs[d] = capsys.readouterr().out.splitlines()
        assert runs[d][-1] == "fleet serve OK", runs[d]
    shard = [ln for ln in ref if "mesh axis" in ln]
    assert shard == ["fleet: sharding 2 tenants over a 1-device 'tenants' mesh axis "
                     "(2 per device)"]
    assert shard == [ln for ln in runs["1"] if "mesh axis" in ln]
    assert ("fleet: sharding 2 tenants over a 2-device 'tenants' mesh axis (1 per device)"
            in runs["2"])

    def served(lines):
        return [ln.split(" (+1")[0] for ln in lines if ln.startswith("served ")]

    def flagged(lines):
        return [ln.split("; flagged ")[1] for ln in lines if "; flagged " in ln]

    assert served(ref) == served(runs["1"]) == served(runs["2"]) != []
    assert flagged(runs["1"]) == flagged(runs["2"]) != []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--mesh-tenants 2 on the card needs 2 cards"):
        serve.main([*argv, "--mesh-tenants", "2"])


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


LM_ARCHS = ("qwen3-1.7b", "mamba2-780m", "recurrentgemma-9b", "internvl2-2b",
            "qwen2-moe-a2.7b", "granite-20b", "mistral-nemo-12b")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_mode_runs_on_the_host(arch, capsys):
    """The reference's four lines, in its format, ending in ``serve OK``."""
    serve.main(["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "8", "--gen", "4",
                "--device", "cpu"])
    lines = capsys.readouterr().out.rstrip().splitlines()
    assert len(lines) == 4 and lines[-1] == "serve OK"
    assert lines[0] == "prompts [2, 8] -> generated (2, 4)"
    first = lines[1].split("first sequence: ", 1)[1]
    assert len(json.loads(first)) == 4  # a list of 4 ints
    assert re.fullmatch(r"prefill \d+\.\d\ds; decode \d+\.\d ms/token", lines[2])


def _reference_loop(jbundle, jparams, prompts, gen):
    """``repro/launch/serve.py``'s LM loop (its float32 cache, its jitted
    decode without donation, which the host does not take), returning the
    greedy tokens and the last logits."""
    decode = jax.jit(jbundle.decode)
    b, prompt_len = prompts.shape
    cache = jbundle.init_cache(b, prompt_len + gen, jnp.float32)
    prompts = jnp.asarray(prompts)
    for t in range(prompt_len):
        logits, cache = decode(jparams, cache, prompts[:, t:t + 1], jnp.asarray(t))
    generated = []
    tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    for t in range(prompt_len, prompt_len + gen):
        generated.append(tok)
        logits, cache = decode(jparams, cache, tok, jnp.asarray(t))
        tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    return np.asarray(jnp.concatenate(generated, axis=1)), np.asarray(logits)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_generate_gives_the_reference_loops_tokens(arch):
    """The same reduced weights (the reference's, carried across) and the
    CLI's prompts: equal greedy tokens, and the last logits within TOLS."""
    jcfg, cfg = jregistry.get(arch).reduced(), registry.get(arch).reduced()
    jb = jget_bundle(jcfg, chunked_attn=False)
    jp = jb.init(jax.random.PRNGKey(0))
    prompts = synthetic.lm_token_stream(cfg.vocab_size, 8, 2, seed=1)
    want_tokens, want_logits = _reference_loop(jb, jp, prompts, gen=6)
    params = interop.lm_params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    out = serve.generate(get_bundle(cfg), params, prompts, 6)
    assert out.tokens.dtype == torch.int32
    np.testing.assert_array_equal(out.tokens.numpy(), want_tokens)
    assert_close(out.logits, want_logits, what=f"{arch} last logits")
    assert out.prefill_s > 0 and out.decode_s > 0
