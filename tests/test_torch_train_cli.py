"""repro_torch.launch.train against repro.launch.train.

* A reduced qwen3-1.7b run on the host (``--device cpu``) prints the
  reference CLI's lines: ``step ... loss ... (s/step)`` at the logged
  steps, ``checkpoint written to ...`` and ``loss a -> b (improved|NOT
  improved)``, in the reference's formats; its losses are finite and the
  first is within 1.0 of ln V.
* Its ``--ckpt`` is in the reference's layout: ``repro.train.checkpoint
  .restore`` reads it back with every leaf equal to the trained
  parameters.
* ``--model-parallel 2`` (item 12's model-zoo part, done) trains an arch
  of every family on two gloo ranks that the CLI starts on the host, and
  prints the reference's lines from rank 0.  The vlm, moe and encdec
  families (item 14, done) and the ssm and hybrid families (item 16, done)
  train a reduced model on the host.
"""
import re

import jax
import numpy as np
import pytest
from torch.utils import _pytree as pytree

from repro.train import checkpoint as jck
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.train import checkpoint as tck

STEP = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})  \((\d+\.\d{2}) s/step\)$")
LOSS = re.compile(r"^loss (\d+\.\d{4}) -> (\d+\.\d{4}) \((improved|NOT improved)\)$")
REDUCED = ["--reduced", "--batch", "2", "--seq", "32", "--device", "cpu"]


def test_reduced_run_prints_the_references_lines_and_checkpoints(tmp_path, capsys,
                                                                 monkeypatch):
    saved = {}
    real_save = tck.save

    def recording_save(path, tree, step=None):
        saved["tree"] = pytree.tree_map(lambda t: t.detach().cpu().numpy(), tree)
        return real_save(path, tree, step=step)

    monkeypatch.setattr(tck, "save", recording_save)
    train.main(["--arch", "qwen3-1.7b", *REDUCED, "--steps", "6", "--microbatches", "2",
                "--ckpt", str(tmp_path / "ckpt")])
    lines = capsys.readouterr().out.strip().splitlines()
    steps = [STEP.match(ln) for ln in lines[:-2]]
    assert all(steps), lines
    assert [int(m.group(1)) for m in steps] == [0, 5]  # --log-every 5 and the last step
    losses = [float(m.group(2)) for m in steps]
    vocab = registry.get("qwen3-1.7b").reduced().vocab_size
    assert np.all(np.isfinite(losses)) and abs(losses[0] - np.log(vocab)) <= 1.0, losses
    assert lines[-2] == f"checkpoint written to {tmp_path / 'ckpt' / 'step_6'}"
    assert LOSS.match(lines[-1]), lines[-1]

    want = saved["tree"]
    got = jck.restore(str(tmp_path / "ckpt" / "step_6"), want)
    want_leaves, got_leaves = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(got_leaves) == len(want_leaves) == len(tck.flatten(want)) > 0
    for a, b in zip(got_leaves, want_leaves, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_bfloat16_parameters(capsys):
    train.main(["--arch", "qwen3-1.7b", *REDUCED, "--steps", "2", "--dtype", "bfloat16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert all(STEP.match(ln) for ln in lines[:-1]) and LOSS.match(lines[-1]), lines


@pytest.mark.parametrize("arch,argv,item", [
    ("qwen3-1.7b", ["--model-parallel", "2"], 12),
    ("internvl2-2b", [], 14),
    ("qwen2-moe-a2.7b", [], 14),
    ("whisper-tiny", [], 14),
    ("mamba2-780m", [], 16),
    ("recurrentgemma-9b", [], 16),
    ("internvl2-2b", ["--model-parallel", "2"], 12),
    ("qwen2-moe-a2.7b", ["--model-parallel", "2"], 12),
    ("mamba2-780m", ["--model-parallel", "2"], 12),
    ("recurrentgemma-9b", ["--model-parallel", "2"], 12),
    ("whisper-tiny", ["--model-parallel", "2"], 12),
])
def test_what_waits_names_its_item(arch, argv, item, capsys):
    """Items 12, 14 and 16 are done: the vlm, moe and encdec families and
    the ssm and hybrid families train a step in two microbatches (the
    patches and frames split with the tokens), in one process and, with
    ``--model-parallel 2``, on two host ranks (a (1, 2) mesh, the CLI's own
    rank processes): a finite first loss within 1.0 of ln V, in the
    reference's lines."""
    argv = ["--arch", arch, *REDUCED, "--steps", "1", *argv]
    train.main(argv + ["--microbatches", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    step = STEP.match(lines[0])
    assert step and LOSS.match(lines[-1]) and len(lines) == 2, lines
    vocab = registry.get(arch).reduced().vocab_size
    assert abs(float(step.group(2)) - np.log(vocab)) <= 1.0, lines


def test_model_parallel_on_the_card_needs_its_cards(monkeypatch):
    """On the card each rank takes a card under NCCL: fewer cards than the
    mesh needs exits naming the count, before any rank starts."""
    monkeypatch.setattr(train.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs a multiple of 2 cards.*; 1 present"):
        train.main(["--arch", "qwen3-1.7b", "--reduced", "--model-parallel", "2"])


def test_argument_errors():
    with pytest.raises(SystemExit) as exc:
        train.main(["--arch", "gpt5"])
    assert exc.value.code == 2
    with pytest.raises(SystemExit) as exc:
        train.main(["--arch", "qwen3-1.7b", "--dtype", "float16"])
    assert exc.value.code == 2
