"""The vlm and moe families on the port's (data, model) mesh over gloo
ranks on the CPU, against the reference under ``compat.set_mesh`` on four
forced host devices and the port's one process
(tests/_torch_lm_mesh_families.py says how):

* internvl2 at data 2 x model 2, two microbatches: the dense layout with
  the projected patch prefix, the projector's column-parallel ``w1`` and
  ``w2``, the patches split with the tokens, FSDP on the layer leaves;
* qwen2-moe at data 1 x model 4 (expert-parallel: one of its 4 experts a
  rank) and at data 2 x model 2 (two experts a rank, FSDP on the expert
  stacks), its shared expert column- then row-parallel;
* qwen2-moe with 6 experts at data 1 x model 4: 6 does not divide 4, so
  each expert's width is split (tensor parallelism inside the experts);
* deepseek-v2 at data 1 x model 4: MLA's heads over ``model`` (B7/B8 at
  its q/k and v head sizes), its latent projections whole, the dense first
  layer and the MoE layer.

The MoE dispatch masks are compared bit for bit before the steps.  And
``moe_lm.forward``'s ``seq_shard`` (the reference's layout hint, also read
from ``$REPRO_SEQ_SHARD``) changes no bit of the port's forward.
"""
import numpy as np
import pytest
import torch

import _torch_lm_mesh_cases as cases
import _torch_lm_mesh_families as families
from repro_torch.configs import registry
from repro_torch.models import get_bundle, moe_lm

GROUP = "vlm_moe"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return families.launch(GROUP, tmp_path_factory.mktemp(f"lm_mesh_{GROUP}"))


@pytest.mark.parametrize("name", list(cases.family_cases(GROUP)))
def test_train_step_matches_reference_and_one_process(runs, name):
    families.check_case(runs, name)


def test_seq_shard_moves_no_number(monkeypatch):
    cfg = registry.get("qwen2-moe-a2.7b").reduced()
    params = get_bundle(cfg).init(0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 32)))
    with torch.no_grad():
        want = moe_lm.forward(params, cfg, tokens, seq_shard=False)
        got = [moe_lm.forward(params, cfg, tokens, seq_shard=True)]
        monkeypatch.setenv("REPRO_SEQ_SHARD", "1")
        got.append(moe_lm.forward(params, cfg, tokens))
    for h, aux in got:
        assert torch.equal(h, want[0]) and torch.equal(aux, want[1])
