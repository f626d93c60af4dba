"""The ssm and hybrid families on the port's (data, model) mesh over gloo
ranks on the CPU, against the reference under ``compat.set_mesh`` on four
forced host devices and the port's one process
(tests/_torch_lm_mesh_families.py says how):

* mamba2 at data 2 x model 2: the SSD heads over ``model`` (B10 and its
  backward on a rank's heads, B and C shared), the gated RMSNorm's mean
  square summed over ``model``, ``out_proj`` row-parallel, FSDP on
  ``in_proj`` and ``out_proj``;
* recurrentgemma (one (rec, rec, attn) period) at data 1 x model 4: the
  RG-LRU width over ``model`` (B9 and its backward on a rank's lanes), the
  gate pre-activations summed over ``model`` from the row-parallel ``w_r``
  and ``w_i``, the MQA block's head-parallel route with its one KV head
  gathered.
"""
import pytest

import _torch_lm_mesh_cases as cases
import _torch_lm_mesh_families as families

GROUP = "recurrent"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return families.launch(GROUP, tmp_path_factory.mktemp(f"lm_mesh_{GROUP}"))


@pytest.mark.parametrize("name", list(cases.family_cases(GROUP)))
def test_train_step_matches_reference_and_one_process(runs, name):
    families.check_case(runs, name)
