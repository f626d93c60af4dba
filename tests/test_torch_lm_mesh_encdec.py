"""The encoder-decoder family on the port's (data, model) mesh over gloo
ranks on the CPU, against the reference under ``compat.set_mesh`` on two
and four forced host devices and the port's one process
(tests/_torch_lm_mesh_families.py says how):

* whisper (4 heads) at data 1 x model 2: both self-attentions and the
  cross-attention head-parallel, the GELU MLPs column- then row-parallel
  with ``b_down`` added once;
* whisper with 6 heads of 64 at data 1 x model 4: the heads do not divide
  4, so the encoder's self-attention (32 frames, 8 a rank) runs the
  replicated route, the decoder's (64 tokens) the sequence-parallel one
  through B7/B8 with ``q_offset``, and the cross-attention gathers its
  split weights whole and runs alike on every rank.
"""
import pytest

import _torch_lm_mesh_cases as cases
import _torch_lm_mesh_families as families

GROUP = "encdec"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return families.launch(GROUP, tmp_path_factory.mktemp(f"lm_mesh_{GROUP}"))


@pytest.mark.parametrize("name", list(cases.family_cases(GROUP)))
def test_train_step_matches_reference_and_one_process(runs, name):
    families.check_case(runs, name)
