"""Every family of the port's zoo on a ``("data", "model")`` mesh of (2, 2)
gloo ranks on the CPU under ``launch.cells.build_cell``'s placements (FSDP
where ``RUN_HINTS`` turn it on, heads, mlp, vocab and experts over
``"model"``), against the port's single device: one forward and backward
of the LM loss at each config's reduced size in float32, the MoE families
with ``moe_impl="auto"`` (expert parallel). The loss at rtol 1e-5 and every
gradient within 1e-5 of its leaf's largest magnitude (float32's order of
summation across the ranks: at most 4.8e-6 seen, xlstm). The ranks are
spawned once for the file (``tests/_torch_fsdp_ranks.py``'s
``zoo_body``); no JAX runs here: the parity with the reference is
``tests/test_torch_fsdp.py``'s.
"""
import numpy as np
import pytest

import _torch_fsdp_ranks as F
import _torch_mesh_ranks as R
from repro_torch.configs.registry import ARCHS

WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.run_ranks(F.zoo_body, WORLD,
                       str(tmp_path_factory.mktemp("fsdp_zoo")),
                       timeout_s=240)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_mesh_step_of_every_family_equals_one_device(runs, arch):
    for res in runs:
        single, mesh, errs = res[arch]
        np.testing.assert_allclose(mesh, single, rtol=1e-5)
        bad = {p: e for p, e in errs.items() if not e <= 1e-5}
        assert not bad, (arch, bad)
