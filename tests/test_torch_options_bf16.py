"""The model options of test_torch_options*.py on the bf16 trunk against
the JAX package's bf16 trunk under jit (tests/torch_zoo.py:
check_option_bf16), first part: resgnn, dense_gnn, repeat_mask (with
repeat_norm) and the head's pca_prelinear.

The readings below (CPU, this fold) are held at twice; each is a residue of
ROADMAP section 3: R4, XLA's dropped bf16 roundings under jit (resgnn's
residual adds the trunk input's cotangents in f32; repeat_norm's division
and the mask; the MLP's bias add before a prelu or a LayerNorm), and F3
residue 1 (the MLP biases).
"""
import pytest

import torch_zoo as tz
from test_torch_slice import fold  # noqa: F401  (fixture)
from torch_threads import few_threads  # noqa: F401  (autouse)

READINGS = {
    "resgnn": {"grad": {"gnn_0.gconv.nn.Linear_0.bias": 1.25e-2,
                        "node_embedding": 3.87e-3}},
    "dense_gnn": {"grad": {"gnn_0.gconv.nn.Linear_0.bias": 2.17e-2}},
    "repeat_mask": {"steps": 6.69e-4,
                    "grad": {"gnn_0.gconv.lin_r.weight": 4.98e-3,
                             "gnn_0.gconv.nn.Linear_0.bias": 8.40e-3,
                             "gnn_0.gconv.nn.Linear_0.weight": 1.74e-3,
                             "gnn_1.gconv.nn.Linear_0.bias": 6.21e-3,
                             "node_embedding": 6.05e-3}},
    "pca_prelinear": {},
}


@pytest.mark.parametrize("option", list(READINGS))
def test_option_bf16_matches_jax_bf16(fold, option):  # noqa: F811
    # the head options leave the bf16 trunk as sage has it (its training:
    # test_torch_train.py), so they are held in eval
    train = option not in tz.HEAD_OPTIONS
    r = tz.run_pair(fold, True, train=train, **tz.option_kw(fold, option))
    tz.check_option_bf16(r, READINGS[option], train)
