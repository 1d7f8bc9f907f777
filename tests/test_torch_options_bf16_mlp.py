"""The model options of test_torch_options*.py on the bf16 trunk against
the JAX package's bf16 trunk under jit (tests/torch_zoo.py:
check_option_bf16), second part: gnn_mlp_norm 'layer', prelu, and the
head's only_mrna_pred (multilevel_gnn_seq) and used_omics.

Readings (CPU, this fold) held at twice.  gnn_mlp_norm 'layer' and prelu
carry R4 (ROADMAP section 3): under jit XLA keeps the MLP's bf16 bias add
in f32 where a LayerNorm or prelu follows it, and computes the bf16
LayerNorm in f32; the port rounds each op as written, as JAX does op by op
(test_torch_convzoo.py holds GIN's MLP with both to JAX eager).  The small
differences then move the head's max-pool choices, hence the large head
gradient readings.
"""
import pytest

import torch_zoo as tz
from test_torch_slice import fold  # noqa: F401  (fixture)
from torch_threads import few_threads  # noqa: F401  (autouse)

READINGS = {
    "gnn_mlp_norm_layer": {
        "eval": {"prob": 6.71e-5, "loss": 9.48e-5, "image": 4.44e-3},
        "steps": 8.39e-4,
        "grad": {"conv_head.Conv_0.weight": 2.03e-1, "conv_head.Conv_1.weight": 2.23e-1,
                 "gnn_0.gconv.lin_r.weight": 2.81e-2,
                 "gnn_0.gconv.nn.Linear_0.bias": 1.95e-2,
                 "gnn_0.gconv.nn.Linear_0.weight": 2.90e-2,
                 "gnn_0.gconv.nn.Norm_0.bias": 2.33e-2,
                 "gnn_0.gconv.nn.Norm_0.scale": 1.97e-2,
                 "gnn_1.gconv.lin_r.weight": 1.10e-2,
                 "gnn_1.gconv.nn.Linear_0.bias": 1.65e-2,
                 "gnn_1.gconv.nn.Linear_0.weight": 1.38e-2,
                 "gnn_1.gconv.nn.Norm_0.bias": 5.51e-3,
                 "gnn_1.gconv.nn.Norm_0.scale": 3.91e-3,
                 "learnable_pca_params": 4.83e-2, "node_embedding": 3.46e-2}},
    "prelu": {
        "eval": {"image": 2.41e-4},
        "steps": 2.21e-4,
        "grad": {"conv_head.Conv_0.bias": 3.32e-1, "conv_head.Conv_0.weight": 1.69e-2,
                 "conv_head.Conv_1.weight": 5.73e-3,
                 "gnn_0.gconv.lin_r.weight": 6.49e-3,
                 "gnn_0.gconv.nn.Linear_0.bias": 6.94e-3,
                 "gnn_0.gconv.nn.Linear_0.weight": 5.26e-3,
                 "gnn_0.gconv.nn.prelu_1": 1.37e-3,
                 "gnn_1.gconv.lin_r.weight": 1.99e-3,
                 "gnn_1.gconv.nn.Linear_0.bias": 1.98e-3,
                 "learnable_pca_params": 1.15e-2, "node_embedding": 1.22e-2}},
    "multilevel_gnn_seq": {},
    "used_omics": {},
}


@pytest.mark.parametrize("option", list(READINGS))
def test_option_bf16_matches_jax_bf16(fold, option):  # noqa: F811
    # the head options leave the bf16 trunk as sage has it (its training:
    # test_torch_train.py), so they are held in eval
    train = option not in tz.HEAD_OPTIONS
    r = tz.run_pair(fold, True, train=train, **tz.option_kw(fold, option))
    tz.check_option_bf16(r, READINGS[option], train)
