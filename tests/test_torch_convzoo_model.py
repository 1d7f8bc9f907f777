"""MultilevelGNN with gnn_name gat, gcn and gin (the Config's default conv
and the two others the port lacked) against the JAX package, on the small
windowed fold of test_torch_slice.py (K2 + the K1 residual for GCN / GIN,
K1 for GAT's edge sums and every gather's backward), from the same flax
parameters (tests/torch_zoo.py).

- eval: probabilities, eval_step loss (three batches, the last padded) and
  the pathway image within 1e-5 x max(1, max|ref|), f32 and bf16 trunks
  (in f32 GAT with a string gnn_last_norm and GIN with it and prelu: the
  gin and gat cases test_torch_slice.py once held to NotImplementedError);
- training (dropout off): five train steps' losses and the first step's
  gradients; f32 within 1e-5, and the parameters after five steps as
  test_torch_train.py holds them; bf16 against JAX's bf16 under jit (F4):
  losses 1e-4, gradients 1e-3 of each parameter's largest.

Residues (ROADMAP section 3), held at twice their reading: GIN's bf16 MLP
biases (F3 residue 1); GCN's bf16 trunk under jit (R4: XLA keeps its
agg + xw * dinv**2 partly in f32; the port equals JAX op by op,
test_torch_convzoo.py), which reaches the image, the head's max-pool
choices and so the step's gradients.
"""
import pytest

import torch_zoo as tz
from test_torch_slice import fold  # noqa: F401  (fixture)
from torch_threads import few_threads  # noqa: F401  (autouse)

CONVS = {"gat": dict(gnn_name="gat", final_head=4), "gcn": dict(gnn_name="gcn"),
         "gin": dict(gnn_name="gin")}
# f32: test_torch_slice.py's former NotImplementedError cases gin and gat,
# each with a second option on (GIN's MLP norm and prelu, GAT's Norm)
F32 = {"gat": dict(CONVS["gat"], gnn_last_norm="layer"), "gcn": CONVS["gcn"],
       "gin": dict(CONVS["gin"], gnn_last_norm="layer", gnn_act="prelu")}
# bf16 readings against JAX jit on this fold, held at twice
IMAGE_RESIDUE = {"gcn": 4e-5}                 # R4, read 1.91e-5
LOSS_RESIDUE = {"gcn": 2e-3}                  # R4, read 9.53e-4
GRAD_RESIDUE = {
    "gin": {"gnn_0.gconv.nn.Linear_0.bias": 1.7e-2,   # F3 residue 1, read 8.16e-3
            "gnn_1.gconv.nn.Linear_0.bias": 1.1e-2},  # read 5.38e-3
    "gcn": {"conv_head.Conv_0.weight": 8.5e-2,        # R4, read 4.20e-2
            "conv_head.Conv_1.weight": 1.3e-1,        # read 6.30e-2
            "gnn_0.gconv.lin.weight": 1.1e-2,         # read 5.24e-3
            "gnn_1.gconv.lin.weight": 8.2e-3,         # read 4.07e-3
            "node_embedding": 8.5e-3,                 # read 4.25e-3
            "learnable_pca_params": 2.9e-3},          # read 1.44e-3
}


@pytest.fixture(scope="module")
def runs(fold):  # noqa: F811
    cache = {}

    def get(conv, bf16):
        if (conv, bf16) not in cache:
            cache[(conv, bf16)] = tz.run_pair(fold, bf16, **(CONVS if bf16 else F32)[conv])
        return cache[(conv, bf16)]

    return get


@pytest.mark.parametrize("conv", CONVS)
def test_model_eval_f32_matches_jax(runs, conv):
    r = runs(conv, False)
    tz.check_eval(r, 1e-5)
    m = r["model"]
    cls = {"gat": "GATConv", "gcn": "GCNConv", "gin": "GINConv"}[conv]
    assert m.gnn_1.gconv.__class__.__name__ == cls
    if conv == "gat":  # final_head 4 heads on the last layer, 8 on the others
        assert (m.gnn_0.gconv.heads, m.gnn_1.gconv.heads) == (8, 4)
        assert m.gnn_1.gconv.Norm_0 is not None
    if conv == "gin":
        assert hasattr(m.gnn_0.gconv.nn, "prelu_1") and hasattr(m.gnn_1.gconv.nn, "Norm_0")


@pytest.mark.parametrize("conv", CONVS)
def test_model_train_f32_matches_jax(runs, conv):
    tz.check_train_f32(runs(conv, False))


@pytest.mark.parametrize("conv", CONVS)
def test_model_eval_bf16_matches_jax_bf16(runs, conv):
    r = runs(conv, True)
    assert tz.rel_err(r["pp"], r["jp"]) <= 1e-5 and tz.rel_err(r["pl"], r["jl"]) <= 1e-5
    assert tz.rel_err(r["pimg"], r["jimg"]) <= IMAGE_RESIDUE.get(conv, 1e-5)


@pytest.mark.parametrize("conv", CONVS)
def test_model_train_bf16_matches_jax_bf16(runs, conv):
    r = runs(conv, True)
    tz.check_train_bf16(r, GRAD_RESIDUE.get(conv), LOSS_RESIDUE.get(conv, 1e-4))
