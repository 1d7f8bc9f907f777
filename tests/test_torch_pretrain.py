"""The pretraining workflow in the port against the JAX package, on the CPU
(f32, dropout off), on reference-format files loaded by both packages
(test_torch_experiment.build_setup) at small widths (decoder_dim 16):

- Cohort.gene_std_value equals JAX's;
- pretrain_autoencoder, 2 epochs over all patients, for the autoencoder
  (flatten) and the VQ-VAE, from JAX's initial parameters: each epoch's
  mean loss, and every parameter after the last step (plain Adam), within
  1e-5 x max(1, max|ref|);
- transfer_pretrained into a MultilevelGNN: the same keys copied as JAX's
  transfer, the values equal;
- the train CLI with --pretrain autoencoder --pretrain-epochs 1 (2 epochs
  of the protocol) against JAX's run_experiment(pretrain='autoencoder'),
  every fold starting from JAX's parameters: every fold's test scores
  within 1e-5, pooled AUC / ACC equal.
(One VAE step with JAX's draws: test_torch_vae.py.)
"""
import json

import numpy as np
import pytest
import torch

from multilevel_gnn_tpu.models.multilevel_gnn import MultilevelGNN as JModel
from multilevel_gnn_tpu.train import pretrain as jpretrain
from multilevel_gnn_tpu.train.driver import iter_batches as j_iter_batches
from multilevel_gnn_tpu_torch.interop import load_flax_params, state_dict_from_flax
from multilevel_gnn_tpu_torch.models.multilevel_gnn import MultilevelGNN
from multilevel_gnn_tpu_torch.train import cli, pretrain
from test_torch_experiment import GBM, KW, build_setup
from torch_families import experiments_match, flat, rel_err
from torch_threads import few_threads  # noqa: F401  (autouse)

PRE = dict(decoder_dim=16, epochs=2)


class PretrainCarrier:
    """Records JAX's pretraining runs (build_pretrain's initial, PCA-seeded
    parameters and each step's loss) and starts the port's pretraining
    models from those parameters, in the same order."""

    def __init__(self, monkeypatch):
        self.params, self.losses = [], []
        real = jpretrain.build_pretrain

        def spy(*a, **k):
            s = real(*a, **k)
            self.params.append(flat(s["params"]))
            step = s["step"]

            def recorded(*args):
                out = step(*args)
                self.losses.append(float(out[2]))
                return out

            s["step"] = recorded
            return s

        monkeypatch.setattr(jpretrain, "build_pretrain", spy)
        monkeypatch.setattr(pretrain, "new_pretrain_model", self.new_model)

    def new_model(self, kind, cfg, ctx, seed):
        m = pretrain.KINDS[kind](cfg, ctx.graph.n_nodes, ctx.num_pca_rows, device=ctx.device)
        load_flax_params(m, self.params.pop(0))
        return m


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return build_setup(str(tmp_path_factory.mktemp("cohort")))


def test_gene_std_value_matches_jax(setup):
    np.testing.assert_array_equal(setup["cohort"].gene_std_value,
                                  setup["jcohort"].gene_std_value)


@pytest.fixture(scope="module")
def pretrained(setup):
    """Both packages' 2-epoch pretraining of each kind."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for kind in ("autoencoder", "vq_vae"):
            carrier = PretrainCarrier(mp)
            jparams, _, _, _ = jpretrain.pretrain_autoencoder(
                setup["jcohort"].cfg.replace(**PRE), setup["jcohort"], kind)
            steps = list(carrier.losses)
            model, _, _, losses = pretrain.pretrain_autoencoder(
                setup["cfg"].replace(**PRE), setup["cohort"], kind, device="cpu")
            assert not carrier.params
            out[kind] = dict(jparams=jparams, jsteps=steps, model=model, losses=losses)
            mp.undo()
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("kind", ["autoencoder", "vq_vae"])
def test_pretrain_matches_jax(pretrained, setup, kind):
    r = pretrained[kind]
    n_steps = len(setup["cohort"].patients) // KW["batch_size"]
    assert len(r["jsteps"]) == 2 * n_steps and len(r["losses"]) == 2
    jmeans = [float(np.mean(r["jsteps"][e * n_steps:(e + 1) * n_steps])) for e in range(2)]
    for a, b in zip(r["losses"], jmeans):
        assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), (r["losses"], jmeans)
    ref = state_dict_from_flax(flat(r["jparams"]))
    own = r["model"].state_dict()
    assert set(ref) == set(own)
    for n, v in ref.items():
        assert rel_err(own[n].numpy(), v.numpy()) <= 1e-5, n
    assert np.isfinite(r["losses"]).all() and r["losses"][1] != r["losses"][0]


def test_transfer_matches_jax(pretrained, setup):
    """The AE's parameters into a fresh MultilevelGNN: JAX's
    transfer_pretrained and the port's copy the same keys, equal values."""
    import jax

    jc = setup["jcohort"]
    cfg = jc.cfg.replace(**PRE, pathway_num=jc.n_pathways, node_num=jc.num_nodes // 3)
    fold = jc.fold(np.arange(len(jc.patients)), 0)
    b0 = next(j_iter_batches(jc.X, jc.Y, jc.ages, np.arange(8), 8,
                             np.random.RandomState(0), False, False))
    params = JModel(cfg).init(jax.random.PRNGKey(3), b0, fold.ctx, False)
    jout = state_dict_from_flax(flat(jpretrain.transfer_pretrained(
        pretrained["autoencoder"]["jparams"], params)))
    pctx = setup["cohort"].fold(np.arange(len(jc.patients)), 0, device="cpu").ctx
    m = MultilevelGNN(setup["cfg"].replace(**PRE, pathway_num=jc.n_pathways,
                                           node_num=jc.num_nodes // 3),
                      pctx.graph.n_nodes, pctx.num_pca_rows, device="cpu")
    load_flax_params(m, flat(params))
    before = {k: v.clone() for k, v in m.state_dict().items()}
    ae = {k: torch.from_numpy(v.numpy()) for k, v in
          state_dict_from_flax(flat(pretrained["autoencoder"]["jparams"])).items()}
    n = pretrain.transfer_pretrained(ae, m)
    after = m.state_dict()
    copied = {k for k in after if not torch.equal(after[k], before[k])}
    assert n == len([k for k in after if k in ae and ae[k].shape == after[k].shape])
    assert copied and all(not k.startswith("conv_head") for k in copied)
    assert {"node_embedding", "learnable_pca_params"} <= copied
    for k, v in jout.items():
        np.testing.assert_array_equal(after[k].numpy(), v.numpy())


def test_cli_pretrain_protocol_matches_jax(setup, monkeypatch, capsys):
    """JAX's run_experiment(pretrain='autoencoder') and the port's train
    CLI with --pretrain (on the same loaded cohort): the pretraining and
    every fold start from JAX's parameters."""
    PretrainCarrier(monkeypatch)
    sets = [f"{k}={json.dumps(v)}" for k, v in {**KW, **PRE}.items() if k != "epoch_scan"]
    monkeypatch.setattr(cli, "make_cohort", lambda *a, **k: setup["cohort"])
    _, jout = experiments_match(
        setup["jcohort"], setup["cohort"], None, monkeypatch,
        jcfg=setup["jcohort"].cfg.replace(**PRE), pretrain="autoencoder", pretrain_epochs=1,
        port_run=lambda: cli.main(["--config", GBM, "--data-dir", setup["dir"], "--device",
                                   "cpu", "--pretrain", "autoencoder", "--pretrain-epochs",
                                   "1", "--set", *sets]))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["pretrain"] == "autoencoder" and line["pooled_auc"] == jout["auc"][2]
