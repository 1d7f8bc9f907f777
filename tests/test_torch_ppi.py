"""The cohort's other graph sources and preprocessing options, port against
the JAX package on the CPU.

- STRING PPI tables (parse_ppi_edges), the GRNBoost2 list and
  pretain_only_pathway_edge: the entrez-keyed edge dicts equal JAX's on
  written files, with KEGG ids below and at or past len(kegg) (the
  Series-index quirk of in_same_pathway) and a pathway outside the list;
  the merge cohort's two edge sets through load_cohort_from_files.
- the .xlsx pathway list: the first column of the first sheet of a
  workbook built here by hand (shared, inline and rich strings, numbers,
  an empty row, an NA string); against pd.read_excel where openpyxl
  imports.
- a clinical file pickled as a pandas DataFrame (pandas' own to_pickle,
  string and object indexes), read in a process where pandas and pyarrow
  cannot be imported.
- content_key equals JAX's; a mask JAX's use_cache wrote is what the port
  reads, without running its estimator.
- kraskov_mi against JAX's (cKDTree, scipy digamma) on seeded draws with
  ties, 1e-12 relative.
- edge_select's edges equal JAX's, freeze_mutual_select_init on, with
  knn_mutual_info on and off.
"""
import json
import os
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from multilevel_gnn_tpu.core.config import Config as JConfig
from multilevel_gnn_tpu.data import cache as jcache
from multilevel_gnn_tpu.data import loaders as jloaders
from multilevel_gnn_tpu.utils.knnie import kraskov_mi as jkraskov
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data import cache, loaders, native
from multilevel_gnn_tpu_torch.data.synthetic import write_reference_format, write_string_ppi
from multilevel_gnn_tpu_torch.utils.knnie import kraskov_mi
from torch_threads import child_env, few_threads  # noqa: F401  (few_threads: autouse)

REPO = Path(__file__).resolve().parents[1]
GBM = str(REPO / "configs" / "gbm.yaml")
SMALL = dict(num_run=1, epochs=2, batch_size=8, node_embedding_dim=4, hidden_channels=8,
             final_channels=4, head_dim=16, conv_channel_list=[8, 16])


def _small_kegg(d):
    """A KEGG table whose entrez ids are partly below len(kegg) (30 rows),
    partly past it, four pathways of which the list names three; STRING
    tables and a GRN list with random pairs over its symbols."""
    rng = np.random.RandomState(5)
    rows = []
    for p, genes in (("hsaA", range(1, 9)), ("hsaB", range(6, 14)),
                     ("hsaC", [12, 13, 14, 40, 41, 42, 2]), ("hsaD", [15, 16, 5, 40, 50, 51, 52])):
        rows += [(p, f"S{g}", g) for g in genes]
    pd.DataFrame(rows, columns=["PathwayID", "Symbol", "Entrezid"]).to_csv(
        f"{d}/kegg.csv", index=False)
    assert len(rows) == 30
    with open(f"{d}/pathways.txt", "w") as f:
        f.write("hsaA\nhsaB\nhsaC\n")
    syms = sorted({r[1] for r in rows}) + ["NOTKEGG"]
    pairs = [(syms[a], syms[b]) for a, b in rng.randint(0, len(syms), (300, 2))]
    with open(f"{d}/grn.tsv", "w") as f:
        f.write("TF\ttarget\timportance\n")
        for (a, b), w in zip(pairs, rng.rand(300)):
            f.write(f"{a}\t{b}\t{0.0 if w < 0.05 else float(w)!r}\n")
    ids = {s: f"9606.ENSP{i:05d}" for i, s in enumerate(syms)}
    nodes = pd.DataFrame({"@id": ["stringdb:" + ids[s] for s in syms],
                          "query term": syms,
                          "node type": ["protein"] * (len(syms) - 1) + ["compound"]})
    nodes.to_csv(f"{d}/node.csv", index=False)
    score = np.round(rng.rand(300), 3)
    score[rng.rand(300) < 0.05] = np.nan
    kind = np.where(rng.rand(300) < 0.05, "(cc)", "(pp)")
    pd.DataFrame({"name": [f"{ids[a]} {k} {ids[b]}" for (a, b), k in zip(pairs, kind)],
                  "stringdb::score": score}).to_csv(f"{d}/edges.csv", index=False)


@pytest.mark.parametrize("kw", [
    dict(edge_type="ppi"),
    dict(edge_type="ppi", use_column=None),
    dict(edge_type="ppi", pretain_only_pathway_edge=True),
    dict(edge_type="grnboost2", pretain_only_pathway_edge=True),
    dict(edge_type="grnboost2", pretain_only_pathway_edge=True, use_column=None),
], ids=["ppi", "ppi_no_use_column", "ppi_pathway_only", "grn_pathway_only",
        "grn_pathway_only_no_use_column"])
def test_edge_dicts_equal_jax(tmp_path, kw):
    d = str(tmp_path)
    _small_kegg(d)
    cfg, jcfg = Config.from_yaml(GBM, **kw), JConfig.from_yaml(GBM, **kw)
    kegg, jkegg = loaders.read_kegg_csv(f"{d}/kegg.csv"), pd.read_csv(f"{d}/kegg.csv")
    pw = loaders.load_pathway_list(f"{d}/pathways.txt")
    if kw["edge_type"] == "ppi":
        got = loaders.parse_ppi_edges(f"{d}/node.csv", f"{d}/edges.csv", kegg, cfg, pw)
        want = jloaders.parse_ppi_edges(f"{d}/node.csv", f"{d}/edges.csv", jkegg, jcfg, pw)
    else:
        got = loaders.parse_grnboost2_edges(f"{d}/grn.tsv", kegg, cfg, pw)
        want = jloaders.parse_grnboost2_edges(f"{d}/grn.tsv", jkegg, jcfg, pw)
    assert got == want
    n = sum(map(len, got[0].values()))
    assert n > 10
    if kw.get("pretain_only_pathway_edge"):
        # ids at or past len(kegg) (40 ...) never pass, ids below it do
        assert all(s < 30 and d_ < 30 for lst in got[0].values() for s, d_ in lst)
    for s, d_ in [(1, 2), (2, 40), (12, 14), (15, 16), (5, 15)]:
        assert loaders.in_same_pathway(s, d_, kegg, pw) == jloaders.in_same_pathway(
            s, d_, jkegg, pw), (s, d_)
    assert loaders.in_same_pathway(1, 2, kegg, pw)
    # 15 and 16 share only hsaD, which the list does not name; 40 is past
    # len(kegg), though 2 and 40 share hsaC
    assert not loaders.in_same_pathway(15, 16, kegg, pw)
    assert not loaders.in_same_pathway(2, 40, kegg, pw)


@pytest.fixture(scope="module")
def merge_files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("merge"))
    write_reference_format(d, seed=4, cancer_type="gbm", n_patients=60, n_pathways=5)
    write_string_ppi(d, loaders.read_kegg_csv(f"{d}/kegg.csv"), seed=1, e_ppi=600,
                     cancer_type="gbm")
    return d


def merge_paths(d, ct="gbm"):
    return dict(
        mrna_path=f"{d}/{ct}/raw_mrna.csv", cnv_path=f"{d}/{ct}/raw_cnv.csv",
        methylation_path=f"{d}/{ct}/raw_methylation.csv",
        clinical_path=f"{d}/{ct}/clinical.pkl", kegg_path=f"{d}/kegg.csv",
        pathway_list_path=f"{d}/pathways.txt", edge_path=f"{d}/{ct}/ppi_edges.csv",
        ppi_node_path=f"{d}/node.csv", grn_edge_path=f"{d}/{ct}/grn_edges.tsv")


def test_merge_cohort_edge_sets_equal_jax(merge_files):
    cfg = Config.from_yaml(GBM, edge_type="merge", **SMALL)
    jcfg = JConfig.from_yaml(GBM, edge_type="merge", **SMALL)
    c = loaders.load_cohort_from_files(cfg=cfg, **merge_paths(merge_files))
    j = jloaders.load_cohort_from_files(cfg=jcfg, **merge_paths(merge_files))
    assert (c.edges, c.edge_attrs) == (j.edges, j.edge_attrs)
    assert (c.edges2, c.edge_attrs2) == (j.edges2, j.edge_attrs2)
    assert c.edges2 and c.edges != c.edges2
    g, jg = c.merge_graph2("cpu"), j.merge_graph2()
    np.testing.assert_array_equal(np.asarray(jg.senders), g.senders.numpy())
    np.testing.assert_array_equal(np.asarray(jg.receivers), g.receivers.numpy())
    np.testing.assert_array_equal(np.asarray(jg.edge_mask), g.edge_mask.numpy())
    np.testing.assert_array_equal(np.asarray(jg.edge_attr), g.edge_attr.numpy())


# ---- .xlsx pathway lists

_NS = 'xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main"'
_R = 'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships"'


def _write_xlsx(path):
    """Two sheets; the first (in workbook order) is worksheets/sheet2.xml
    through its relationship.  Column A: shared strings, a rich-text
    string, an inline string, an integral number, a float, an empty row, an
    NA string; column B: noise."""
    rels = ('<?xml version="1.0"?><Relationships xmlns="http://schemas.openxmlformats.org/'
            'package/2006/relationships">'
            '<Relationship Id="rId1" Type="t" Target="worksheets/sheet1.xml"/>'
            '<Relationship Id="rId2" Type="t" Target="/xl/worksheets/sheet2.xml"/>'
            '</Relationships>')
    book = (f'<?xml version="1.0"?><workbook {_NS} {_R}><sheets>'
            '<sheet name="pathways" sheetId="2" r:id="rId2"/>'
            '<sheet name="other" sheetId="1" r:id="rId1"/></sheets></workbook>')
    sst = (f'<?xml version="1.0"?><sst {_NS}><si><t>hsa04010</t></si><si><t>hsa04151</t></si>'
           '<si><r><t>hsa0</t></r><r><t>5200</t></r></si><si><t>x</t></si><si><t>NA</t></si></sst>')
    cells = [
        '<row r="1"><c r="A1" t="s"><v>0</v></c><c r="B1" t="s"><v>3</v></c></row>',
        '<row r="2"><c r="A2" t="s"><v>1</v></c></row>',
        '<row r="3"><c r="A3" t="s"><v>2</v></c></row>',
        '<row r="4"><c r="A4" t="inlineStr"><is><t>hsa04630</t></is></c></row>',
        '<row r="5"><c r="A5"><v>42</v></c></row>',
        '<row r="6"><c r="A6"><v>2.5</v></c></row>',
        '<row r="8"><c r="B8" t="s"><v>3</v></c></row>',
        '<row r="9"><c r="A9" t="s"><v>4</v></c></row>',
        '<row r="10"><c r="A10" t="s"><v>0</v></c></row>',
    ]
    sheet2 = f'<?xml version="1.0"?><worksheet {_NS}><sheetData>{"".join(cells)}</sheetData></worksheet>'
    sheet1 = (f'<?xml version="1.0"?><worksheet {_NS}><sheetData><row r="1"><c r="A1" t="s">'
              '<v>3</v></c></row></sheetData></worksheet>')
    types = ('<?xml version="1.0"?><Types xmlns="http://schemas.openxmlformats.org/package/'
             '2006/content-types"><Default Extension="xml" ContentType="application/xml"/>'
             '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-'
             'officedocument.spreadsheetml.sheet.main+xml"/></Types>')
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("[Content_Types].xml", types)
        z.writestr("xl/workbook.xml", book)
        z.writestr("xl/_rels/workbook.xml.rels", rels)
        z.writestr("xl/sharedStrings.xml", sst)
        z.writestr("xl/worksheets/sheet1.xml", sheet1)
        z.writestr("xl/worksheets/sheet2.xml", sheet2)


def test_xlsx_pathway_list(tmp_path):
    path = str(tmp_path / "ordered.xlsx")
    _write_xlsx(path)
    got = loaders.load_pathway_list(path)
    want = ["hsa04010", "hsa04151", "hsa05200", "hsa04630", 42, 2.5, np.nan, np.nan,
            np.nan, "hsa04010"]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a != a and b != b) or (a == b and type(a) is type(b)), (a, b)
    try:
        import openpyxl  # noqa: F401
    except ImportError:
        return
    ref = pd.read_excel(path, header=None)[0].tolist()
    assert len(got) == len(ref)
    assert all((a != a and b != b) or a == b for a, b in zip(got, ref))


# ---- the clinical DataFrame pickle

_READ = r"""
import json, sys
for name in ("pandas", "pyarrow", "sklearn"):
    sys.modules[name] = None
from multilevel_gnn_tpu_torch.data.loaders import load_clinical
clin = load_clinical(sys.argv[1])
print(json.dumps({k: {p: (None if v != v else v) for p, v in d.items()} for k, d in clin.items()}))
"""


@pytest.mark.parametrize("index_dtype", ["str", "object"])
def test_clinical_dataframe_pickle_without_pandas(tmp_path, index_dtype):
    patients = [f"TCGA-{i:02d}" for i in range(7)]
    df = pd.DataFrame(
        {"survive_time": [10.5, 20.0, 3.25, 40.0, 1.0, 99.5, 7.0],
         "survive_state": [1, 0, 1, 1, 0, 0, 1],
         "age": [50.0, np.nan, 61.5, 70.0, 33.0, 45.0, 58.0]},
        index=pd.Index(patients, dtype=index_dtype))
    path = str(tmp_path / "clinical.pkl")
    df.to_pickle(path)
    env = child_env()
    r = subprocess.run([sys.executable, "-c", _READ, path], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout)
    for k in ("survive_time", "survive_state", "age"):
        want = {p: (None if v != v else v) for p, v in df[k].to_dict().items()}
        assert got[k] == want, k
    # the cohort reads the same clinical values as from the dict form
    assert loaders.load_clinical(path)["survive_state"]["TCGA-01"] == 0


def test_clinical_unpickler_refuses_other_classes(tmp_path):
    import pickle

    path = str(tmp_path / "bad.pkl")
    with open(path, "wb") as f:
        pickle.dump({"survive_time": {"a": 1.0}, "x": os.system}, f)
    with pytest.raises(pickle.UnpicklingError):
        loaders.load_clinical(path)


def test_jax_reference_format_dataframe_clinical_reads_equal(tmp_path):
    """The JAX package's writer pickles a DataFrame (clinical.to_pickle);
    the port's loader reads it to JAX's values."""
    from multilevel_gnn_tpu.data.synthetic import write_reference_format as jwrite

    jwrite(str(tmp_path), seed=2, n_patients=20, n_pathways=3)
    clin = pd.read_pickle(str(tmp_path / "clinical.pkl"))
    got = loaders.load_clinical(str(tmp_path / "clinical.pkl"))
    for k in ("survive_time", "survive_state", "age"):
        assert got[k] == clin[k].to_dict()


# ---- the preprocessing cache

def test_content_key_equals_jax():
    parts = ("mi_mask", "v2f32", "gbm", ("TCGA-0001", "TCGA-0002"), 7, True, 12345,
             1.0, None, 0.5, [1, 2])
    assert cache.content_key(*parts) == jcache.content_key(*parts)


def test_use_cache_reads_jax_entry(merge_files, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    kw = dict(SMALL, use_cache=True)
    paths = merge_paths(merge_files)
    paths.pop("ppi_node_path")
    paths.pop("grn_edge_path")
    paths["edge_path"] = f"{merge_files}/gbm/grn_edges.tsv"
    j = jloaders.load_cohort_from_files(cfg=JConfig.from_yaml(GBM, **kw), **paths)
    c = loaders.load_cohort_from_files(cfg=Config.from_yaml(GBM, **kw), **paths)
    train = np.arange(0, len(c.patients), 2)
    jmask, jmi = j.mutual_mask(train, 0)
    assert len(os.listdir(tmp_path / "data_cache")) == 1

    def no_estimator(*a, **k):
        raise AssertionError("the cache entry was not used")

    monkeypatch.setattr(native, "mi_classif", no_estimator)
    mask, mi = c.mutual_mask(train, 0)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(mi, jmi)


def test_use_cache_writes_entry_jax_reads(merge_files, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    kw = dict(SMALL, use_cache=True)
    paths = merge_paths(merge_files)
    paths.pop("ppi_node_path")
    paths.pop("grn_edge_path")
    paths["edge_path"] = f"{merge_files}/gbm/grn_edges.tsv"
    c = loaders.load_cohort_from_files(cfg=Config.from_yaml(GBM, **kw), **paths)
    j = jloaders.load_cohort_from_files(cfg=JConfig.from_yaml(GBM, **kw), **paths)
    train = np.arange(1, len(c.patients), 2)
    mask, mi = c.mutual_mask(train, 3)
    jmask, jmi = j.mutual_mask(train, 3)  # a hit: JAX's key names the port's entry
    assert len(os.listdir(tmp_path / "data_cache")) == 1
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(mi, jmi)


# ---- kraskov_mi and edge_select

@pytest.mark.parametrize("n,dx,seed", [(30, 2, 0), (57, 1, 1), (120, 2, 2), (200, 1, 3)])
def test_kraskov_mi_equals_jax(n, dx, seed):
    rng = np.random.RandomState(seed)
    x = np.round(rng.randn(n, dx), 1)  # ties, broken by the 1e-10 noise
    y = rng.randint(0, 2, (n, 1)).astype(float)
    for xx in (x, x[:, :1]):
        got, want = kraskov_mi(xx, y), jkraskov(xx, y)
        assert abs(got - want) <= 1e-12 * abs(want), (got, want)
    # a continuous target and k
    yc = x[:, :1] * 0.5 + rng.randn(n, 1)
    got, want = kraskov_mi(x, yc, k=3), jkraskov(x, yc, k=3)
    assert want > 0 and abs(got - want) <= 1e-12 * abs(want)


@pytest.mark.parametrize("knn", [False, True], ids=["pca_mi", "kraskov"])
def test_edge_select_edges_equal_jax(merge_files, knn):
    kw = dict(SMALL, edge_select=True, knn_mutual_info=knn, mute_edge="1")
    paths = merge_paths(merge_files)
    paths.pop("ppi_node_path")
    paths.pop("grn_edge_path")
    paths["edge_path"] = f"{merge_files}/gbm/grn_edges.tsv"
    j = jloaders.load_cohort_from_files(cfg=JConfig.from_yaml(GBM, **kw), **paths)
    c = loaders.load_cohort_from_files(cfg=Config.from_yaml(GBM, **kw), **paths)
    train = np.arange(0, len(c.patients), 3)[:40]
    mask, _ = c.mutual_mask(train, 0)
    ei, ea, intra = c.build_edges(mask, train)
    jei, jea, jintra = j.build_edges(mask, train)
    np.testing.assert_array_equal(ei, jei)
    np.testing.assert_array_equal(ea, jea)
    assert intra == jintra
    # the test dropped some intra-omics edges and kept others
    c.cfg = c.cfg.replace(edge_select=False)
    _, _, full_intra = c.build_edges(mask, train)
    assert 0 < intra < full_intra
