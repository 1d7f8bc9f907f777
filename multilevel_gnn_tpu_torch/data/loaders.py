"""Reference-format cohort files -> Cohort (port of
multilevel_gnn_tpu/data/loaders.py, without pandas).

Reads what ``load_cohort_from_files`` (loaders.py:171-240) reads, with the
``csv`` module and numpy:

- omics CSVs (patients x entrez or symbol columns; the first column holds
  the patient ids; an empty field or one of pandas' NA strings is NaN), rows
  more than ``drop_na_percent`` NaN dropped.  Values are read as
  pandas.read_csv's default converter reads them, bit for bit
  (``native.parse_csv_floats``), since that converter is not correctly
  rounded and the JAX package reads these files with it;
- the KEGG table CSV (columns PathwayID, Symbol, Entrezid);
- the ordered pathway list (one id per line, or a pickled list);
- the clinical pickle in its dict-of-mappings form {survive_time,
  survive_state, age} -> {patient: value}.  A pickled pandas DataFrame
  unpickles only where pandas is installed: that branch imports it inside
  and raises, naming the dict form, where it is not;
- the GRNBoost2 edge list (TF, target, importance), correctly rounded as
  the JAX package's C++ parser (strtod) reads it.

``edge_type`` ppi and merge, ``pretain_only_pathway_edge`` and .xlsx
pathway lists raise NotImplementedError.
"""
from __future__ import annotations

import csv
import pickle
from typing import Dict, List, Mapping, Tuple

import numpy as np

from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data import native
from multilevel_gnn_tpu_torch.data.cohort import Cohort
from multilevel_gnn_tpu_torch.data.frame import Frame, KeggTable, drop_na_line

def read_omics_csv(path: str) -> Frame:
    """A patients x columns CSV whose first column is the row label, read as
    pandas.read_csv(path, index_col=0) reads it: a column of integers (and
    NA strings) exactly, as pandas' int64 column, every other value by
    pandas' default float converter (integers past int64 included)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        n_cols = len(header) - 1
        index, rows, kinds, int_rows = [], [], [], []
        for rec in reader:
            if not rec:
                continue
            if len(rec) != n_cols + 1:
                raise ValueError(f"{path}: row {rec[0]!r} has {len(rec) - 1} "
                                 f"values, the header {n_cols}")
            index.append(rec[0])
            values, kind, ints = native.parse_csv_floats(rec[1:])
            rows.append(values)
            kinds.append(kind)
            int_rows.append(ints)
    if not rows:
        return Frame(np.zeros((0, n_cols)), index, header[1:])
    values, kind = np.stack(rows), np.stack(kinds)
    int_cols = (kind != 0).all(axis=0)
    if int_cols.any():
        ints = np.stack(int_rows)[:, int_cols].astype(np.float64)
        values[:, int_cols] = np.where(kind[:, int_cols] == 1, ints, np.nan)
    return Frame(values, index, header[1:])


def read_kegg_csv(path: str) -> KeggTable:
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        recs = list(reader)
    return KeggTable(
        [r["PathwayID"] for r in recs],
        [r["Symbol"] for r in recs],
        [int(float(r["Entrezid"])) for r in recs],
    )


def load_pathway_list(path: str) -> List[str]:
    """Ordered used-pathway list: txt (one code per line) or the reference's
    pickled list (loaders.py:35-45)."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return [str(p) for p in pickle.load(f)]
    if path.endswith(".xlsx"):
        raise NotImplementedError(
            "an .xlsx pathway list is not read by the port; write it as "
            "one pathway id per line (.txt)"
        )
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


def load_clinical(path: str) -> Dict[str, Mapping]:
    """{survive_time, survive_state, age} -> {patient: value}."""
    with open(path, "rb") as f:
        try:
            clin = pickle.load(f)
        except ModuleNotFoundError as e:
            raise RuntimeError(
                f"{path} holds a pickled pandas object and pandas is not "
                "installed; write the clinical data as a pickled dict "
                "{'survive_time': {patient: months}, 'survive_state': "
                "{patient: 0/1}, 'age': {patient: years}}"
            ) from e
    if isinstance(clin, dict):
        return {k: dict(clin[k]) for k in ("survive_time", "survive_state", "age")}
    # a pickled DataFrame (it unpickled, so pandas is installed)
    return {k: clin[k].to_dict() for k in ("survive_time", "survive_state", "age")}


def symbol_to_entrez(kegg: KeggTable) -> Dict[str, int]:
    """First entrez id per symbol (loaders.py:48-52)."""
    out: Dict[str, int] = {}
    for s, e in zip(kegg.symbol, kegg.entrez.tolist()):
        out.setdefault(s, int(e))
    return out


def parse_grnboost2_edges(
    path: str, kegg: KeggTable, cfg: Config
) -> Tuple[Dict[int, List[Tuple[int, int]]], Dict[int, List[float]]]:
    """GRNBoost2 edge list -> entrez-keyed edge dict (loaders.py:75-122).

    Filters: importance >= grn_edge_select_threshold; zero or NaN importance
    dropped when use_column is set; both endpoints must map to a KEGG
    entrez id."""
    if cfg.pretain_only_pathway_edge:
        raise NotImplementedError("pretain_only_pathway_edge is not ported")
    srcs, dsts, vals = native.parse_edge_tsv(path)
    sym2ent = symbol_to_entrez(kegg)
    edges: Dict[int, List[Tuple[int, int]]] = {}
    attrs: Dict[int, List[float]] = {}
    for src, dst, val in zip(srcs, dsts, vals):
        if cfg.grn_edge_select_threshold is not None and val < cfg.grn_edge_select_threshold:
            continue
        if src not in sym2ent or dst not in sym2ent:
            continue
        if cfg.use_column is not None and (np.isnan(val) or val == 0):
            continue
        s, d = sym2ent[src], sym2ent[dst]
        edges.setdefault(s, []).append((s, d))
        attrs.setdefault(s, []).append(float(val))
    return edges, attrs


def load_cohort_from_files(
    mrna_path: str,
    cnv_path: str,
    methylation_path: str,
    clinical_path: str,
    kegg_path: str,
    pathway_list_path: str,
    edge_path: str,
    cfg: Config,
    ppi_node_path=None,
    grn_edge_path=None,
) -> Cohort:
    """Reference-format files -> Cohort (loaders.py:171-240)."""
    if cfg.edge_type != "grnboost2":
        raise NotImplementedError(f"edge_type {cfg.edge_type!r} is not ported (grnboost2 is)")
    kegg = read_kegg_csv(kegg_path)
    pathways = load_pathway_list(pathway_list_path)
    sym2ent = symbol_to_entrez(kegg)
    omics = {}
    for name, path in (("mrna", mrna_path), ("cnv", cnv_path),
                       ("methylation", methylation_path)):
        df = drop_na_line(read_omics_csv(path), cfg.drop_na_percent)
        # symbol-named columns -> entrez (reference :121-125)
        if len(df.columns) and not str(df.columns[0]).lstrip("-").isdigit():
            df = df.rename_columns({s: str(e) for s, e in sym2ent.items()})
        omics[name] = df
    clinical = load_clinical(clinical_path)
    edges, attrs = parse_grnboost2_edges(edge_path, kegg, cfg)
    cfg = cfg.replace(pathway_num=len(pathways))
    return Cohort(omics, clinical, kegg, pathways, edges, attrs, cfg)
