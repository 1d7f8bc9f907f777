"""Reference-format cohort files -> Cohort (port of
multilevel_gnn_tpu/data/loaders.py, without pandas).

Reads what ``load_cohort_from_files`` (loaders.py:171-240) reads, with the
``csv``, ``zipfile``, ``xml.etree`` and ``pickle`` modules and numpy:

- omics CSVs (patients x entrez or symbol columns; the first column holds
  the patient ids; an empty field or one of pandas' NA strings is NaN), rows
  more than ``drop_na_percent`` NaN dropped.  Values are read as
  pandas.read_csv's default converter reads them, bit for bit
  (``native.parse_csv_floats``), since that converter is not correctly
  rounded and the JAX package reads these files with it;
- the KEGG table CSV (columns PathwayID, Symbol, Entrezid);
- the ordered pathway list: one id per line, a pickled list, or the first
  column of an .xlsx workbook's first sheet (``pd.read_excel(path,
  header=None)[0]``), read from the workbook's XML parts;
- the clinical pickle, {survive_time, survive_state, age} -> {patient:
  value}, either as a dict of mappings or as a pickled pandas DataFrame,
  which a restricted unpickler rebuilds without pandas (``load_clinical``);
- the edge sources of ``edge_type``: the GRNBoost2 edge list (TF, target,
  importance; correctly rounded, as the JAX package's C++ parser reads it),
  STRING's node and edge CSV exports (ppi), or both (merge: PPI primary,
  GRN secondary), each optionally kept to same-pathway pairs
  (``pretain_only_pathway_edge``, with ``in_same_pathway``'s quirks).
"""
from __future__ import annotations

import csv
import math
import pickle
import re
import zipfile
from typing import Dict, List, Mapping, Optional, Sequence, Tuple
from xml.etree import ElementTree

import numpy as np

from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.data import native
from multilevel_gnn_tpu_torch.data.cohort import Cohort
from multilevel_gnn_tpu_torch.data.frame import Frame, KeggTable, drop_na_line

# pandas.read_csv's default NA strings (as data/csrc/csv_float.cc's NA)
NA_STRINGS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))

EdgeDict = Dict[int, List[Tuple[int, int]]]
AttrDict = Dict[int, List[float]]


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


def read_csv_columns(path: str) -> Dict[str, List[Optional[str]]]:
    """A CSV with a header row as pandas.read_csv(path) splits it: the csv
    module's default dialect (pandas' quoting: a quoted field may hold the
    delimiter, a doubled quote is a quote), blank lines skipped, a short
    row padded.  Returns {column name: its fields in row order}, None for a
    field that is one of pandas' NA strings."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols: List[List[Optional[str]]] = [[] for _ in header]
        for rec in reader:
            if not rec:
                continue
            if len(rec) > len(header):
                raise ValueError(f"{path}: a row has {len(rec)} fields, the header "
                                 f"{len(header)}")
            rec = rec + [""] * (len(header) - len(rec))
            for col, v in zip(cols, rec):
                col.append(None if v in NA_STRINGS else v)
    return dict(zip(header, cols))


def float_column(fields: Sequence[Optional[str]]) -> np.ndarray:
    """A numeric CSV column as pandas reads it (its default float
    converter; a column of integers exactly), float64 with NaN for NA."""
    values, kind, ints = native.parse_csv_floats(["" if v is None else v for v in fields])
    if len(kind) and (kind != 0).all():
        values = np.where(kind == 1, ints.astype(np.float64), np.nan)
    return values


_XLSX_NS = {
    "m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
    "rel": "http://schemas.openxmlformats.org/package/2006/relationships",
}
_XLSX_RID = "{http://schemas.openxmlformats.org/officeDocument/2006/relationships}id"


def _xlsx_text(node) -> str:
    """A shared or inline string: its <t>, or its rich-text runs' <t>s."""
    t = node.find("m:t", _XLSX_NS)
    if t is not None:
        return t.text or ""
    return "".join(r.text or "" for r in node.findall("m:r/m:t", _XLSX_NS))


def _xlsx_value(cell, shared: List[str]):
    """A cell's value as pandas' openpyxl reader converts it: "" for an
    empty cell, a string, an int for an integral number, a float, a bool,
    NaN for an error."""
    t = cell.get("t", "n")
    v = cell.find("m:v", _XLSX_NS)
    if t == "inlineStr":
        node = cell.find("m:is", _XLSX_NS)
        return _xlsx_text(node) if node is not None else ""
    if v is None or v.text is None:
        return ""
    if t == "s":
        return shared[int(v.text)]
    if t in ("str", "d"):
        return v.text
    if t == "b":
        return bool(int(v.text))
    if t == "e":
        return math.nan
    num = float(v.text)
    return int(num) if num == int(num) else num


def read_xlsx_first_column(path: str) -> list:
    """``pd.read_excel(path, header=None)[0].tolist()`` (loaders.py:42-43)
    from the workbook's parts: xl/workbook.xml and its relationships name
    the first sheet, xl/sharedStrings.xml holds the strings.  Rows run
    from the first to the last one with data; an empty cell, a missing
    one and one of pandas' NA strings give NaN."""
    with zipfile.ZipFile(path) as z:
        book = ElementTree.fromstring(z.read("xl/workbook.xml"))
        sheet = book.find("m:sheets/m:sheet", _XLSX_NS)
        if sheet is None:
            raise ValueError(f"{path}: the workbook has no sheet")
        rels = ElementTree.fromstring(z.read("xl/_rels/workbook.xml.rels"))
        target = next(r.get("Target") for r in rels.findall("rel:Relationship", _XLSX_NS)
                      if r.get("Id") == sheet.get(_XLSX_RID))
        part = target.lstrip("/") if target.startswith("/") else "xl/" + target
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            sst = ElementTree.fromstring(z.read("xl/sharedStrings.xml"))
            shared = [_xlsx_text(si) for si in sst.findall("m:si", _XLSX_NS)]
        data = ElementTree.fromstring(z.read(part))
    first: Dict[int, object] = {}  # row number -> column A's value, rows with data
    for i, row in enumerate(data.findall("m:sheetData/m:row", _XLSX_NS)):
        values, col_a = [], ""
        for j, cell in enumerate(row.findall("m:c", _XLSX_NS)):
            v = _xlsx_value(cell, shared)
            ref = cell.get("r")
            if (re.match(r"[A-Z]+", ref).group(0) == "A") if ref else j == 0:
                col_a = v
            values.append(v)
        if any(not (isinstance(v, str) and v == "") for v in values):
            first[int(row.get("r", i + 1))] = col_a
    if not first:
        raise ValueError(f"{path}: the first sheet holds no data")
    out = [first.get(r, "") for r in range(1, max(first) + 1)]
    return [math.nan if isinstance(v, str) and v in NA_STRINGS else v for v in out]


def load_pathway_list(path: str) -> list:
    """Ordered used-pathway list: txt (one code per line), xlsx first
    column, or the reference's pickled list (loaders.py:35-45)."""
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return [str(p) for p in pickle.load(f)]
    if path.endswith(".xlsx"):
        return read_xlsx_first_column(path)
    with open(path) as f:
        return [l.strip() for l in f if l.strip()]


class _Shim:
    """Stand-in for an allowed pandas class: the unpickler makes one where
    the pickle makes the class's object, and keeps its state."""

    def __init__(self, *args):
        self.args = args
        self.state = None

    def __setstate__(self, state):
        self.state = state


class _DataFrame(_Shim):
    pass


class _ArrowStringArray(_Shim):
    pass


class _IndexClass:
    """An Index class named in a pickle; _new_Index builds its values."""

    def __init__(self, kind):
        self.kind = kind


def _restore_arrow_strings(data):
    """pyarrow.lib._restore_array's state of a string or large_string array
    (type, length, null_count, offset, [validity, offsets, data], children,
    dictionary) -> its values, None for a null."""
    typ, length, _, offset, buffers = data[:5]
    if typ not in ("string", "large_string", "utf8", "large_utf8"):
        raise pickle.UnpicklingError(f"arrow array of type {typ!r} not supported")
    validity, offsets, chars = buffers
    off = np.frombuffer(offsets, np.int64 if typ.startswith("large") else np.int32)
    chars = bytes(chars) if chars is not None else b""
    valid = (np.unpackbits(np.frombuffer(validity, np.uint8), bitorder="little")
             if validity is not None else None)
    return [chars[off[i]:off[i + 1]].decode() if valid is None or valid[i] else None
            for i in range(offset, offset + length)]


def _index_values(obj) -> list:
    if isinstance(obj, _ArrowStringArray):
        return obj.state["_pa_array"]
    return np.asarray(obj).tolist()


def _new_index(cls, d):
    if not isinstance(cls, _IndexClass):
        raise pickle.UnpicklingError("unexpected Index class")
    if cls.kind == "range":
        return list(range(d["start"], d["stop"], d.get("step", 1)))
    return _index_values(d["data"])


def _block_manager(blocks, axes):
    return {"blocks": blocks, "axes": axes}


def _unpickle_block(values, placement, ndim):
    return values, placement


_CLINICAL_GLOBALS = {
    ("pandas", "DataFrame"): _DataFrame,
    ("pandas.core.frame", "DataFrame"): _DataFrame,
    ("pandas.core.internals.managers", "BlockManager"): _block_manager,
    ("pandas._libs.internals", "_unpickle_block"): _unpickle_block,
    ("pandas.core.indexes.base", "_new_Index"): _new_index,
    ("pandas", "Index"): _IndexClass("index"),
    ("pandas.core.indexes.base", "Index"): _IndexClass("index"),
    ("pandas", "RangeIndex"): _IndexClass("range"),
    ("pandas.core.indexes.range", "RangeIndex"): _IndexClass("range"),
    ("pandas.arrays", "ArrowStringArray"): _ArrowStringArray,
    ("pandas.core.arrays.string_arrow", "ArrowStringArray"): _ArrowStringArray,
    ("pandas", "StringDtype"): _Shim,
    ("pandas.core.arrays.string_", "StringDtype"): _Shim,
    ("pyarrow.lib", "_restore_array"): _restore_arrow_strings,
    ("pyarrow.lib", "type_for_alias"): str,
    ("pyarrow.lib", "py_buffer"): bytes,
    ("builtins", "slice"): slice,
    ("builtins", "bytearray"): bytearray,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
}
_np_core = np._core if hasattr(np, "_core") else np.core
for _mod in ("numpy.core", "numpy._core"):
    _CLINICAL_GLOBALS[(_mod + ".multiarray", "_reconstruct")] = _np_core.multiarray._reconstruct
    _CLINICAL_GLOBALS[(_mod + ".multiarray", "scalar")] = _np_core.multiarray.scalar
    # protocol 5 pickles an array as its bytes and _frombuffer
    _CLINICAL_GLOBALS[(_mod + ".numeric", "_frombuffer")] = _np_core.numeric._frombuffer


class _ClinicalUnpickler(pickle.Unpickler):
    """Unpickles a dict, or the pandas DataFrame that pandas.to_pickle
    writes for the three clinical columns, without pandas: find_class gives
    the stand-ins above for the pandas, pyarrow and numpy names such a
    pickle holds, and refuses every other class."""

    def find_class(self, module, name):
        try:
            return _CLINICAL_GLOBALS[(module, name)]
        except KeyError:
            raise pickle.UnpicklingError(
                f"{module}.{name} is not allowed in a clinical pickle") from None


def _frame_columns(df: _DataFrame) -> Dict[str, Dict]:
    """{column: {row label: value}} of an unpickled DataFrame stand-in."""
    mgr = df.state["_mgr"]
    columns, index = mgr["axes"]
    out = {}
    for values, placement in mgr["blocks"]:
        cols = (range(*placement.indices(len(columns)))
                if isinstance(placement, slice) else np.asarray(placement).tolist())
        values = np.asarray(values).reshape(len(cols), len(index))
        for row, c in zip(values, cols):
            out[columns[c]] = dict(zip(index, row.tolist()))
    return out


def load_clinical(path: str) -> Dict[str, Mapping]:
    """{survive_time, survive_state, age} -> {patient: value}, from a
    pickled dict of mappings or a pickled pandas DataFrame (loaders.py:
    209-217), read by a restricted unpickler."""
    with open(path, "rb") as f:
        clin = _ClinicalUnpickler(f).load()
    if isinstance(clin, _DataFrame):
        clin = _frame_columns(clin)
    if not isinstance(clin, dict):
        raise ValueError(f"{path}: a clinical pickle holds a dict or a DataFrame, "
                         f"not {type(clin).__name__}")
    return {k: dict(clin[k]) for k in ("survive_time", "survive_state", "age")}


def symbol_to_entrez(kegg: KeggTable) -> Dict[str, int]:
    """First entrez id per symbol (loaders.py:48-52)."""
    out: Dict[str, int] = {}
    for s, e in zip(kegg.symbol, kegg.entrez.tolist()):
        out.setdefault(s, int(e))
    return out


def in_same_pathway(source_id: int, end_id: int, kegg: KeggTable, pathway_codes) -> bool:
    """loaders.py:55-72 (reference MyData.in_same_pathway), quirks kept:
    ``id in kegg['Entrezid']`` tests the pandas Series' index, the row
    positions 0 .. len(kegg) - 1, so an id at or past len(kegg) always
    fails; and only the source's pathways are checked against
    pathway_codes."""
    n = len(kegg.entrez)
    if not (0 <= source_id < n and 0 <= end_id < n):
        return False
    end_set = kegg.pathways_of(end_id)
    return any(p in pathway_codes and p in end_set for p in kegg.pathways_of(source_id))


def _keep_edge(s: int, d: int, kegg: KeggTable, cfg: Config, pathways) -> bool:
    return not cfg.pretain_only_pathway_edge or in_same_pathway(s, d, kegg, pathways or [])


def parse_grnboost2_edges(
    path: str, kegg: KeggTable, cfg: Config, pathways=None
) -> Tuple[EdgeDict, AttrDict]:
    """GRNBoost2 edge list -> entrez-keyed edge dict (loaders.py:75-122).

    Filters: importance >= grn_edge_select_threshold; zero or NaN importance
    dropped when use_column is set; both endpoints must map to a KEGG
    entrez id; with pretain_only_pathway_edge, same-pathway pairs only."""
    srcs, dsts, vals = native.parse_edge_tsv(path)
    sym2ent = symbol_to_entrez(kegg)
    edges: EdgeDict = {}
    attrs: AttrDict = {}
    for src, dst, val in zip(srcs, dsts, vals):
        if cfg.grn_edge_select_threshold is not None and val < cfg.grn_edge_select_threshold:
            continue
        if src not in sym2ent or dst not in sym2ent:
            continue
        if cfg.use_column is not None and (np.isnan(val) or val == 0):
            continue
        s, d = sym2ent[src], sym2ent[dst]
        if not _keep_edge(s, d, kegg, cfg, pathways):
            continue
        edges.setdefault(s, []).append((s, d))
        attrs.setdefault(s, []).append(float(val))
    return edges, attrs


def parse_ppi_edges(
    node_path: str, edge_path: str, kegg: KeggTable, cfg: Config, pathways=None
) -> Tuple[EdgeDict, AttrDict]:
    """STRING node and edge CSVs -> entrez-keyed edge dict (loaders.py:
    125-168), quirks kept: the node table's first three columns by
    position are its id ('stringdb:' stripped), query term and node type,
    and only protein nodes whose term is a KEGG symbol map; only edges
    named "A (pp) B" count; the score column is cfg.use_column or
    'stringdb::score', NaN read as 0 (fillna), and 0 dropped when
    use_column is set; with pretain_only_pathway_edge, same-pathway pairs
    only."""
    nodes = list(read_csv_columns(node_path).values())
    if len(nodes) < 3:
        raise ValueError(f"{node_path}: a STRING node table has at least 3 columns")
    kegg_symbols = set(kegg.symbol)
    sym2ent = symbol_to_entrez(kegg)
    id2ent: Dict[str, int] = {}
    for sid, symbol, ntype in zip(nodes[0], nodes[1], nodes[2]):
        if symbol in kegg_symbols and ntype == "protein":
            id2ent[("nan" if sid is None else sid).replace("stringdb:", "")] = sym2ent[symbol]
    table = read_csv_columns(edge_path)
    n_rows = len(next(iter(table.values()), []))
    names = table.get("name", [""] * n_rows)
    score_col = cfg.use_column or "stringdb::score"
    scores = (float_column(table[score_col]) if score_col in table
              else np.zeros(n_rows))
    scores = np.where(np.isnan(scores), 0.0, scores)
    edges: EdgeDict = {}
    attrs: AttrDict = {}
    for name, val in zip(names, scores.tolist()):
        name = "0" if name is None else name  # fillna(0) of a missing name
        if " (pp) " not in name:
            continue
        a, b = name.split(" (pp) ")
        if a not in id2ent or b not in id2ent:
            continue
        if cfg.use_column is not None and val == 0:
            continue
        s, d = id2ent[a], id2ent[b]
        if not _keep_edge(s, d, kegg, cfg, pathways):
            continue
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
    ppi_node_path: Optional[str] = None,
    grn_edge_path: Optional[str] = None,
) -> Cohort:
    """Reference-format files -> Cohort (loaders.py:171-240).  edge_type
    'ppi' reads STRING's node table at ppi_node_path and its edge table at
    edge_path; 'merge' reads those as the primary graph and the GRNBoost2
    list at grn_edge_path as the secondary (reference multiloader.py:
    62-64)."""
    if cfg.edge_type not in ("grnboost2", "ppi", "merge"):
        raise ValueError(f"unknown edge_type {cfg.edge_type!r}")
    if cfg.edge_type in ("ppi", "merge") and ppi_node_path is None:
        raise ValueError(f"edge_type {cfg.edge_type!r} needs the STRING node table")
    if cfg.edge_type == "merge" and grn_edge_path is None:
        raise ValueError("edge_type 'merge' needs the GRNBoost2 edge list")
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
    edges2 = attrs2 = None
    if cfg.edge_type == "grnboost2":
        edges, attrs = parse_grnboost2_edges(edge_path, kegg, cfg, pathways)
    else:
        edges, attrs = parse_ppi_edges(ppi_node_path, edge_path, kegg, cfg, pathways)
    if cfg.edge_type == "merge":
        edges2, attrs2 = parse_grnboost2_edges(grn_edge_path, kegg, cfg, pathways)
    cfg = cfg.replace(pathway_num=len(pathways))
    return Cohort(omics, clinical, kegg, pathways, edges, attrs, cfg,
                  edges2=edges2, edge_attrs2=attrs2)
