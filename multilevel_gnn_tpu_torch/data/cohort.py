"""Multi-omics cohort pipeline on the host (port of
multilevel_gnn_tpu/data/cohort.py, without pandas and sklearn).

The same derivations, in the same order, from the same tables:

- node universe, patient populations, centering, the (pathway, omics,
  gene) PCA row table, dense node features and labels
  (``Cohort.__init__`` :92-185, ``_build_pca_table`` :217-274,
  ``_build_node_features`` :276-305);
- per fold: the MI feature mask over PCA rows (``mutual_mask`` :334-428,
  with its f32-rounding of the features, and with ``use_cache`` the
  on-disk cache of data/cache.py under the JAX package's key), per-(pathway,
  omics) PCA seeds (``_pathway_pca`` :430-532, sklearn's
  ``PCA(svd_solver="full")`` and its sign convention written out in numpy
  and scipy), the pathway reorder, MI-selected intra- and cross-omics edges
  (``build_edges`` :635-696, with ``edge_select``'s per-edge PCA / MI test
  ``_edge_mi_valid`` :560-587) and the fold graph and context (``fold``
  :830-923), on the requested device;
- ``edge_type: merge``'s secondary graph (``merge_graph2`` :589-633),
  attached to every fold's context as ``graph2``.

Omics tables are ``data.frame.Frame``s, the KEGG table a ``KeggTable``,
clinical data a dict of mappings {survive_time, survive_state, age} ->
{patient: value}.

The gene-level variant for DeeperGCN (``gene_level_features`` :701-711,
``gene_level_graph`` :713-748, ``deepergcn_fold`` :750-775): per-gene
omics rows, the gene graph both ways plus gene -> pathway-node edges with
one-hot ids, and the per-pathway PCA attrs as the batches' side channel;
MultiOmixGCN's per-omics gene -> pathway-vnode graphs, masks and attrs
(``multiomix_vnode_data`` :777-821).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from multilevel_gnn_tpu_torch.core.batch import FoldContext, make_fold_context
from multilevel_gnn_tpu_torch.core.config import Config
from multilevel_gnn_tpu_torch.core.graph import Graph
from multilevel_gnn_tpu_torch.data import native
from multilevel_gnn_tpu_torch.data.cache import PreprocessCache, content_key
from multilevel_gnn_tpu_torch.data.frame import Frame, KeggTable
from multilevel_gnn_tpu_torch.utils.knnie import kraskov_mi

OMICS = ("mrna", "cnv", "methylation")  # omics index 0/1/2 (reference order)


@dataclasses.dataclass
class PcaRow:
    """One row of the learnable-PCA table: a (pathway, omics, gene) column."""

    pathway_i: int
    omics: int
    entrez: int
    slot: int  # pathway-omics slot id = sequential (pathway, omics) counter


@dataclasses.dataclass
class FoldData:
    """Everything the trainer needs for one CV fold (cohort.py:63-74), and
    the host seconds of each derivation stage (mi, pca, edges, graph).
    raw: the batches' raw_data side channel of the models that take one,
    else None: deepergcn_fold sets it to the pathway node attrs in
    float32."""

    ctx: FoldContext
    info_mask: np.ndarray  # (G, 1)
    mutual_info: np.ndarray  # (G,)
    pca_seed: np.ndarray  # (G, pca_dim)
    class_weight: np.ndarray  # (2,)
    pathway_node_attr: Optional[np.ndarray] = None  # (n_patients, P, 3*pca_dim)
    reorder_idxs: Optional[np.ndarray] = None
    edge_count: int = 0
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    raw: Optional[np.ndarray] = None


def pca_full(data: np.ndarray, n_components: int) -> Tuple[np.ndarray, np.ndarray]:
    """sklearn PCA(n_components, svd_solver="full").fit(data) and its
    transform(data): (components_ (k, F), transformed (n, k)).

    The same steps as sklearn 1.9's _fit_full and _transform: center by the
    column mean, scipy's SVD, svd_flip with u_based_decision=False (each
    component's sign makes its largest-magnitude entry positive), then
    data @ components.T - mean @ components.T."""
    from scipy import linalg

    X = np.asarray(data, np.float64)
    n, f = X.shape
    if not 0 <= n_components <= min(n, f):
        raise ValueError(f"n_components={n_components} with data {X.shape}")
    mean = np.mean(X, axis=0)
    U, S, Vt = linalg.svd(X - mean, full_matrices=False)
    rows = np.argmax(np.abs(Vt), axis=1)
    signs = np.sign(Vt[np.arange(Vt.shape[0]), rows])
    Vt *= signs[:, np.newaxis]
    comp = np.array(Vt[:n_components], copy=True)
    out = X @ comp.T
    out -= mean.reshape(1, -1) @ comp.T
    return comp, out


def pca_one(data: np.ndarray) -> np.ndarray:
    """sklearn PCA(n_components=1).fit(data).transform(data), (n, 1), with
    its default solver choice: "covariance_eigh" for n >= 10 * features
    (the eigenvectors of X^T X - n mean mean^T over n - 1), else "full"
    (pca_full); each with svd_flip's sign convention."""
    X = np.asarray(data, np.float64)
    n, f = X.shape
    if not (f <= 1000 and n >= 10 * f):
        return pca_full(X, 1)[1]
    mean = np.mean(X, axis=0)
    C = X.T @ X
    C -= n * mean.reshape(-1, 1) * mean.reshape(1, -1)
    C /= n - 1
    _, vecs = np.linalg.eigh(C)
    Vt = np.flip(vecs, axis=1).T
    rows = np.argmax(np.abs(Vt), axis=1)
    Vt = Vt * np.sign(Vt[np.arange(Vt.shape[0]), rows])[:, None]
    comp = Vt[:1]
    out = X @ comp.T
    out -= mean.reshape(1, -1) @ comp.T
    return out


class Cohort:
    """In-memory multi-omics cohort with per-fold derivations.

    omics: {'mrna', 'cnv', 'methylation'} -> Frame (patients x entrez-string
    columns, raw).  clinical: {'survive_time' (months), 'survive_state'
    (1 = event), 'age'} -> {patient: value}.  kegg: KeggTable.  pathways:
    ordered pathway ids.  edges: entrez -> [(src, dst) entrez pairs];
    edge_attrs: entrez -> [float] parallel to edges; edges2 / edge_attrs2:
    the same for edge_type 'merge''s secondary graph."""

    def __init__(
        self,
        omics: Mapping[str, Frame],
        clinical: Mapping[str, Mapping],
        kegg: KeggTable,
        pathways: Sequence[str],
        edges: Dict[int, List[Tuple[int, int]]],
        edge_attrs: Dict[int, List[float]],
        cfg: Config,
        edges2: Optional[Dict[int, List[Tuple[int, int]]]] = None,
        edge_attrs2: Optional[Dict[int, List[float]]] = None,
    ):
        self.cfg = cfg
        self.kegg = kegg
        self.pathways = [str(p) for p in pathways]
        self.edges = edges
        self.edge_attrs = edge_attrs
        # the secondary (GRN) edge set of edge_type 'merge'
        self.edges2 = edges2
        self.edge_attrs2 = edge_attrs2
        self._graph2_cache: Dict[str, Graph] = {}

        mrna, cnv, mt = omics["mrna"], omics["cnv"], omics["methylation"]
        if cfg.zscore_mrna:
            mrna = mrna.sub_cols(mrna.mean()).div_cols(mrna.std())
        if cfg.add_hat:
            # winsorize mrna at the add_hat_percent quantile both sides
            hi = mrna.quantile(cfg.add_hat_percent)
            lo = mrna.quantile(1.0 - cfg.add_hat_percent)
            mrna = mrna.clip(lo, hi)
        if cfg.reverse_mt:
            mt = mt.neg()

        keys = {}
        for name in ("survive_time", "survive_state", "age"):
            for p in clinical.get(name, {}):
                keys.setdefault(str(p), None)

        def column(name):
            src = {str(p): v for p, v in clinical.get(name, {}).items()}
            return {p: float(src.get(p, np.nan)) for p in keys}

        self.survive_time = column("survive_time")
        self.survive_state = column("survive_state")
        self.age = column("age")

        # node universe: genes of the ordered pathways present in kegg,
        # sorted by entrez (reference multiloader.py:239-249)
        universe = sorted(set(int(e) for e in kegg.entrez_in(self.pathways)))
        self.node_map = {e: i for i, e in enumerate(universe)}
        self.node_size = len(universe)

        # PCA population: omics/clinical intersection before risk filtering;
        # the training population is risk-filtered (reference :131-148)
        pca_patients = [
            p for p in mt.index
            if cnv.has_row(p) and mrna.has_row(p) and p in self.survive_time
        ]
        self.pca_patients = pca_patients
        self.patients = [
            p for p in pca_patients
            if not np.isnan(self.survive_time[p])
            and (not cfg.use_age or (p in self.age and not np.isnan(self.age[p])))
            and (self.survive_time[p] > cfg.risk_threshold
                 or self.survive_state[p] == 1)
        ]
        self.omics_raw = {"mrna": mrna, "cnv": cnv, "methylation": mt}

        # joined + centered matrix for node features (reference :134-143),
        # kept as its per-omics parts: centering acts column by column
        joined = {
            "cnv": cnv.reindex(pca_patients),
            "mrna": mrna.reindex(pca_patients),
            "methylation": mt.reindex(pca_patients),
        }
        if cfg.z_score:
            joined = {k: f.sub_cols(f.mean()).div_cols(f.std()) for k, f in joined.items()}
        elif cfg.z_mean:
            joined = {k: f.sub_cols(f.mean()) for k, f in joined.items()}
        self.joined = joined

        self._omics_cache: Dict[str, tuple] = {}
        self._build_pca_table()
        self._build_node_features()
        self._mask_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.initial_reorder_idxs: Optional[np.ndarray] = None
        if cfg.reorder_pathway:
            # initial (unmasked) reorder pass (reference :512-528 first call)
            _, _, reorder, _ = self._pathway_pca(None)
            self.initial_reorder_idxs = reorder

    # ------------------------------------------------------------------ #
    # static tables
    # ------------------------------------------------------------------ #
    def _omics_cols(self, omics_name: str):
        """Per-omics column table: (values (cols, n_pca), each column one
        contiguous row, so that ndarray.sum's pairwise order is pandas';
        int column ids; id -> row; NaN-free mask)."""
        if omics_name not in self._omics_cache:
            df = self.omics_raw[omics_name]
            sub = df.reindex(self.pca_patients)
            colT = np.ascontiguousarray(sub.values.T)
            cols_int = np.array([int(c) for c in df.columns], np.int64)
            colidx = {int(c): i for i, c in enumerate(cols_int)}
            nanfree = ~np.isnan(colT).any(axis=1)
            self._omics_cache[omics_name] = (colT, cols_int, colidx, nanfree)
        return self._omics_cache[omics_name]

    def _pathway_columns(self, pathway: str, omics_name: str) -> List[str]:
        """Sorted entrez columns of this pathway present and NaN-free in the
        omics table (reference np.intersect1d + dropna, :413-420)."""
        _, cols_int, colidx, nanfree = self._omics_cols(omics_name)
        inter = np.intersect1d(self.kegg.entrez_of(pathway), cols_int)
        return [str(c) for c in inter if nanfree[colidx[int(c)]]]

    def _build_pca_table(self):
        """Fixed (pathway, omics, gene) row table + raw_datas matrix."""
        rows: List[PcaRow] = []
        slot = 0
        used_pathways = []
        for pathway in self.pathways:
            if len(self.kegg.entrez_of(pathway)) < 5:  # reference :405-407
                continue
            used_pathways.append(pathway)
            ppi = len(used_pathways) - 1
            for oi, name in enumerate(OMICS):
                for col in self._pathway_columns(pathway, name):
                    rows.append(PcaRow(ppi, oi, int(col), slot))
                slot += 1
        self.used_pathways = used_pathways
        self.n_pathways = len(used_pathways)
        self.rows = rows
        self.num_pca_rows = len(rows)
        self.raw_indice = np.array([r.slot for r in rows], np.int32)

        # raw_datas: mean-centered per-column values of the PCA population,
        # and gene_std_value their std, as pandas takes them (mean = sum / n;
        # var = sum((mean - x)^2) / (n - 1), cohort.py:246-255)
        n_pca = len(self.pca_patients)
        mats = np.empty((len(rows), n_pca), np.float64)
        stds = np.empty(len(rows), np.float64)
        for i, r in enumerate(rows):
            colT, _, colidx, _ = self._omics_cols(OMICS[r.omics])
            col = colT[colidx[r.entrez]]
            mean = col.sum() / n_pca
            mats[i] = col - mean
            stds[i] = np.sqrt(((mean - col) ** 2).sum() / (n_pca - 1))
        self.raw_datas = np.ascontiguousarray(mats.T)  # (n_pca, G)
        self.gene_std_value = stds.astype(np.float32)
        self.tf_token = np.array(
            [(str(r.omics) in self.cfg.remain_tf_nums) and (r.entrez in self.edges)
             for r in rows],
            bool,
        )
        # gene -> node-slot map (reference :610-616); idx_map == identity
        self.gene_pca_match = np.array(
            [3 * self.node_map[r.entrez] + r.omics if r.entrez in self.node_map else -1
             for r in rows],
            np.int32,
        )

    def _build_node_features(self):
        """Dense per-patient node features (reference predefine_data
        :949-971 + pathway zero rows :1024-1025)."""
        cfg = self.cfg
        P = self.n_pathways if cfg.pathway_global_node else 0
        self.node_num = self.node_size + P
        n = len(self.patients)
        X = np.zeros((n, self.node_size, 3), np.float32)
        universe = list(self.node_map)
        for oi, name in enumerate(OMICS):
            sub = self.joined[name].reindex(self.patients)
            present = [str(e) for e in universe if sub.has_col(str(e))]
            vals = sub.select(present).values.astype(np.float32)
            idxs = [self.node_map[int(c)] for c in present]
            X[:, idxs, oi] = np.nan_to_num(vals, nan=0.0)
        if P:
            X = np.concatenate([X, np.zeros((n, P, 3), np.float32)], axis=1)
        self.X = X.reshape(n, 3 * self.node_num)
        self.num_nodes = 3 * self.node_num
        self.Y = np.stack([self._label(p) for p in self.patients]).astype(np.float32)
        ages = np.array([self.age.get(p, np.nan) for p in self.patients], np.float32)
        self.ages = np.nan_to_num(ages, nan=0.0)

    def _label(self, patient) -> np.ndarray:
        cfg = self.cfg
        if cfg.soft_label:
            if self.survive_state[patient] == 0:
                return np.array([0.0, 1.0])
            os_m = self.survive_time[patient]
            z = np.array([1 - os_m / cfg.risk_threshold, os_m / cfg.risk_threshold - 1])
            e = np.exp(z - z.max())
            return e / e.sum()
        y = np.zeros(2)
        y[int(self.survive_time[patient] > cfg.risk_threshold)] = 1.0
        return y

    def labels(self) -> np.ndarray:
        """Binary class per patient = y[1] > 0.5 (reference :331-337)."""
        return (self.Y[:, 1] > 0.5).astype(np.int64)

    def slot_sizes(self) -> tuple:
        """Genes per pathway-omics slot."""
        counts = np.bincount(self.raw_indice, minlength=3 * self.n_pathways)
        return tuple(int(c) for c in counts)

    # ------------------------------------------------------------------ #
    # per-fold derivations
    # ------------------------------------------------------------------ #
    def mutual_mask(self, train_idx: np.ndarray, fold: int) -> Tuple[np.ndarray, np.ndarray]:
        """MI feature mask over PCA rows (reference multilevel_gnn.py:353-377),
        cached per fold."""
        cfg = self.cfg
        if fold in self._mask_cache:
            return self._mask_cache[fold]
        disk = None
        if cfg.use_cache:
            # the JAX package's key, parts and 'v2f32' token included (the
            # estimator sees f32-rounded features), so its entries serve here
            disk = PreprocessCache("./data_cache")
            key = content_key(
                "mi_mask", "v2f32", cfg.cancer_type,
                tuple(self.patients[i] for i in train_idx),
                cfg.mutual_neighbors, cfg.mutual_classif,
                cfg.random_state if cfg.freeze_mutual_select_init else None,
                cfg.node_select_threshold, cfg.mutual_info_threshold,
            )
            hit = disk.get(key)
            if hit is not None:
                self._mask_cache[fold] = hit
                return hit
        pos = {p: i for i, p in enumerate(self.pca_patients)}
        rows = [pos[self.patients[i]] for i in train_idx]
        # the reference tensorizes the float64 features with torch.tensor,
        # i.e. as f32, so the estimator sees f32-rounded values
        x = self.raw_datas[rows].astype(np.float32)
        y = self.labels()[train_idx]
        rs = cfg.random_state if cfg.freeze_mutual_select_init else None
        fn = native.mi_classif if cfg.mutual_classif else native.mi_regression
        mi = fn(x, y, n_neighbors=cfg.mutual_neighbors, random_state=rs)
        thr = (
            cfg.node_select_threshold * np.mean(mi)
            if cfg.mutual_info_threshold is None
            else cfg.mutual_info_threshold
        )
        mask = (mi >= thr).astype(np.float32)[:, None]
        if cfg.remain_all_tf:
            mask = np.maximum(mask, self.tf_token.astype(np.float32)[:, None])
        self._mask_cache[fold] = (mask, mi)
        if disk is not None:
            disk.put(key, (mask, mi))
        return mask, mi

    def _pathway_pca(self, info_mask: Optional[np.ndarray]):
        """Per-(pathway, omics) PCA (reference prepare_pca_result).

        Returns (pca_seed (G, pca_dim), pathway_node_attr
        (n_pca_patients, P, 3*pca_dim), reorder_idxs or None, pathway_adj
        (P, P) float32: the pathways' correlation over their PCA matrices,
        NaN as 0, plus I, cohort.py:519-531)."""
        cfg = self.cfg
        G = self.num_pca_rows
        n_pca = len(self.pca_patients)
        seed = np.zeros((G, cfg.pca_dim), np.float32)
        attr = np.zeros((n_pca, self.n_pathways, 3 * cfg.pca_dim), np.float64)
        pathway_matrix = []
        rows = self.rows
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, r in enumerate(rows):
            groups.setdefault((r.pathway_i, r.omics), []).append(i)
        pca_tables = {name: f.reindex(self.pca_patients) for name, f in self.omics_raw.items()}
        for ppi in range(self.n_pathways):
            for oi in range(3):
                idxs = groups.get((ppi, oi), [])
                if not idxs:
                    pathway_matrix.append(np.zeros((n_pca, cfg.pca_sim_dim)))
                    continue
                cols = [str(rows[i].entrez) for i in idxs]
                # column-major, as pandas' to_numpy gives a one-block frame:
                # the layout sets np.mean's and the products' summation order
                data = np.asfortranarray(pca_tables[OMICS[oi]].select(cols).values)
                if info_mask is not None:
                    sel = [k for k, i in enumerate(idxs) if info_mask[i, 0] > 0]
                else:
                    sel = list(range(len(idxs)))
                n_sel = len(sel)
                if info_mask is None or n_sel < cfg.pca_sim_dim:
                    # PCA on all columns, components masked to the selected
                    # ones (reference :459-483)
                    dim = min(max(n_sel, 1), cfg.pca_sim_dim, data.shape[1])
                    if info_mask is None:
                        dim = min(cfg.pca_sim_dim, data.shape[1], n_pca)
                    components, pdat = pca_full(data, dim)
                    if pdat.shape[1] < cfg.pca_sim_dim:
                        pdat = np.concatenate(
                            [pdat, np.zeros((len(pdat), cfg.pca_sim_dim - pdat.shape[1]))],
                            axis=1,
                        )
                    if info_mask is not None and n_sel > 0:
                        if cfg.drop_irr_pathway:
                            comp = np.zeros((components.shape[0], n_sel))
                        else:
                            comp = components[:, sel]
                        if comp.shape[0] < cfg.pca_dim:
                            comp = np.concatenate(
                                [comp, np.zeros((cfg.pca_dim - comp.shape[0], n_sel))]
                            )
                        comp = comp[: cfg.pca_dim, :]
                        for c, k in zip(sel, range(n_sel)):
                            seed[idxs[c], : comp.shape[0]] = comp[:, k]
                else:
                    components, pdat = pca_full(data[:, sel], cfg.pca_sim_dim)
                    comp = components[: cfg.pca_dim, :]
                    if cfg.mean_pca_init:
                        comp = comp / np.mean(np.abs(comp)) * cfg.pca_mean_value
                    for k, c in enumerate(sel):
                        seed[idxs[c], : comp.shape[0]] = comp[:, k]
                pathway_matrix.append(pdat[:, : cfg.pca_sim_dim])
                attr[:, ppi, oi * cfg.pca_dim : (oi + 1) * cfg.pca_dim] = pdat[:, : cfg.pca_dim]

        reorder = None
        if cfg.reorder_pathway and (cfg.selected_similarity or info_mask is None):
            reorder = self._reorder_from_matrix(pathway_matrix)
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = np.corrcoef(self._pathway_rows(pathway_matrix))
        adj = (np.nan_to_num(corr, nan=0.0) + np.eye(self.n_pathways)).astype(np.float32)
        return seed, attr, reorder, adj

    def _pathway_rows(self, pathway_matrix: List[np.ndarray]) -> np.ndarray:
        """(P, 3 * n * pca_sim_dim): each pathway's three PCA matrices, flat."""
        return np.stack([
            np.concatenate([pathway_matrix[3 * ppi + oi].reshape(-1) for oi in range(3)])
            for ppi in range(self.n_pathways)
        ])

    def _reorder_from_matrix(self, pathway_matrix: List[np.ndarray]) -> np.ndarray:
        """Greedy correlation-chain pathway ordering (reference :512-528)."""
        P = self.n_pathways
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = np.corrcoef(self._pathway_rows(pathway_matrix)) - np.eye(P)
        corr = np.nan_to_num(corr, nan=-1.0)
        mx = corr.argmax()
        order = [mx // P, mx % P]
        remain = set(range(P)) - set(order)
        sort_m = np.argsort(corr)
        while len(order) < P:
            src = order[-1]
            for t in sort_m[src][::-1]:
                if t in remain:
                    order.append(int(t))
                    remain.remove(int(t))
                    break
        return np.array(order, np.int32)

    def _edge_mi_valid(self, src, dst, oi, train_patients, y) -> bool:
        """edge_select's per-edge test (cohort.py:560-587, reference
        valid_pca_mutual_info :828-874): the edge's two columns over the
        training patients; with knn_mutual_info and omics other than 1, the
        KSG estimator on both columns against each alone; else the MI of
        their first principal component against each column's (the
        config's estimator at sklearn's default 3 neighbours)."""
        cfg = self.cfg
        if not cfg.edge_select:
            return True
        df = self.omics_raw[OMICS[oi]]
        cols = [str(src), str(dst)]
        if not all(df.has_col(c) for c in cols):
            return False
        # column-major, as pandas' to_numpy gives a one-block frame
        ed = np.asfortranarray(df.select(cols).reindex(train_patients).values)
        rs = cfg.random_state if cfg.freeze_mutual_select_init else None
        if cfg.knn_mutual_info and oi != 1:
            y_arr = np.asarray(y, float)[:, None]
            pmi = kraskov_mi(ed, y_arr)
            smi = kraskov_mi(ed[:, :1], y_arr)
            dmi = kraskov_mi(ed[:, 1:], y_arr)
            return pmi > cfg.edge_select_threshold * max(smi, dmi)
        fn = native.mi_classif if cfg.mutual_classif else native.mi_regression
        pmi = fn(pca_one(ed), y, random_state=rs)
        smi = fn(ed[:, :1], y, random_state=rs)
        dmi = fn(ed[:, 1:], y, random_state=rs)
        return bool(pmi > cfg.edge_select_threshold * max(smi, dmi))

    def merge_graph2(self, device="cuda") -> Optional[Graph]:
        """edge_type 'merge''s secondary graph (cohort.py:589-633, reference
        process_grn_edge, multiloader.py:276-289): the GRN edges both ways,
        in gene-index space, not the 3 * gene + omics slot space of the
        primary edges (the reference's quirk, kept: each GRN edge lands on
        slot gene_idx), self-looped for sage / rsage / gat, padded to a
        multiple of 2,048 edges (fold's default edge_bucket), with the K1
        plans on ``device``.  The same for every fold; built once per
        device."""
        if self.edges2 is None:
            return None
        key = str(device)
        if key in self._graph2_cache:
            return self._graph2_cache[key]
        nm = self.node_map
        es, ats = [], []
        for node_id in self.edges2:
            for (s, d), a in zip(self.edges2[node_id], self.edge_attrs2[node_id]):
                if s in nm and d in nm:
                    es.append([nm[s], nm[d]])
                    ats.append([a])
                    es.append([nm[d], nm[s]])
                    ats.append([a])
        ei = np.array(es, np.int32).T if es else np.zeros((2, 0), np.int32)
        ea = np.array(ats, np.float32) if ats else np.zeros((0, 1), np.float32)
        g = Graph.from_edges(ei, ea, self.num_nodes)
        if self.cfg.gnn_name.lower() in ("sage", "rsage", "gat"):
            g = g.with_self_loops()
        g = g.pad_edges_to(max(-(-g.n_edges // 2048) * 2048, 2048))
        g = g.with_sorted_meta(device)
        self._graph2_cache[key] = g
        return g

    def build_edges(
        self, info_mask: np.ndarray, train_idx: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """MI-selected intra-omics + cross-omics edges in node-slot space
        (reference recalculate_edge_bo_selected_gene :581-700).  The selected
        sets are built and walked exactly as the JAX package's, so the edge
        list comes out in the same order.  With edge_select, each intra-omics
        edge must pass _edge_mi_valid over the training patients."""
        cfg = self.cfg
        selected = [set(), set(), set()]
        for i, r in enumerate(self.rows):
            if info_mask[i, 0] > 0:
                selected[r.omics].add(r.entrez)
        train_patients = ([self.patients[i] for i in train_idx]
                          if train_idx is not None else [])
        y = self.labels()[train_idx].tolist() if train_idx is not None else []

        edges, attrs = [], []
        nm = self.node_map
        for oi, sel in enumerate(selected):
            if str(oi) in cfg.mute_edge:
                continue
            for e in sel:
                if e not in self.edges or e not in nm:
                    continue
                for (s, d), a in zip(self.edges[e], self.edge_attrs[e]):
                    if d in sel and d in nm:
                        if not self._edge_mi_valid(s, d, oi, train_patients, y):
                            continue
                        edges.append([3 * nm[s] + oi, 3 * nm[d] + oi])
                        attrs.append([a])
                        if cfg.bidir_edge:
                            edges.append([3 * nm[d] + oi, 3 * nm[s] + oi])
                            attrs.append([a])
        intra = len(edges)

        mt_attr = -1.0 if cfg.reverse_mt_attr else 1.0
        for e in selected[0]:
            if e not in nm:
                continue
            if cfg.construct_cnv_mrna_edge and e in selected[1]:
                edges.append([3 * nm[e] + 1, 3 * nm[e] + 0])
                attrs.append([1.0])
            if cfg.construct_mt_mrna_edge and e in selected[2]:
                edges.append([3 * nm[e] + 2, 3 * nm[e] + 0])
                attrs.append([mt_attr])
            if cfg.construct_mrna_cnv_edge and e in selected[1]:
                edges.append([3 * nm[e] + 0, 3 * nm[e] + 1])
                attrs.append([1.0])
            if cfg.construct_mrna_mt_edge and e in selected[2]:
                edges.append([3 * nm[e] + 0, 3 * nm[e] + 2])
                attrs.append([mt_attr])
        if not edges:
            return np.zeros((2, 0), np.int32), np.zeros((0, 1), np.float32), 0
        return np.array(edges, np.int32).T, np.array(attrs, np.float32), intra

    def class_weight(self, train_idx: np.ndarray) -> np.ndarray:
        """(max_count/count)^weight_power per class (reference :321-326)."""
        y = self.labels()[train_idx]
        counts = np.array([(y == 0).sum(), (y == 1).sum()], np.float64)
        counts = np.maximum(counts, 1)
        return (counts.max() / counts) ** self.cfg.weight_power

    def fold(
        self,
        train_idx: np.ndarray,
        fold_i: int,
        device="cuda",
        pad_edges_to: Optional[int] = None,
        edge_bucket: int = 2048,
    ) -> FoldData:
        """The per-fold derivation (train.py:290-307 of the reference): MI
        mask, PCA seeds and reorder, edges, then the graph: self loops for
        sage / rsage / gat, real edges padded up to a multiple of
        edge_bucket, the windowed plan when the config asks for it and the
        fold has at least cfg.windowed_min_edges real edges (cohort.py:
        859-887), and the kernels' plans on ``device``."""
        cfg = self.cfg
        t0 = time.perf_counter()
        mask, mi = self.mutual_mask(train_idx, fold_i)
        t_mi = time.perf_counter()
        seed, attr, reorder, pathway_adj = self._pathway_pca(mask)
        t_pca = time.perf_counter()
        if reorder is None:
            reorder = (
                self.initial_reorder_idxs
                if self.initial_reorder_idxs is not None
                else np.arange(self.n_pathways, dtype=np.int32)
            )
        edge_index, edge_attr, _ = self.build_edges(mask, train_idx)
        t_edges = time.perf_counter()
        graph = Graph.from_edges(edge_index, edge_attr, self.num_nodes)
        if cfg.gnn_name.lower() in ("sage", "rsage", "gat"):
            graph = graph.with_self_loops()
        if pad_edges_to is None and edge_bucket:
            pad_edges_to = max(-(-graph.n_edges // edge_bucket) * edge_bucket, edge_bucket)
        if pad_edges_to is not None:
            graph = graph.pad_edges_to(pad_edges_to)
        if (cfg.windowed_spmm and cfg.kernel_backend == "pallas"
                and graph.n_edges >= cfg.windowed_min_edges):
            # gene-grouped windows: perm_group=3 keeps a gene's three omics
            # slots together; below windowed_min_edges the composed path runs
            graph = graph.with_window_meta(perm_group=3)
        n_real_edges = graph.n_edges
        graph = graph.with_sorted_meta(device)
        ctx = make_fold_context(
            graph, self.gene_pca_match, self.raw_indice, mask, reorder,
            pca_seed=seed, n_pathways=self.n_pathways, device=device,
        )
        ctx = dataclasses.replace(ctx, pathway_adj=torch.as_tensor(pathway_adj).to(ctx.device))
        if cfg.edge_type == "merge":
            ctx = dataclasses.replace(ctx, graph2=self.merge_graph2(device))
        t_graph = time.perf_counter()
        pos = {p: i for i, p in enumerate(self.pca_patients)}
        return FoldData(
            ctx=ctx,
            info_mask=mask,
            mutual_info=mi,
            pca_seed=seed,
            class_weight=self.class_weight(train_idx),
            pathway_node_attr=attr[[pos[p] for p in self.patients]],
            reorder_idxs=reorder,
            edge_count=n_real_edges,
            seconds={"mi": t_mi - t0, "pca": t_pca - t_mi,
                     "edges": t_edges - t_pca, "graph": t_graph - t_edges},
        )

    # ------------------------------------------------------------------ #
    # the gene-level graph (DeeperGCN)
    # ------------------------------------------------------------------ #
    def gene_level_features(self) -> np.ndarray:
        """(n_patients, node_size + P, 3 [+2]) per-gene omics features, the
        pathway rows zero (cohort.py:701-711); with cfg.mul_attr the
        mrna*cnv and mrna*mt products are appended."""
        x = self.X.reshape(len(self.patients), -1, 3)
        if self.cfg.mul_attr:
            prods = np.stack([x[..., 0] * x[..., 1], x[..., 0] * x[..., 2]], axis=-1)
            x = np.concatenate([x, prods], axis=-1)
        return x

    def gene_level_graph(self) -> Tuple[np.ndarray, np.ndarray]:
        """Gene edges in both directions, then, with pathway_global_node,
        gene -> pathway-node edges (cohort.py:713-748).  Returns
        (edge_index (2, E) int32, edge_attr (E, 2) float32): column 0 the
        weight, column 1 the one-hot edge id.  A gene edge's id is
        int(weight), as the reference's long cast gives (0 for a GRNBoost2
        weight below 1); pathway edges count up from 0 in the order of
        used_pathways and their genes' sorted entrez ids, and
        pathway_edge_num is set to their count."""
        cfg, nm = self.cfg, self.node_map
        edges, attrs = [], []
        for src, lst in self.edges.items():
            for (s, d), a in zip(lst, self.edge_attrs[src]):
                if s in nm and d in nm:
                    edges.append([nm[s], nm[d]])
                    attrs.append([a, float(int(a))])
                    edges.append([nm[d], nm[s]])
                    attrs.append([a, float(int(a))])
        count = 0
        n_genes = self.node_size
        if cfg.pathway_global_node:
            for pi, pathway in enumerate(self.used_pathways):
                entrez = self.kegg.entrez_of(pathway).astype(int)
                for e in np.intersect1d(entrez, list(nm)):
                    edges.append([nm[int(e)], n_genes + pi])
                    attrs.append([float(count), float(count)])
                    if cfg.bi_global_node:
                        edges.append([n_genes + pi, nm[int(e)]])
                        attrs.append([float(count), float(count)])
                    count += 1
        self.pathway_edge_num = count
        return (np.array(edges, np.int32).reshape(-1, 2).T,
                np.array(attrs, np.float32).reshape(-1, 2))

    def deepergcn_fold(self, train_idx: np.ndarray, fold_i: int, device="cuda") -> FoldData:
        """DeeperGCN's fold (cohort.py:750-775): the MI mask, the
        per-pathway PCA attrs (over the masked rows with
        cfg.mutual_info_pca), the gene-level graph (no self loops, no
        padding) and, with one-hot edge attrs, the edge-id lookup plan, on
        ``device``; seconds by stage in ``seconds``.  The context carries
        the cohort's gene_pca_match and raw_indice unread, as JAX's does:
        they index the 3-slot node layout, which this graph does not have,
        so explain's pathway_attributions fails on them as JAX's does
        (IndexError); pca_rows and the PCA-row gather plan are empty."""
        cfg = self.cfg
        t0 = time.perf_counter()
        mask, mi = self.mutual_mask(train_idx, fold_i)
        t_mi = time.perf_counter()
        _, attr, _, _ = self._pathway_pca(mask if cfg.mutual_info_pca else None)
        t_pca = time.perf_counter()
        ei, ea = self.gene_level_graph()
        t_edges = time.perf_counter()
        graph = Graph.from_edges(ei, ea, self.node_size + self.n_pathways)
        graph = graph.with_sorted_meta(device)
        onehot = cfg.use_edge_attr and cfg.global_edge == "onehot"
        ctx = make_fold_context(
            graph, np.zeros(0, np.int64), np.zeros(0, np.int64),
            n_pathways=self.n_pathways, device=device,
            edge_vocab=max(self.pathway_edge_num, 1) if onehot else None,
        )
        ctx = dataclasses.replace(
            ctx,
            gene_pca_match=torch.as_tensor(self.gene_pca_match, dtype=torch.int64).to(ctx.device),
            raw_indice=torch.as_tensor(self.raw_indice, dtype=torch.int64).to(ctx.device))
        t_graph = time.perf_counter()
        pos = {p: i for i, p in enumerate(self.pca_patients)}
        attr = attr[[pos[p] for p in self.patients]]
        return FoldData(
            ctx=ctx,
            info_mask=mask,
            mutual_info=mi,
            pca_seed=np.zeros((self.num_pca_rows, cfg.pca_dim), np.float32),
            class_weight=self.class_weight(train_idx),
            pathway_node_attr=attr,
            edge_count=graph.n_edges,
            seconds={"mi": t_mi - t0, "pca": t_pca - t_mi,
                     "edges": t_edges - t_pca, "graph": t_graph - t_edges},
            raw=attr.astype(np.float32),
        )

    def multiomix_vnode_data(self, fold: FoldData, device="cuda"):
        """MultiOmixGCN's per-omics data (cohort.py:777-821), on ``device``:
        for mrna, cnv and mt, (graphs, masks, attrs) keyed by omics.  The
        graph links every gene of a used pathway's NaN-free columns of that
        omics (node_map index) to the pathway's virtual node (node_size +
        pathway index), with the (E, 2) attrs of the pathway's first two
        PCA components of that omics taken from patient 0 of the fold
        (pn[0, pi, ...], as JAX takes them); it is receiver-sorted with its
        K1 / K3 plans (Graph.with_sorted_meta).  An omics with no edge gets
        an empty graph padded to 128 edge slots, without attrs.  masks:
        (N, 1) float32, 1 at the pathway rows an edge reaches.  attrs:
        (patients, P, 2) float32, every patient's two components."""
        nm, n_genes, k = self.node_map, self.node_size, self.cfg.pca_dim
        N = n_genes + self.n_pathways
        pn = fold.pathway_node_attr  # (n, P, 3 * pca_dim)
        graphs, masks, attrs = {}, {}, {}
        for oi, name in enumerate(("mrna", "cnv", "mt")):
            edges, eattrs = [], []
            for pi, pathway in enumerate(self.used_pathways):
                for c in self._pathway_columns(pathway, OMICS[oi]):
                    if int(c) in nm:
                        edges.append([nm[int(c)], n_genes + pi])
                        eattrs.append(pn[0, pi, oi * k: oi * k + 2])
            m = np.zeros((N, 1), np.float32)
            if edges:
                ei = np.array(edges, np.int32)
                g = Graph.from_edges(ei.T, np.array(eattrs, np.float32), N)
                m[ei[:, 1]] = 1.0
            else:
                g = Graph.from_edges(np.zeros((2, 0)), None, N, pad_to=128)
            graphs[name] = g.with_sorted_meta(device)
            masks[name] = torch.from_numpy(m).to(graphs[name].senders.device)
            attrs[name] = torch.from_numpy(
                np.ascontiguousarray(pn[:, :, oi * k: oi * k + 2], np.float32)
            ).to(masks[name].device)
        return graphs, masks, attrs
