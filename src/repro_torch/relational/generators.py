"""Synthetic relational workloads (star / chain / snowflake schemas).

These generate the acyclic multi-table datasets the paper trains on:
τ tables, d features, join keys with controllable fanout, and a label
column on a designated fact table whose ground truth is a piecewise
(tree-like) or linear function of features spread across tables.  The
columns are numpy arrays drawn from ``np.random.default_rng(seed)``;
``device`` is where the built :class:`Schema` puts its tensors.

:func:`delta_stream` and :func:`drift_stream` draw table deltas for the
incremental workloads; for the same seed and live rows they yield the
same batches as the JAX package's generators.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..core.schema import Schema, Table
from ..incremental.deltas import TableDelta


def _label(rng, feats, kind: str):
    """Piecewise/tree-ish or linear ground-truth label from a feature dict."""
    cols = list(feats.values())
    y = np.zeros_like(cols[0], dtype=np.float64)
    if kind == "linear":
        for i, c in enumerate(cols):
            y = y + ((-1) ** i) * 0.7 * c
    else:  # piecewise: axis-aligned steps — realizable by a shallow tree
        for i, c in enumerate(cols):
            thr = np.median(c)
            y = y + np.where(c >= thr, float(i + 1), -float(i + 1))
    y = y + 0.05 * rng.standard_normal(y.shape)
    return y.astype(np.float32)


def star_schema(
    seed: int = 0,
    n_fact: int = 512,
    n_dim: int = 64,
    n_dim_tables: int = 2,
    feats_per_dim: int = 2,
    fact_feats: int = 2,
    label_kind: str = "piecewise",
    dup_keys: bool = True,
    device="cuda",
) -> Schema:
    """Fact table joins `n_dim_tables` dimension tables on distinct keys.

    Fanout: many fact rows share a dimension key (dup_keys) — the regime
    where relational algorithms beat materialization.
    """
    rng = np.random.default_rng(seed)
    fact = {}
    dims = []
    for di in range(n_dim_tables):
        kc = f"k{di}"
        fact[kc] = (
            rng.integers(0, n_dim, n_fact) if dup_keys else rng.permutation(n_fact) % n_dim
        ).astype(np.int64)
        dcols = {kc: np.arange(n_dim, dtype=np.int64)}
        for fi in range(feats_per_dim):
            dcols[f"d{di}f{fi}"] = rng.standard_normal(n_dim).astype(np.float32)
        dims.append(dcols)
    for fi in range(fact_feats):
        fact[f"x{fi}"] = rng.standard_normal(n_fact).astype(np.float32)

    # label depends on features across tables (gathered through the keys)
    feats = {f"x{fi}": fact[f"x{fi}"] for fi in range(fact_feats)}
    for di, d in enumerate(dims):
        for fi in range(feats_per_dim):
            feats[f"d{di}f{fi}"] = d[f"d{di}f{fi}"][fact[f"k{di}"]]
    fact["y"] = _label(rng, feats, label_kind)

    ft = Table(name="fact", columns=fact,
               feature_columns=tuple(f"x{fi}" for fi in range(fact_feats)))
    dim_tables = [
        Table(name=f"dim{di}", columns=d,
              feature_columns=tuple(c for c in d if not c.startswith("k")))
        for di, d in enumerate(dims)
    ]
    return Schema([ft] + dim_tables, label=("fact", "y"), device=device)


def snowflake_schema(
    seed: int = 0,
    n_fact: int = 512,
    n_dim: int = 32,
    n_sub: int = 8,
    n_dim_tables: int = 2,
    feats_per_dim: int = 1,
    feats_per_sub: int = 1,
    fact_feats: int = 1,
    label_kind: str = "piecewise",
    device="cuda",
) -> Schema:
    """Star with normalized dimensions: fact ⋈ dim_i ⋈ sub_i (two join
    hops from the fact table)."""
    rng = np.random.default_rng(seed)
    fact = {}
    dims, subs = [], []
    for di in range(n_dim_tables):
        kc, sc = f"k{di}", f"s{di}"
        fact[kc] = rng.integers(0, n_dim, n_fact).astype(np.int64)
        scols = {sc: np.arange(n_sub, dtype=np.int64)}
        for fi in range(feats_per_sub):
            scols[f"s{di}f{fi}"] = rng.standard_normal(n_sub).astype(np.float32)
        subs.append(Table(
            name=f"sub{di}", columns=scols,
            feature_columns=tuple(f"s{di}f{fi}" for fi in range(feats_per_sub)),
        ))
        dcols = {kc: np.arange(n_dim, dtype=np.int64),
                 sc: rng.integers(0, n_sub, n_dim).astype(np.int64)}
        for fi in range(feats_per_dim):
            dcols[f"d{di}f{fi}"] = rng.standard_normal(n_dim).astype(np.float32)
        dims.append(dcols)
    for fi in range(fact_feats):
        fact[f"x{fi}"] = rng.standard_normal(n_fact).astype(np.float32)

    # label depends on features across all three levels
    feats = {f"x{fi}": fact[f"x{fi}"] for fi in range(fact_feats)}
    for di in range(n_dim_tables):
        dk = fact[f"k{di}"]
        sk = dims[di][f"s{di}"][dk]
        for fi in range(feats_per_dim):
            feats[f"d{di}f{fi}"] = dims[di][f"d{di}f{fi}"][dk]
        for fi in range(feats_per_sub):
            feats[f"s{di}f{fi}"] = subs[di].columns[f"s{di}f{fi}"][sk]
    fact["y"] = _label(rng, feats, label_kind)

    ft = Table(name="fact", columns=fact,
               feature_columns=tuple(f"x{fi}" for fi in range(fact_feats)))
    dim_tables = [
        Table(name=f"dim{di}", columns=d,
              feature_columns=tuple(c for c in d if c.startswith("d")))
        for di, d in enumerate(dims)
    ]
    return Schema([ft] + dim_tables + subs, label=("fact", "y"), device=device)


def chain_schema(
    seed: int = 0,
    n_rows: int = 256,
    n_tables: int = 3,
    feats_per_table: int = 1,
    fanout: int = 2,
    label_kind: str = "piecewise",
    device="cuda",
) -> Schema:
    """T_1(k1,…) — T_2(k1,k2,…) — … — T_τ(k_{τ-1},…): a path join.

    Each adjacent pair shares one key; key multiplicity = `fanout` on the
    child side, so |J| grows ~ n_rows · fanout^{τ-1} while storage stays
    linear.
    """
    rng = np.random.default_rng(seed)
    tables = []
    n_keys = max(1, n_rows // fanout)
    first = {"k0": rng.integers(0, n_keys, n_rows).astype(np.int64)}
    for fi in range(feats_per_table):
        first[f"t0f{fi}"] = rng.standard_normal(n_rows).astype(np.float32)
    first["y"] = np.zeros(n_rows, np.float32)  # filled below
    tables.append(first)
    for ti in range(1, n_tables):
        n_t = n_keys * fanout
        cols = {f"k{ti-1}": (np.arange(n_t) % n_keys).astype(np.int64)}
        if ti < n_tables - 1:
            cols[f"k{ti}"] = rng.integers(0, n_keys, n_t).astype(np.int64)
        for fi in range(feats_per_table):
            cols[f"t{ti}f{fi}"] = rng.standard_normal(n_t).astype(np.float32)
        tables.append(cols)
        n_keys = max(1, n_t // fanout) if ti < n_tables - 1 else n_keys

    feats = {f"t0f{fi}": tables[0][f"t0f{fi}"] for fi in range(feats_per_table)}
    tables[0]["y"] = _label(rng, feats, label_kind)

    out = []
    for ti, cols in enumerate(tables):
        fc = tuple(c for c in cols if c.startswith(f"t{ti}f"))
        out.append(Table(name=f"t{ti}", columns=cols, feature_columns=fc))
    return Schema(out, label=("t0", "y"), device=device)


# ---------------------------------------------------------------------------
# Delta streams (incremental-maintenance workloads)
# ---------------------------------------------------------------------------

def _key_columns(schema: Schema) -> set:
    """Join-key columns under natural-join semantics: any column name
    appearing in more than one table."""
    seen, keys = set(), set()
    for t in schema.tables:
        for c in t.columns:
            (keys if c in seen else seen).add(c)
    return keys


def delta_stream(
    schema: Schema,
    live_of: Callable[[str], np.ndarray],
    seed: int = 0,
    n_batches: int = 8,
    ops_per_batch: int = 6,
    tables: Optional[Sequence[str]] = None,
    p_insert: float = 0.35,
    p_delete: float = 0.3,
    new_key_prob: float = 0.15,
    min_live: int = 4,
) -> Iterator[List[TableDelta]]:
    """Random insert/delete/update batches against a live relational DB.

    ``live_of(table)`` must return the CURRENT live slot ids (deltas are
    generated lazily per batch, after the caller applied the previous
    one — e.g. ``ms.live_rows``).  Inserted key values are drawn from
    the observed key domain, except with ``new_key_prob`` a previously
    unseen key is minted (exercising the append-only key dictionaries);
    updates rewrite the non-key feature columns of live rows.  Deletes
    never shrink a table below ``min_live`` rows.
    """
    rng = np.random.default_rng(seed)
    key_cols = _key_columns(schema)
    names = [t.name for t in (schema.tables if tables is None
                              else [schema.table(n) for n in tables])]
    # observed key domains (grown as new keys are minted)
    domains: Dict[str, np.ndarray] = {}
    for t in schema.tables:
        for c in t.columns:
            if c in key_cols:
                vals = np.unique(np.asarray(t.col(c)))
                domains[c] = (np.union1d(domains[c], vals)
                              if c in domains else vals)

    def _insert_row(t: Table) -> Dict[str, np.ndarray]:
        row = {}
        for c, v in t.columns.items():
            v = np.asarray(v)
            if c in key_cols:
                if rng.random() < new_key_prob:
                    nk = domains[c].max() + int(rng.integers(1, 4))
                    domains[c] = np.append(domains[c], nk)
                    row[c] = np.asarray([nk], v.dtype)
                else:
                    row[c] = np.asarray([rng.choice(domains[c])], v.dtype)
            else:
                row[c] = rng.standard_normal(1).astype(v.dtype)
        return row

    for _ in range(n_batches):
        per_table: Dict[str, Dict] = {
            n: {"ins": [], "del": set(), "upd": set()} for n in names
        }
        for _ in range(ops_per_batch):
            name = names[int(rng.integers(len(names)))]
            t = schema.table(name)
            acc = per_table[name]
            r = rng.random()
            live = np.setdiff1d(live_of(name), np.fromiter(
                acc["del"] | acc["upd"], np.int64, len(acc["del"]) + len(acc["upd"])
            ))
            if r < p_insert or len(live) <= min_live:
                acc["ins"].append(_insert_row(t))
            elif r < p_insert + p_delete:
                acc["del"].add(int(rng.choice(live)))
            else:
                acc["upd"].add(int(rng.choice(live)))
        batch: List[TableDelta] = []
        for name, acc in per_table.items():
            t = schema.table(name)
            inserts = deletes = updates = None
            if acc["ins"]:
                inserts = {c: np.concatenate([r[c] for r in acc["ins"]])
                           for c in t.columns}
            if acc["del"]:
                deletes = np.asarray(sorted(acc["del"]), np.int64)
            if acc["upd"]:
                slots = np.asarray(sorted(acc["upd"]), np.int64)
                upd_cols = [c for c in t.feature_columns if c not in key_cols]
                if upd_cols:
                    updates = (slots, {
                        c: rng.standard_normal(len(slots)).astype(
                            np.asarray(t.col(c)).dtype)
                        for c in upd_cols
                    })
            if inserts or deletes is not None or updates is not None:
                batch.append(TableDelta(table=name, inserts=inserts,
                                        deletes=deletes, updates=updates))
        if batch:
            yield batch


def drift_stream(
    schema: Schema,
    live_of: Callable[[str], np.ndarray],
    seed: int = 0,
    n_batches: int = 6,
    rows_per_batch: int = 8,
    feature_tables: Optional[Sequence[str]] = None,
    label_shift: float = 0.75,
    label_scale: float = 0.5,
) -> Iterator[List[TableDelta]]:
    """Concept-drift workload for incremental RETRAINING benchmarks.

    Unlike :func:`delta_stream` (which churns rows but leaves the
    label-generating process alone — a serving workload), each batch
    here rewrites the feature values of live rows on one rotating
    feature table AND shifts the labels of a random block of live
    label-table rows.  Label perturbations are expressed in units of the
    CURRENT live labels' std (y ← μ + shift·σ + scale·σ·ε), so the
    drift severity is comparable across workloads whose label variances
    differ by orders of magnitude.  The maintained aggregates absorb the
    delta cheaply, but the *model* goes stale — the regime where
    ``IncrementalBooster.refit`` must append trees, not just refresh
    messages."""
    rng = np.random.default_rng(seed)
    key_cols = _key_columns(schema)
    names = list(feature_tables) if feature_tables is not None else [
        t.name for t in schema.tables
    ]
    lbl_t, lbl_c = schema.label_table, schema.label_column
    # drift severity in units of the ORIGINAL label distribution (the
    # dynamic store's current values aren't visible through `live_of`,
    # and a fixed reference keeps repeated shifts from compounding)
    y0 = np.asarray(schema.table(lbl_t).col(lbl_c)).astype(np.float64)
    mu, sd = float(y0.mean()), float(y0.std() + 1e-9)
    for b in range(n_batches):
        batch: List[TableDelta] = []
        name = names[b % len(names)]
        t = schema.table(name)
        live = live_of(name)
        k = min(rows_per_batch, len(live))
        if k:
            slots = np.sort(rng.choice(live, size=k, replace=False))
            cols = {
                c: rng.standard_normal(k).astype(np.asarray(t.col(c)).dtype)
                for c in t.feature_columns if c not in key_cols
            }
            if cols:
                batch.append(TableDelta(table=name, updates=(slots, cols)))
        livef = live_of(lbl_t)
        kf = min(rows_per_batch, len(livef))
        if kf:
            fslots = np.sort(rng.choice(livef, size=kf, replace=False))
            newy = (mu + label_shift * sd
                    + label_scale * sd * rng.standard_normal(kf)
                    ).astype(np.float32)
            batch.append(TableDelta(table=lbl_t,
                                    updates=(fslots, {lbl_c: newy})))
        if batch:
            yield batch
