"""Synthetic relational workloads (star / chain / snowflake schemas).

These generate the acyclic multi-table datasets the paper trains on:
τ tables, d features, join keys with controllable fanout, and a label
column on a designated fact table whose ground truth is a piecewise
(tree-like) or linear function of features spread across tables.  The
columns are numpy arrays drawn from ``np.random.default_rng(seed)``;
``device`` is where the built :class:`Schema` puts its tensors.
"""
from __future__ import annotations

import numpy as np

from ..core.schema import Schema, Table


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
