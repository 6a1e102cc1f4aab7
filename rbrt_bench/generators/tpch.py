"""TPC-H (specification v3, clause 4.2.3's column distributions) as a
snowflake: lineitem ⋈ orders ⋈ customer ⋈ nation, lineitem ⋈ part,
lineitem ⋈ supplier, with ``l_extendedprice`` the label.

Join keys carry one name in both tables (``orderkey``, ``custkey``,
``nationkey``, ``partkey``, ``suppkey``), so the natural join is TPC-H's
key join; the supplier's nation key is ``s_nationkey``, a feature and no
key, so the join stays acyclic.  Dates are days since 1992-01-01, codes
are integers.  Order keys are sparse as the specification makes them
(the first 8 of each 32); the refresh functions insert orders at the
unused keys (RF1) and delete orders oldest first (RF2: the loaded orders
in key order, then those RF1 inserted), each SF·1500 orders a batch.  Every seed draws the same sizes: each order's
1-7 lineitems come from one balanced multiset, shuffled.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from rbrt_bench.lib.data import Dataset, TableData, balanced_choice, seed_rng

END_ORDER_DAY = 2556 - 151       # 1998-12-31 less 151 days
CURRENT_DAY = 1263               # 1995-06-17
REGION_OF_NATION = np.array([0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                             4, 2, 3, 3, 1], np.int64)

LINEITEM_FEATURES = ("l_linenumber", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                     "l_returnflag", "l_linestatus", "l_shipdate", "l_commitdate",
                     "l_receiptdate", "l_shipinstruct", "l_shipmode")
ORDER_FEATURES = ("o_orderstatus", "o_totalprice", "o_orderdate", "o_orderpriority")


def _sizes(cfg: dict) -> Dict[str, int]:
    sf = float(cfg["scale_factor"])
    return {"orders": int(1_500_000 * sf), "customer": int(150_000 * sf),
            "part": int(200_000 * sf), "supplier": int(10_000 * sf),
            "refresh_orders": int(1500 * sf)}


def _order_key(i: np.ndarray) -> np.ndarray:
    """The i-th loaded order's key: the first 8 of each 32."""
    return (i // 8) * 32 + i % 8 + 1


def _refresh_key(i: np.ndarray) -> np.ndarray:
    """The i-th key left free for the refresh functions."""
    return (i // 24) * 32 + 8 + i % 24 + 1


def retail_price(partkey: np.ndarray) -> np.ndarray:
    return ((90000 + (partkey // 10) % 20001 + 100 * (partkey % 1000)) / 100.0)


def _orders_and_lines(rng, keys: np.ndarray, n_cust: int, n_part: int, n_supp: int):
    """Orders at ``keys`` with their lineitems (clause 4.2.3)."""
    n = len(keys)
    n_lines = balanced_choice(rng, n, 7) + 1
    custkey = rng.integers(1, n_cust + 1, n)
    custkey = np.where(custkey % 3 == 0, np.maximum(custkey - 1, 1), custkey)  # a third never orders
    orderdate = rng.integers(0, END_ORDER_DAY + 1, n)
    priority = rng.integers(0, 5, n)

    o_of_line = np.repeat(np.arange(n), n_lines)
    m = len(o_of_line)
    linenumber = np.arange(m) - np.repeat(np.cumsum(n_lines) - n_lines, n_lines) + 1
    partkey = rng.integers(1, n_part + 1, m)
    i4 = rng.integers(0, 4, m)
    suppkey = (partkey + i4 * (n_supp // 4 + (partkey - 1) // n_supp)) % n_supp + 1
    quantity = rng.integers(1, 51, m)
    extended = np.round(quantity * retail_price(partkey), 2)
    discount = rng.integers(0, 11, m) / 100.0
    tax = rng.integers(0, 9, m) / 100.0
    shipdate = orderdate[o_of_line] + rng.integers(1, 122, m)
    commitdate = orderdate[o_of_line] + rng.integers(30, 91, m)
    receiptdate = shipdate + rng.integers(1, 31, m)
    returnflag = np.where(receiptdate <= CURRENT_DAY, rng.integers(0, 2, m), 2)   # R, A; N
    linestatus = (shipdate > CURRENT_DAY).astype(np.int64)                      # F 0, O 1
    lines = {
        "orderkey": keys[o_of_line].astype(np.int64), "partkey": partkey.astype(np.int64),
        "suppkey": suppkey.astype(np.int64), "l_linenumber": linenumber.astype(np.int64),
        "l_quantity": quantity.astype(np.int64),
        "l_extendedprice": extended.astype(np.float32),
        "l_discount": discount.astype(np.float32), "l_tax": tax.astype(np.float32),
        "l_returnflag": returnflag.astype(np.int64), "l_linestatus": linestatus,
        "l_shipdate": shipdate.astype(np.int64), "l_commitdate": commitdate.astype(np.int64),
        "l_receiptdate": receiptdate.astype(np.int64),
        "l_shipinstruct": rng.integers(0, 4, m).astype(np.int64),
        "l_shipmode": rng.integers(0, 7, m).astype(np.int64),
    }
    charge = extended * (1 + tax) * (1 - discount)
    total = np.bincount(o_of_line, weights=charge, minlength=n)
    n_open = np.bincount(o_of_line, weights=linestatus, minlength=n)
    status = np.where(n_open == 0, 0, np.where(n_open == n_lines, 1, 2))           # F, O, P
    orders = {
        "orderkey": keys.astype(np.int64), "custkey": custkey.astype(np.int64),
        "o_orderstatus": status.astype(np.int64),
        "o_totalprice": np.round(total, 2).astype(np.float32),
        "o_orderdate": orderdate.astype(np.int64), "o_orderpriority": priority.astype(np.int64),
        "o_shippriority": np.zeros(n, np.int64),
    }
    return orders, lines


def generate(cfg: dict, seed: int) -> Dataset:
    s = _sizes(cfg)
    rng = seed_rng(seed, 2)
    orders, lines = _orders_and_lines(rng, _order_key(np.arange(s["orders"])),
                                      s["customer"], s["part"], s["supplier"])
    nc, npart, ns = s["customer"], s["part"], s["supplier"]
    customer = {
        "custkey": np.arange(1, nc + 1, dtype=np.int64),
        "nationkey": rng.integers(0, 25, nc).astype(np.int64),
        "c_acctbal": np.round(rng.uniform(-999.99, 9999.99, nc), 2).astype(np.float32),
        "c_mktsegment": rng.integers(0, 5, nc).astype(np.int64),
    }
    nation = {"nationkey": np.arange(25, dtype=np.int64), "n_regionkey": REGION_OF_NATION.copy()}
    pk = np.arange(1, npart + 1, dtype=np.int64)
    mfgr = rng.integers(1, 6, npart)
    part = {
        "partkey": pk, "p_mfgr": mfgr.astype(np.int64),
        "p_brand": (mfgr * 10 + rng.integers(1, 6, npart)).astype(np.int64),
        "p_type": rng.integers(0, 150, npart).astype(np.int64),
        "p_size": rng.integers(1, 51, npart).astype(np.int64),
        "p_container": rng.integers(0, 40, npart).astype(np.int64),
        "p_retailprice": retail_price(pk).astype(np.float32),
    }
    supplier = {
        "suppkey": np.arange(1, ns + 1, dtype=np.int64),
        "s_nationkey": rng.integers(0, 25, ns).astype(np.int64),
        "s_acctbal": np.round(rng.uniform(-999.99, 9999.99, ns), 2).astype(np.float32),
    }
    return Dataset([
        TableData("lineitem", lines, LINEITEM_FEATURES),
        TableData("orders", orders, ORDER_FEATURES),
        TableData("customer", customer, ("c_acctbal", "c_mktsegment")),
        TableData("nation", nation, ("n_regionkey",)),
        TableData("part", part, ("p_mfgr", "p_brand", "p_type", "p_size", "p_container",
                                 "p_retailprice")),
        TableData("supplier", supplier, ("s_nationkey", "s_acctbal")),
    ], label=("lineitem", "l_extendedprice"))


class RefreshStream:
    """TPC-H's refresh functions, alternated: batch 2i is RF1 (insert
    SF·1500 new orders at free keys, 1-7 lineitems each), batch 2i + 1 is
    RF2 (delete SF·1500 orders and their lineitems: the loaded orders in
    key order, and once they are gone, RF1's orders in the order they
    came).  Batch b is the same for a seed whoever asks for it."""

    def __init__(self, cfg: dict, seed: int):
        self.cfg, self.seed = cfg, seed
        self.s = _sizes(cfg)

    def batch(self, b: int) -> Tuple[str, object]:
        k = self.s["refresh_orders"]
        i = b // 2
        if b % 2 == 0:
            rng = seed_rng(self.seed, 3, i)
            keys = _refresh_key(np.arange(i * k, (i + 1) * k))
            orders, lines = _orders_and_lines(rng, keys, self.s["customer"], self.s["part"],
                                              self.s["supplier"])
            return "insert", (orders, lines)
        loaded = self.s["orders"] // k
        keys = (_order_key(np.arange(i * k, (i + 1) * k)) if i < loaded
                else _refresh_key(np.arange((i - loaded) * k, (i - loaded + 1) * k)))
        return "delete", keys.astype(np.int64)


def apply_refresh(ds: Dataset, batches: List[Tuple[str, object]]) -> Dataset:
    """The live database after the batches, in order: the plain semantics
    of RF1 and RF2 (the reference's side; rows keep no slots)."""
    orders = {c: [v] for c, v in ds.table("orders").columns.items()}
    lines = {c: [v] for c, v in ds.table("lineitem").columns.items()}
    for kind, payload in batches:
        if kind == "insert":
            o, l = payload
            for c in orders:
                orders[c].append(o[c])
            for c in lines:
                lines[c].append(l[c])
        else:
            okeys = np.concatenate(orders["orderkey"])
            keep_o = ~np.isin(okeys, payload)
            orders = {c: [np.concatenate(v)[keep_o]] for c, v in orders.items()}
            lkeys = np.concatenate(lines["orderkey"])
            keep_l = ~np.isin(lkeys, payload)
            lines = {c: [np.concatenate(v)[keep_l]] for c, v in lines.items()}
    new = {"orders": {c: np.concatenate(v) for c, v in orders.items()},
           "lineitem": {c: np.concatenate(v) for c, v in lines.items()}}
    return Dataset([TableData(t.name, new.get(t.name, t.columns), t.features)
                    for t in ds.tables], ds.label)
