"""The Corporación Favorita grocery-sales schema (Kaggle, 2017), as LMFAO
(Schleich et al., SIGMOD 2019) joins it: six tables whose natural join
keeps every sale.

``sales`` (date, store_nbr, item_nbr, onpromotion; label unit_sales) is
the fact table.  ``items`` and ``stores`` are keyed by their numbers,
``transactions`` by (date, store_nbr), ``oil`` and ``holidays`` by date,
one row a date (LMFAO's preprocessing: a date without a holiday holds
type 0).  Categoricals are integer codes, used as numeric features;
dates are days since 2013-01-01.  The cut keeps the most recent
``days`` days, with ``sales_rows`` sales spread evenly over them; the
items sold follow a Zipf law over the items (``assumed.item_zipf``).
"""
from __future__ import annotations

import numpy as np

from rbrt_bench.lib.data import Dataset, TableData, seed_rng

LAST_DAY = 1683          # 2017-08-15, the last date of the published train set


def generate(cfg: dict, seed: int, sales_rows: int = None, days: int = None) -> Dataset:
    n = int(sales_rows or cfg["sales_rows"])
    days = int(days or cfg["days"])
    n_stores, n_items = int(cfg["stores"]), int(cfg["items"])
    a = cfg["assumed"]
    rng = seed_rng(seed, 1)

    # stores: city, state, type, cluster codes; a store's share of sales
    stores = TableData("stores", {
        "store_nbr": np.arange(1, n_stores + 1, dtype=np.int64),
        "city": rng.integers(0, cfg["cities"], n_stores).astype(np.int64),
        "state": rng.integers(0, cfg["states"], n_stores).astype(np.int64),
        "type": rng.integers(0, cfg["store_types"], n_stores).astype(np.int64),
        "cluster": rng.integers(0, cfg["clusters"], n_stores).astype(np.int64),
    }, ("city", "state", "type", "cluster"))
    store_w = rng.lognormal(0.0, a["store_share_sigma"], n_stores)
    store_w /= store_w.sum()

    # items: sparse item numbers, family, class within family, perishable
    item_nbr = np.sort(rng.choice(np.arange(96995, 2134245), n_items, replace=False))
    family = np.minimum(rng.zipf(1.5, n_items) - 1, cfg["families"] - 1).astype(np.int64)
    per_family = cfg["classes"] // cfg["families"]
    klass = family * per_family + rng.integers(0, per_family, n_items)
    perishable = (family % 4 == 0).astype(np.int64)
    items = TableData("items", {
        "item_nbr": item_nbr.astype(np.int64), "family": family,
        "class": klass.astype(np.int64), "perishable": perishable,
    }, ("family", "class", "perishable"))

    # per date: oil price (a random walk) and the day's holiday, if any
    dates = np.arange(LAST_DAY - days + 1, LAST_DAY + 1, dtype=np.int64)
    oil = TableData("oil", {
        "date": dates,
        "dcoilwtico": np.round(47.0 + np.cumsum(rng.normal(0, 0.8, days)), 2).astype(np.float32),
    }, ("dcoilwtico",))
    holiday = rng.random(days) < a["holiday_day_share"]
    h_type = np.where(holiday, rng.integers(1, cfg["holiday_types"], days), 0)
    locale = np.where(holiday, rng.integers(1, cfg["locales"] + 1, days), 0)
    holidays = TableData("holidays", {
        "date": dates, "h_type": h_type.astype(np.int64), "locale": locale.astype(np.int64),
        "transferred": (holiday & (rng.random(days) < 0.1)).astype(np.int64),
    }, ("h_type", "locale", "transferred"))

    # transactions: one row a (date, store)
    t_date = np.repeat(dates, n_stores)
    t_store = np.tile(stores.columns["store_nbr"], days)
    t_count = rng.poisson(1700 * n_stores * np.tile(store_w, days)).astype(np.int64)
    transactions = TableData("transactions", {
        "date": t_date, "store_nbr": t_store, "transactions": t_count,
    }, ("transactions",))

    # sales: even over the dates, stores by share, items by Zipf popularity
    day_ix = (np.arange(n) * days) // n
    s_store = rng.choice(n_stores, n, p=store_w)
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    item_p = ranks ** -a["item_zipf"]
    item_p /= item_p.sum()
    popular = rng.permutation(n_items)                 # which item has which rank
    s_item = popular[rng.choice(n_items, n, p=item_p)]
    promo = (rng.random(n) < a["promo_share"]).astype(np.int64)
    base = 40.0 * item_p[np.argsort(popular)][s_item] ** 0.35 * n_items ** 0.35
    mean = (base * (0.6 + 40 * store_w[s_store]) * (1.0 + 0.5 * promo)
            * (1.0 + 0.15 * (h_type[day_ix] > 0)) * (1.0 + 0.1 * ((dates[day_ix] % 7) >= 5)))
    units = rng.gamma(2.0, mean / 2.0)
    units = np.where(perishable[s_item] == 1, np.round(units, 3), np.round(units))
    sales = TableData("sales", {
        "date": dates[day_ix], "store_nbr": s_store.astype(np.int64) + 1,
        "item_nbr": item_nbr[s_item].astype(np.int64), "onpromotion": promo,
        "unit_sales": units.astype(np.float32),
    }, ("onpromotion", "unit_sales"))
    return Dataset([sales, items, stores, transactions, oil, holidays],
                   label=("sales", "unit_sales"))
