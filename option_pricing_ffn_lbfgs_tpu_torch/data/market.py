"""Real-market option-chain ingestion (pure Python).

A mirror of the JAX package's ``data/market.py``:
  * CSV/JSON loaders producing the standard market_options list-of-dicts
    consumed by ``DoubleHestonJumpCalibrator``;
  * a yfinance fetcher (import-gated: raises a clear error when the package
    or network is unavailable).

CSV schema: columns strike, maturity (years), price, option_type
(call/put); spot and rate are passed alongside or embedded as
``# spot=... rate=...`` header comments.
"""
from __future__ import annotations

import csv
import datetime
import json
import re
from typing import Dict, List, Optional, Tuple


def load_option_chain_csv(path: str) -> Tuple[List[Dict], Optional[float],
                                              Optional[float]]:
    """Load (market_options, spot, rate) from CSV.

    Header comment lines like ``# spot=100.0`` / ``# rate=0.03`` set the
    metadata; otherwise they return as None.
    """
    spot = rate = None
    rows = []
    with open(path, newline="") as f:
        plain = []
        for line in f:
            m = re.match(r"#\s*(spot|rate)\s*=\s*([0-9.eE+-]+)", line)
            if m:
                if m.group(1) == "spot":
                    spot = float(m.group(2))
                else:
                    rate = float(m.group(2))
            elif line.strip() and not line.startswith("#"):
                plain.append(line)
        reader = csv.DictReader(plain)
        for r in reader:
            rows.append({
                "strike": float(r["strike"]),
                "maturity": float(r["maturity"]),
                "price": float(r["price"]),
                "option_type": r.get("option_type", "call").strip().lower(),
            })
    return rows, spot, rate


def save_option_chain_csv(path: str, options: List[Dict],
                          spot: Optional[float] = None,
                          rate: Optional[float] = None) -> None:
    with open(path, "w", newline="") as f:
        if spot is not None:
            f.write(f"# spot={spot}\n")
        if rate is not None:
            f.write(f"# rate={rate}\n")
        w = csv.DictWriter(f, ["strike", "maturity", "price", "option_type"])
        w.writeheader()
        for o in options:
            w.writerow({k: o[k] for k in
                        ("strike", "maturity", "price", "option_type")})


def load_option_chain_json(path: str) -> Tuple[List[Dict], Optional[float],
                                               Optional[float]]:
    """JSON: {"spot": ..., "rate": ..., "options": [{...}, ...]}."""
    with open(path) as f:
        d = json.load(f)
    return d["options"], d.get("spot"), d.get("rate")


def fetch_yfinance(ticker: str, max_expiries: int = 3,
                   risk_free_rate: float = 0.03):
    """Fetch a live option chain via yfinance (optional dependency).

    Returns (market_options, spot, rate). Raises ImportError with guidance
    when yfinance is not installed (it is not in this environment).
    """
    try:
        import yfinance as yf  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "yfinance is not installed; real-market fetching is an optional "
            "feature. Load chains from CSV/JSON via load_option_chain_csv / "
            "load_option_chain_json instead.") from e
    tk = yf.Ticker(ticker)
    spot = float(tk.history(period="1d")["Close"].iloc[-1])
    today = datetime.date.today()
    options: List[Dict] = []
    for expiry in tk.options[:max_expiries]:
        exp_date = datetime.date.fromisoformat(expiry)
        tau = max((exp_date - today).days, 1) / 365.0
        chain = tk.option_chain(expiry)
        for kind, frame in (("call", chain.calls), ("put", chain.puts)):
            for _, row in frame.iterrows():
                bid, ask = float(row.get("bid", 0)), float(row.get("ask", 0))
                price = (bid + ask) / 2 if (bid > 0 and ask > 0) else \
                    float(row.get("lastPrice", 0))
                if price > 0:
                    options.append({"strike": float(row["strike"]),
                                    "maturity": tau, "price": price,
                                    "option_type": kind})
    return options, spot, risk_free_rate
