"""The serving wire: plain containers only (paddlebox_tpu/serving/codec.py,
the same frames).

A pull rides utils/rpc.py's framed transport with ``plain_loads``, which
resolves no class, so a request or a response is a dict of bytes, ints,
floats and strings. Arrays travel as raw little-endian bytes with their
shape beside them, never as pickled numpy objects: a serving port must not
run a decoder that a sender can steer into building a class.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def encode_pull(keys: np.ndarray,
                trace: Optional[int] = None,
                shard: Optional[int] = None) -> Dict[str, Any]:
    """[K] uint64 keys -> a pull request. ``trace``: the 64-bit trace id
    the server's span records; ``shard``: the box the fleet client routed
    the pull to, which a sharded server checks against its own."""
    keys = np.ascontiguousarray(np.asarray(keys, np.uint64).reshape(-1))
    req = {"method": "pull", "keys": keys.tobytes(), "n": int(keys.size)}
    if trace is not None:
        req["trace"] = int(trace)
    if shard is not None:
        req["shard"] = int(shard)
    return req


def decode_trace(req: Dict[str, Any]) -> Optional[int]:
    """The request's trace id, or None; never raises (telemetry is best
    effort)."""
    t = req.get("trace")
    return int(t) if isinstance(t, int) else None


def decode_shard(req: Dict[str, Any]) -> Optional[int]:
    """The box the client routed to, or None (a single-box client declares
    none, and any box accepts it)."""
    s = req.get("shard")
    return int(s) if isinstance(s, int) else None


def decode_pull_keys(req: Dict[str, Any]) -> np.ndarray:
    """The keys of a pull request; a malformed frame raises ValueError."""
    raw = req.get("keys")
    n = req.get("n")
    if not isinstance(raw, bytes) or not isinstance(n, int) or n < 0:
        raise ValueError("pull frame needs bytes 'keys' and int 'n'")
    if len(raw) != 8 * n:
        raise ValueError(
            f"pull frame length mismatch: {len(raw)} bytes for n={n}")
    return np.frombuffer(raw, np.uint64, count=n)


def encode_rows(rows: np.ndarray, gen: int,
                watermark: Optional[float] = None) -> Dict[str, Any]:
    """[K, dim] float32 rows and the view generation they were read from
    -> a pull response. ``watermark`` (unix seconds, the newest source
    birth the served view vouches for) is stamped when above 0, so the
    client can measure end-to-end freshness a pull."""
    rows = np.ascontiguousarray(rows, np.float32)
    resp = {"rows": rows.tobytes(), "n": int(rows.shape[0]),
            "dim": int(rows.shape[1]), "gen": int(gen)}
    if watermark is not None and watermark > 0.0:
        resp["wm"] = float(watermark)
    return resp


def decode_watermark(resp: Dict[str, Any]) -> Optional[float]:
    """The response's watermark, or None; never raises."""
    w = resp.get("wm")
    return float(w) if isinstance(w, (int, float)) and w > 0 else None


def decode_rows(resp: Dict[str, Any]) -> np.ndarray:
    raw, n, dim = resp["rows"], int(resp["n"]), int(resp["dim"])
    if len(raw) != 4 * n * dim:
        raise ValueError(
            f"row frame length mismatch: {len(raw)} bytes for "
            f"n={n} dim={dim}")
    return np.frombuffer(raw, np.float32, count=n * dim).reshape(n, dim)
