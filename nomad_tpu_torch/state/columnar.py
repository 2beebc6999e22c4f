"""Columnar snapshot codec: struct-of-arrays encoding for the store's
big tables (allocs / evals / nodes).

The legacy snapshot format is one wire dict per object — at C2M scale
(2M allocs) restore pays a msgpack decode of 2M small maps plus a
recursive `from_wire` per object, and then the dense table build from
the restored objects. This codec turns each table into columns:

  - scalar fields (str/bool/float/None) become ONE msgpack list per
    field — decoded by the msgpack C extension in a single pass;
  - int fields become raw little-endian numpy buffers framed as msgpack
    bin (`np.frombuffer` on decode — no per-value boxing until
    `.tolist()`);
  - nested fields (dataclasses, dicts, lists) become an int32 code
    column into a per-field POOL of unique wire values. Uniqueness is
    identity-first (objects shared before the snapshot stay shared
    after — the C2M seed's flyweight resources row) and then
    content-keyed, so a fleet of equal-but-distinct sub-objects
    (every alloc's DesiredTransition) collapses to ONE `from_wire`
    instead of N.

Decode materializes rows without the recursive `from_wire` walk:
`cls.__new__` + one `__dict__.update` per row from the zipped columns.
This is safe for every model here — none defines `__post_init__`,
`InitVar`, or `__slots__` — and all restored field values went through
the same wire codec the legacy path uses, so round-trip parity with the
object snapshot is testable field for field
(tests/test_torch_cold_start.py).

Sharing contract: pooled sub-objects may be SHARED across rows after a
restore. The store already treats stored objects as immutable
(mutations go through `dataclasses.replace`), and the C2M seed shares
one resources flyweight across millions of allocs by construction, so
this introduces no new hazard class. `task_states` is exempted
(NO_SHARE_FIELDS): client-side task runners mutate those dicts in
place on live objects.
"""

from __future__ import annotations

import dataclasses
import types
import typing
from typing import (Any, Dict, List, Optional, Tuple, get_args, get_origin,
                    get_type_hints)

import numpy as np

from ..utils.codec import from_wire, to_wire

# snapshot file format version: 1 = legacy per-object wire dicts (no
# "format" key), 2 = columnar struct-of-arrays with this codec
SNAPSHOT_FORMAT = 2

# sentinel codes for the two overwhelmingly common "nested" values:
# decoded as a FRESH container per row (mutable-default safety — a
# shared empty dict across 2M allocs would alias task_states)
_EMPTY_DICT = -2
_EMPTY_LIST = -3

# pooled fields that must never share decoded instances across rows
NO_SHARE_FIELDS = frozenset({"task_states"})

_HINTS_CACHE: Dict[type, dict] = {}


def _hints(cls: type) -> dict:
    h = _HINTS_CACHE.get(cls)
    if h is None:
        h = get_type_hints(cls)
        _HINTS_CACHE[cls] = h
    return h


def _freeze(w: Any):
    """Hashable content key for a wire value (dict-order independent).
    NaN floats never compare equal — they simply never dedup."""
    if isinstance(w, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in w.items()))
    if isinstance(w, list):
        return tuple(_freeze(v) for v in w)
    return w


class DecodedTable:
    """Materialized rows plus the raw columns a cold table build can
    feed from (ops/tables.py NodeTable.build_from_columns)."""

    __slots__ = ("objs", "columns", "codes", "pools")

    def __init__(self, objs: List, columns: Dict[str, list],
                 codes: Dict[str, np.ndarray],
                 pools: Dict[str, list]):
        self.objs = objs
        self.columns = columns      # field -> row-aligned value list
        self.codes = codes          # pooled field -> int32 code array
        self.pools = pools          # pooled field -> decoded objects


def encode_table(objs: List) -> dict:
    """Struct-of-arrays encode of one homogeneous object table."""
    n = len(objs)
    if n == 0:
        return {"n": 0, "fields": {}}
    cls = type(objs[0])
    out_fields: Dict[str, dict] = {}
    for f in dataclasses.fields(cls):
        name = f.name
        vals = [getattr(o, name) for o in objs]
        all_int = True
        scalar = True
        for v in vals:
            t = type(v)
            if t is int:
                continue
            all_int = False
            if t is str or t is float or t is bool or v is None:
                continue
            scalar = False
            break
        if all_int:
            col = np.fromiter(vals, np.int64, n)
            out_fields[name] = {"k": "i8", "d": col.tobytes()}
        elif scalar:
            out_fields[name] = {"k": "v", "v": vals}
        else:
            out_fields[name] = _encode_pooled(name, vals)
    return {"n": n, "fields": out_fields}


def _encode_pooled(name: str, vals: list) -> dict:
    pool: List[Any] = []
    codes = np.empty(len(vals), np.int32)
    by_id: Dict[int, int] = {}
    by_key: Dict[Any, int] = {}
    share = name not in NO_SHARE_FIELDS
    for i, v in enumerate(vals):
        if v is None:
            codes[i] = -1
            continue
        tv = type(v)
        if tv is dict and not v:
            codes[i] = _EMPTY_DICT
            continue
        if tv is list and not v:
            codes[i] = _EMPTY_LIST
            continue
        c = by_id.get(id(v))
        if c is None:
            w = to_wire(v)
            if share:
                key = _freeze(w)
                c = by_key.get(key)
                if c is None:
                    c = len(pool)
                    pool.append(w)
                    by_key[key] = c
            else:
                c = len(pool)
                pool.append(w)
            # `vals` pins every object alive for the whole encode, so
            # id() cannot be recycled under the memo
            by_id[id(v)] = c
        codes[i] = c
    return {"k": "p", "c": codes.tobytes(), "p": pool}


def decode_table(cls: type, enc: Optional[dict]) -> DecodedTable:
    """Decode one table: columns first, then one fast materialization
    pass (no recursive from_wire per row — only per unique pool
    entry)."""
    if not enc or not enc.get("n"):
        return DecodedTable([], {}, {}, {})
    n = int(enc["n"])
    hints = _hints(cls)
    columns: Dict[str, list] = {}
    codes_out: Dict[str, np.ndarray] = {}
    pools_out: Dict[str, list] = {}
    for name, c in enc["fields"].items():
        kind = c["k"]
        if kind == "i8":
            columns[name] = np.frombuffer(c["d"], np.int64).tolist()
        elif kind == "v":
            columns[name] = list(c["v"])
        else:
            hint = hints.get(name, Any)
            pool = [from_wire(hint, w) for w in c["p"]]
            codes = np.frombuffer(c["c"], np.int32)
            col: list = [None] * n
            for i, cd in enumerate(codes.tolist()):
                if cd >= 0:
                    col[i] = pool[cd]
                elif cd == _EMPTY_DICT:
                    col[i] = {}
                elif cd == _EMPTY_LIST:
                    col[i] = []
            columns[name] = col
            codes_out[name] = codes
            pools_out[name] = pool

    # fields the dataclass grew AFTER this snapshot was written get
    # their declared defaults (factories called per row)
    names = list(columns.keys())
    colvals = [columns[nm] for nm in names]
    missing: List[Tuple[str, Any, Any]] = []
    for f in dataclasses.fields(cls):
        if f.name in columns:
            continue
        factory = f.default_factory \
            if f.default_factory is not dataclasses.MISSING else None
        default = f.default if f.default is not dataclasses.MISSING \
            else None
        missing.append((f.name, default, factory))

    objs: List = []
    append = objs.append
    new = cls.__new__
    for row in zip(*colvals):
        o = new(cls)
        d = o.__dict__
        d.update(zip(names, row))
        for nm, default, factory in missing:
            d[nm] = factory() if factory is not None else default
        append(o)
    return DecodedTable(objs, columns, codes_out, pools_out)


# -- bulk ingest decode ------------------------------------------------

class WirePool:
    """Content-keyed decode memo for bulk write bodies: N identical
    nested stanzas across one request batch materialize as ONE shared
    instance instead of N (the snapshot pool idea, applied at
    admission). Safe only for leaf stanza types the write path never
    mutates per row after decode — canonicalize on a shared,
    content-identical instance is deterministic and converges, but
    row-specific mutation targets (constraint lists `_implied_constraints`
    appends to, client-mutated `task_states`) must never pool."""

    __slots__ = ("memo", "hits", "misses")

    def __init__(self):
        self.memo: Dict[Any, Any] = {}
        self.hits = 0
        self.misses = 0


# leaf dataclass types whose decoded instances may be shared across the
# rows of one bulk decode; resolved lazily to dodge the models import
# cycle (models import utils.codec which columnar sits beside)
_POOL_LEAFS: Optional[tuple] = None


def _pool_leafs() -> tuple:
    global _POOL_LEAFS
    if _POOL_LEAFS is None:
        from ..models.resources import Resources
        _POOL_LEAFS = (Resources,)
    return _POOL_LEAFS


def from_wire_pooled(cls: Any, data: Any, pool: WirePool) -> Any:
    """`from_wire` twin for bulk ingest: same dispatch, but whitelisted
    leaf dataclasses memoize by content key so a thousand-job register
    body with one resources shape pays ONE materialization."""
    if data is None:
        return None
    if isinstance(data, dict) and len(data) == 1 and "__b64__" in data:
        return from_wire(cls, data)
    if isinstance(cls, type) and dataclasses.is_dataclass(cls):
        if not isinstance(data, dict):
            return from_wire(cls, data)
        if cls in _pool_leafs():
            key = (cls, _freeze(data))
            hit = pool.memo.get(key)
            if hit is not None:
                pool.hits += 1
                return hit
            obj = from_wire(cls, data)
            pool.memo[key] = obj
            pool.misses += 1
            return obj
        # interior dataclass: recurse per field so nested leaves pool
        hints = _hints(cls)
        names = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: from_wire_pooled(hints.get(k, Any), v, pool)
                  for k, v in data.items() if k in names}
        return cls(**kwargs)
    origin = get_origin(cls)
    if origin in (typing.Union, types.UnionType):
        args = [a for a in get_args(cls) if a is not type(None)]
        return from_wire_pooled(args[0], data, pool) if args else data
    if origin in (list, tuple, set, frozenset) and isinstance(data, list):
        args = get_args(cls)
        elem = args[0] if args else Any
        seq = [from_wire_pooled(elem, v, pool) for v in data]
        return seq if origin is list else origin(seq)
    if origin is dict and isinstance(data, dict):
        args = get_args(cls)
        vt = args[1] if len(args) == 2 else Any
        return {k: from_wire_pooled(vt, v, pool) for k, v in data.items()}
    return from_wire(cls, data)


class ColdAllocColumns:
    """The restore-side feed for the vectorized cold NodeTable build:
    row-aligned alloc objects plus the columns the scatter aggregation
    needs (node ids, liveness, resources pool codes)."""

    __slots__ = ("allocs", "node_ids", "live", "res_codes", "res_pool")

    def __init__(self, allocs: List, node_ids: List[str],
                 live: np.ndarray, res_codes: Optional[np.ndarray],
                 res_pool: List):
        self.allocs = allocs
        self.node_ids = node_ids
        self.live = live
        self.res_codes = res_codes      # None => every row uses pool[-]
        self.res_pool = res_pool


def cold_alloc_columns(dec: DecodedTable) -> Optional[ColdAllocColumns]:
    """Build the cold-build feed from a decoded alloc table, or None
    when the decode lacks the needed columns (legacy restore)."""
    if not dec.objs:
        return None
    from ..models.alloc import (ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED,
                                ALLOC_CLIENT_LOST, ALLOC_DESIRED_EVICT,
                                ALLOC_DESIRED_STOP)
    terminal_desired = {ALLOC_DESIRED_STOP, ALLOC_DESIRED_EVICT}
    terminal_client = {ALLOC_CLIENT_COMPLETE, ALLOC_CLIENT_FAILED,
                       ALLOC_CLIENT_LOST}
    node_ids = dec.columns.get("node_id")
    desired = dec.columns.get("desired_status")
    client = dec.columns.get("client_status")
    if node_ids is None or desired is None or client is None:
        return None
    n = len(dec.objs)
    live = np.fromiter(
        (d not in terminal_desired and c not in terminal_client
         for d, c in zip(desired, client)), bool, n)
    return ColdAllocColumns(dec.objs, node_ids, live,
                            dec.codes.get("allocated_resources"),
                            dec.pools.get("allocated_resources", []))
