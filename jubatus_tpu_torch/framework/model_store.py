"""Durable model plane: a shared snapshot store the fleet can die and
come back from (copy of ``jubatus_tpu/framework/model_store.py``).

The node-local durability primitives — the ``ModelSnapshotRing`` in the
server process, ``save``/``load`` files under ``--datadir`` — die with
their node. This module is the durable plane those paths hang off: a
blob store (pluggable backend; local
directory now, the API shaped like an object store — put/get/list/
delete on flat keys) holding CRC'd checkpoint envelopes plus
**incremental diff-chains**, with store-side compaction so restore
cost stays bounded.

Store layout (flat keys under the backend root)::

    <cluster>/<engine>/full/<hlc:020d>.<version:012d>.<node>.jub
    <cluster>/<engine>/diff/<hlc:020d>.<version:012d>.<node>.jub

Record metadata (HLC stamp, mix ``model_version``, uploading node)
lives in the key so listing is cheap; record BYTES are always a
48-byte-header CRC envelope (framework/save_load.py):

- **full** records are byte-identical to a ``save_model`` envelope
  (system container + ``[user_data_version, driver.pack()]``), so the
  per-node ``load`` RPC and ``jubadump`` consume them unchanged.
- **diff** records carry ``kind: "diff"`` in the system container and a
  structural delta document in the user section: unchanged subtrees are
  skipped, changed non-float leaves ship as raw replacements, and float
  ndarray deltas optionally ride the same blockwise-int8 scheme as the
  mix wire plane (``compress="int8"``), with the uploader holding the
  error-feedback residual in its *belief* state so the chain's
  cumulative quantization error telescopes to ONLY the last diff's —
  the "bounded diff-chain tail" the kill-everything drill measures.

Chain semantics: each diff's ``base_hlc`` names the record it applies
on top of (the previous diff or the anchoring full). ``materialize``
replays full + contiguous chain and REFUSES to cross a gap (a dropped
upload), falling back to the longest valid prefix. ``compact`` replays
the chain store-side into a new full record and deletes the folded
diffs — by construction chain replay == compacted full, which
the tests pin.

Keys and record bytes are the JAX package's, so a JAX server and a port
server that share one store directory read each other's records. The
driver's ``pack()`` (under its lock) reads the model back from the
device; everything after it is host work.

Fault sites:
``store.put`` / ``store.get`` (error + delay + drop + bitflip corrupt)
in the backend, ``store.compact`` around compaction. A corrupt record
is REFUSED by the CRC check (counted ``store.crc_refused``), never
loaded — a flaky store degrades warm-boot to cold-boot + migration,
never a wrong or partial model.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from jubatus_tpu_torch.framework.driver import on_driver
from jubatus_tpu_torch.framework.save_load import (
    FORMAT_VERSION,
    SaveLoadError,
    pack_envelope,
    read_envelope,
)
from jubatus_tpu_torch.utils import events, faults
from jubatus_tpu_torch.utils.serialization import pack_obj, unpack_obj

__all__ = ["BlobBackend", "LocalDirBackend", "ModelStore", "StoreRecord",
           "StoreUploader", "diff_tree", "apply_diff"]

#: blockwise-int8 quantization block, matching the mix wire plane's
#: granularity so the store's lossy mode shares its error model
QUANT_BLOCK = 256

#: version tag inside every diff record's user section
DIFF_DOC_VERSION = 1


class BlobBackend:
    """Object-store-shaped blob API: flat string keys, whole-value
    put/get, prefix list, delete. Implementations must be atomic per
    put (a reader never sees a half-written value)."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError


class LocalDirBackend(BlobBackend):
    """Local-directory backend (one file per key, tmp + rename atomic
    put). The fault sites ``store.put`` / ``store.get`` live HERE so a
    chaos rule exercises every consumer — uploads, warm-boots, fleet
    restores — through one choke point. ``bitflip`` rules corrupt the
    bytes (put: before write; get: after read) so the envelope CRC
    refusal path is what the drills prove."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        if ".." in key or key.startswith("/"):
            raise ValueError(f"bad store key {key!r}")
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes) -> None:
        if faults.fire("store.put"):
            return  # drop rule: the upload is silently lost
        mutation = faults.fire_mutate("store.put")
        if mutation and mutation[0] == "bitflip":
            data = faults.flip_byte(data)
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def get(self, key: str) -> bytes:
        faults.fire("store.get")
        with open(self._path(key), "rb") as f:
            raw = f.read()
        mutation = faults.fire_mutate("store.get")
        if mutation and mutation[0] == "bitflip":
            raw = faults.flip_byte(raw)
        return raw

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            rel = "" if rel == "." else rel + "/"
            for name in files:
                if name.endswith(".tmp"):
                    continue
                key = rel + name
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def delete(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass


class StoreRecord:
    """One parsed store key: kind ("full"/"diff"), HLC stamp, mix
    model_version, uploading node."""

    __slots__ = ("key", "kind", "hlc", "version", "node")

    def __init__(self, key: str, kind: str, hlc: int, version: int,
                 node: str) -> None:
        self.key = key
        self.kind = kind
        self.hlc = hlc
        self.version = version
        self.node = node

    def __repr__(self) -> str:
        return (f"StoreRecord({self.kind} hlc={self.hlc} "
                f"v={self.version} node={self.node})")


def _tree_children(node: Any):
    """(key, child) pairs for container nodes, None for leaves. Only
    dicts and lists recurse — everything else (ndarray, bytes, scalars)
    is a leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, list):
        return list(enumerate(node))
    return None


def _leaf_equal(a: Any, b: Any) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and bool(np.array_equal(a, b)))
    return type(a) is type(b) and a == b


def _quant_int8(delta: np.ndarray) -> Tuple[bytes, bytes]:
    """Blockwise-int8 quantization of a float delta (block=QUANT_BLOCK,
    per-block absmax scale): returns (int8 bytes, f32 scale bytes)."""
    flat = np.ascontiguousarray(delta, dtype=np.float32).reshape(-1)
    pad = (-flat.size) % QUANT_BLOCK
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, dtype=np.float32)])
    blocks = flat.reshape(-1, QUANT_BLOCK)
    scales = np.abs(blocks).max(axis=1) / 127.0
    safe = np.where(scales > 0.0, scales, 1.0).astype(np.float32)
    q = np.clip(np.round(blocks / safe[:, None]), -127, 127).astype(np.int8)
    return q.tobytes(), scales.astype(np.float32).tobytes()


def _dequant_int8(qbytes: bytes, sbytes: bytes, shape, dtype) -> np.ndarray:
    q = np.frombuffer(qbytes, dtype=np.int8).reshape(-1, QUANT_BLOCK)
    scales = np.frombuffer(sbytes, dtype=np.float32)
    flat = (q.astype(np.float32) * scales[:, None]).reshape(-1)
    size = int(np.prod(shape)) if shape else 1
    return flat[:size].reshape(shape).astype(dtype)


def diff_tree(base: Any, new: Any, *, compress: str = "off"):
    """Structural delta from ``base`` to ``new`` (both normalized trees,
    i.e. already round-tripped through pack_obj/unpack_obj so dicts/
    lists/ndarrays are canonical).

    Returns ``(doc, belief)`` where ``doc`` is the diff document and
    ``belief`` is the tree a replayer ends up with after applying
    ``doc`` to ``base`` — identical to ``new`` in lossless mode
    (``compress="off"``), and ``new`` minus the current quantization
    residual in ``int8`` mode (the caller keeps ``belief`` as the next
    diff's base so the residual feeds forward — error feedback).

    Rules: unchanged subtrees are skipped; a container whose child-key
    set changed is replaced whole (raw); changed float ndarray leaves
    with matching shape/dtype ship bit-exact leaf bytes (``compress=
    "off"``) or int8-quantized additive deltas (``compress="int8"``);
    every other changed leaf ships raw."""
    changed: List[list] = []
    belief = _copy_tree(base)

    def walk(b: Any, n: Any, path: List) -> Any:
        bc, nc = _tree_children(b), _tree_children(n)
        if bc is not None and nc is not None and type(b) is type(n) \
                and [k for k, _ in bc] == [k for k, _ in nc]:
            out = b if isinstance(b, dict) else list(b)
            for key, nchild in nc:
                sub = walk(b[key], nchild, path + [key])
                if isinstance(b, dict):
                    b[key] = sub
                else:
                    out[key] = sub
            if isinstance(b, dict):
                return b
            return out
        if bc is None and nc is None:
            if isinstance(b, np.ndarray) and isinstance(n, np.ndarray) \
                    and b.shape == n.shape and b.dtype == n.dtype \
                    and np.issubdtype(n.dtype, np.floating):
                if np.array_equal(b, n):
                    return b
                delta = n.astype(np.float32) - b.astype(np.float32)
                if compress == "int8":
                    qb, sb = _quant_int8(delta)
                    changed.append([path, {"m": "i8", "q": qb, "s": sb,
                                           "sh": list(n.shape),
                                           "dt": n.dtype.str}])
                    approx = (b.astype(np.float32) + _dequant_int8(
                        qb, sb, n.shape, np.float32)).astype(n.dtype)
                    return approx
                # lossless mode ships the changed leaf's own bytes, not a
                # delta: base + (new - base) in f32 does NOT reconstruct
                # new exactly (rounding), and a delta is the same size as
                # the leaf anyway — deltas only pay off under quantization.
                changed.append([path, {"m": "b", "d": n.tobytes(),
                                       "sh": list(n.shape),
                                       "dt": n.dtype.str}])
                return n
            if _leaf_equal(b, n):
                return b
        # structure changed, non-float leaf, or leaf/container swap:
        # ship the whole new subtree raw
        changed.append([path, {"m": "raw", "b": pack_obj(n)}])
        return _copy_tree(n)

    belief = walk(belief, new, [])
    return {"v": DIFF_DOC_VERSION, "changed": changed}, belief


def apply_diff(base: Any, doc: dict) -> Any:
    """Replay one diff document onto ``base`` (mutates and returns it).
    Inverse of ``diff_tree``: raises SaveLoadError on version or path
    mismatch instead of guessing — a broken chain must refuse, not
    approximate."""
    if doc.get("v") != DIFF_DOC_VERSION:
        raise SaveLoadError(f"diff doc version {doc.get('v')!r} unsupported")
    for path, spec in doc["changed"]:
        if not path:
            base = _apply_leaf(base, spec)
            continue
        parent = base
        try:
            for part in path[:-1]:
                parent = parent[part]
            old = parent[path[-1]]
            parent[path[-1]] = _apply_leaf(old, spec)
        except (KeyError, IndexError, TypeError) as e:
            raise SaveLoadError(f"diff path {path!r} missing in base: {e}")
    return base


def _apply_leaf(old: Any, spec: dict) -> Any:
    mode = spec["m"]
    if mode == "raw":
        return unpack_obj(spec["b"])
    shape = tuple(spec["sh"])
    dtype = np.dtype(spec["dt"])
    if not isinstance(old, np.ndarray) or old.shape != shape:
        raise SaveLoadError("additive diff leaf has no matching base array")
    if mode == "b":
        # bit-exact leaf replacement (lossless mode)
        return np.frombuffer(spec["d"], dtype=dtype).reshape(shape).copy()
    if mode == "i8":
        delta = _dequant_int8(spec["q"], spec["s"], shape, np.float32)
        return (old.astype(np.float32) + delta).astype(dtype)
    raise SaveLoadError(f"unknown diff leaf mode {mode!r}")


def _copy_tree(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _copy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_copy_tree(v) for v in node]
    return node


class ModelStore:
    """The durable model plane over a blob backend: CRC'd full
    snapshots + diff chains per uploading node, namespaced by
    ``<cluster>/<engine>``. Thread-safe for the server's use (one
    uploader thread + restore RPCs): the backend is the serialization
    point; this class keeps no mutable state beyond counters."""

    def __init__(self, backend: BlobBackend, *, cluster: str, engine: str,
                 counter: Optional[Callable[..., Any]] = None) -> None:
        self.backend = backend
        self.cluster = cluster or "standalone"
        self.engine = engine
        self._counter = counter

    # -- counters ---------------------------------------------------
    def _count(self, key: str, n: int = 1) -> None:
        if self._counter is not None:
            self._counter(key, n)

    # -- keys -------------------------------------------------------
    def _prefix(self, kind: str = "") -> str:
        base = f"{self.cluster}/{self.engine}/"
        return base + (kind + "/" if kind else "")

    def _key(self, kind: str, hlc: int, version: int, node: str) -> str:
        safe_node = node.replace("/", "_") or "local"
        return (f"{self._prefix(kind)}{hlc:020d}.{version:012d}"
                f".{safe_node}.jub")

    def _parse(self, key: str) -> Optional[StoreRecord]:
        rest = key[len(self._prefix()):]
        kind, _, name = rest.partition("/")
        if kind not in ("full", "diff") or not name.endswith(".jub"):
            return None
        try:
            hlc_s, ver_s, node = name[:-len(".jub")].split(".", 2)
            return StoreRecord(key, kind, int(hlc_s), int(ver_s), node)
        except ValueError:
            return None

    # -- writes (every path CRC-stamps via pack_envelope) -----------
    def put_full(self, system: dict, user_payload: bytes, *, node: str,
                 model_version: int, hlc: Optional[int] = None) -> str:
        """Upload a full snapshot. ``user_payload`` is the already
        msgpack'd ``[user_data_version, state]`` section; the record is
        byte-identical to a save_model envelope of the same content."""
        blob = pack_envelope(pack_obj(system), user_payload)
        return self.put_blob(blob, kind="full", node=node,
                             model_version=model_version, hlc=hlc)

    def put_blob(self, blob: bytes, *, kind: str, node: str,
                 model_version: int, hlc: Optional[int] = None) -> str:
        """Upload pre-packed envelope bytes (the save RPC's own file
        bytes ride through here unchanged). Refuses a blob that does
        not parse as a CRC-valid envelope — the store never holds an
        unstamped record."""
        read_envelope(blob, f"store:{kind}")  # CRC stamp precondition
        key = self._key(kind, hlc if hlc is not None else events.hlc_now(),
                        model_version, node)
        try:
            self.backend.put(key, blob)
        except Exception as e:  # broad-ok — any backend failure counts
            self._count("store.put_errors")
            events.emit("store", "put_failed", severity="error",
                        key=key, error=str(e)[:200])
            raise
        self._count("store.puts")
        self._count("store.bytes_uploaded", len(blob))
        self._count("store.fulls" if kind == "full" else "store.diffs")
        return key

    def put_diff(self, doc: dict, *, node: str, model_version: int,
                 base_hlc: int, model_id: str = "", config: str = "",
                 hlc: Optional[int] = None) -> str:
        """Append one diff record to ``node``'s chain: CRC envelope
        whose system container names the base record's HLC."""
        system = {
            "version": FORMAT_VERSION,
            "timestamp": int(time.time()),  # wall-clock
            "type": self.engine,
            "id": model_id,
            "kind": "diff",
            "base_hlc": int(base_hlc),
            "config": config,
        }
        blob = pack_envelope(pack_obj(system),
                             pack_obj([DIFF_DOC_VERSION, doc]))
        return self.put_blob(blob, kind="diff", node=node,
                             model_version=model_version, hlc=hlc)

    # -- reads ------------------------------------------------------
    def fetch(self, key: str) -> bytes:
        """CRC-validated read: returns raw envelope bytes or raises.
        A CRC/format refusal is counted separately from transport
        errors — the drills assert corrupt records are refused, never
        loaded."""
        try:
            raw = self.backend.get(key)
        except SaveLoadError:
            raise
        except Exception as e:  # broad-ok — any backend failure counts
            self._count("store.get_errors")
            events.emit("store", "get_failed", severity="warning",
                        key=key, error=str(e)[:200])
            raise
        self._count("store.gets")
        try:
            read_envelope(raw, key)
        except SaveLoadError:
            self._count("store.crc_refused")
            events.emit("store", "crc_refused", severity="error", key=key)
            raise
        self._count("store.bytes_fetched", len(raw))
        return raw

    def records(self, *, kind: str = "", node: str = "") -> List[StoreRecord]:
        """Parsed records sorted by (hlc, version), optionally filtered
        by kind and uploading node."""
        out = []
        for key in self.backend.list(self._prefix(kind)):
            rec = self._parse(key)
            if rec is None:
                continue
            if node and rec.node != node:
                continue
            out.append(rec)
        out.sort(key=lambda r: (r.hlc, r.version, r.kind))
        return out

    def nodes(self) -> List[str]:
        return sorted({r.node for r in self.records(kind="full")})

    def resolve(self, *, at: Optional[int] = None, node: str = "",
                ) -> Tuple[Optional[StoreRecord], List[StoreRecord]]:
        """The restore plan at ``at`` (HLC; None = latest): newest full
        record ≤ at, plus the longest CONTIGUOUS diff chain on top of
        it (each diff's base_hlc naming its predecessor is validated by
        materialize; here contiguity means hlc-ordered diffs newer than
        the full, up to ``at``)."""
        fulls = [r for r in self.records(kind="full", node=node)
                 if at is None or r.hlc <= at]
        if not fulls:
            return None, []
        full = fulls[-1]
        chain = [r for r in self.records(kind="diff", node=full.node)
                 if r.hlc > full.hlc and (at is None or r.hlc <= at)]
        return full, chain

    def materialize(self, *, at: Optional[int] = None, node: str = "",
                    ) -> Tuple[bytes, Dict[str, Any]]:
        """Replay full + diff chain into full envelope bytes. Walks the
        chain in HLC order, REFUSING to cross a gap (base_hlc mismatch
        — a dropped or corrupt upload truncates replay at the longest
        valid prefix rather than skipping records). Raises SaveLoadError
        when no full snapshot resolves."""
        full, chain = self.resolve(at=at, node=node)
        if full is None:
            raise SaveLoadError(
                f"store {self._prefix()}: no full snapshot"
                + (f" at hlc<={at}" if at is not None else ""))
        raw = self.fetch(full.key)
        system_bytes, user_bytes = read_envelope(raw, full.key)
        if not chain:
            return raw, {"key": full.key, "hlc": full.hlc,
                         "model_version": full.version, "chain_len": 0,
                         "node": full.node}
        user_version, state = unpack_obj(user_bytes)
        applied = 0
        cur_hlc = full.hlc
        cur_version = full.version
        for rec in chain:
            try:
                diff_raw = self.fetch(rec.key)
                dsys, duser = read_envelope(diff_raw, rec.key)
                dsystem = unpack_obj(dsys)
                if dsystem.get("kind") != "diff" \
                        or dsystem.get("base_hlc") != cur_hlc:
                    break  # gap: a record in between was lost
                doc_version, doc = unpack_obj(duser)
                if doc_version != DIFF_DOC_VERSION:
                    break
                state = apply_diff(state, doc)
            except (SaveLoadError, OSError):
                break  # corrupt/missing link truncates the chain here
            applied += 1
            cur_hlc = rec.hlc
            cur_version = rec.version
        blob = pack_envelope(system_bytes,
                             pack_obj([user_version, state]))
        return blob, {"key": full.key, "hlc": cur_hlc,
                      "model_version": cur_version, "chain_len": applied,
                      "node": full.node}

    def materialize_all(self, *, at: Optional[int] = None,
                        ) -> Dict[str, Tuple[bytes, Dict[str, Any]]]:
        """Per-node materialized snapshots at ``at`` — the fleet
        restore's input (each restoring member unions the rows it owns
        from every node's snapshot). Nodes whose records fail to
        materialize are skipped (counted via fetch), never guessed."""
        out = {}
        for node in self.nodes():
            try:
                out[node] = self.materialize(at=at, node=node)
            except (SaveLoadError, OSError):
                continue
        return out

    def latest(self, *, at: Optional[int] = None,
               ) -> Optional[Tuple[bytes, Dict[str, Any]]]:
        """The single freshest materializable snapshot across nodes
        (warm-boot's pick): max by replayed (hlc, model_version)."""
        best = None
        for node in self.nodes():
            try:
                blob, meta = self.materialize(at=at, node=node)
            except (SaveLoadError, OSError):
                continue
            rank = (meta["hlc"], meta["model_version"])
            if best is None or rank > best[0]:
                best = (rank, blob, meta)
        if best is None:
            return None
        return best[1], best[2]

    # -- compaction -------------------------------------------------
    def compact(self, *, node: str, at: Optional[int] = None) -> Optional[str]:
        """Fold ``node``'s diff chain into a new full record and delete
        the folded diffs (store-side; chain replay == the compacted
        full by construction). Returns the new full's key, or None when
        there is nothing to fold. Fault site ``store.compact``."""
        faults.fire("store.compact")
        blob, meta = self.materialize(at=at, node=node)
        key = None
        if meta["chain_len"]:
            key = self.put_blob(  # no-crc — materialize() stamped blob
                blob, kind="full", node=node,
                model_version=meta["model_version"], hlc=meta["hlc"])
        # prune every diff the newest full supersedes — including the
        # orphans left behind when the uploader re-anchors with a fresh
        # full (chain_len 0 here, but older diffs are now unreachable)
        for rec in self.records(kind="diff", node=node):
            if rec.hlc <= meta["hlc"]:
                self.backend.delete(rec.key)
        if key is None:
            return None
        self._count("store.compactions")
        events.emit("store", "compacted", node=node, key=key,
                    folded=meta["chain_len"])
        return key

    def stats(self) -> Dict[str, Any]:
        recs = self.records()
        fulls = [r for r in recs if r.kind == "full"]
        diffs = [r for r in recs if r.kind == "diff"]
        return {
            "store.records_full": len(fulls),
            "store.records_diff": len(diffs),
            "store.head_hlc": max((r.hlc for r in recs), default=0),
            "store.nodes": len({r.node for r in fulls}),
        }


class StoreUploader:
    """The background upload half of the durable plane: periodically
    snapshots the driver (under its lock), diffs against the *belief*
    (what a replayer reconstructs from the chain — NOT the last true
    state, so int8 quantization error feeds back), and uploads a diff
    record; every ``compact_every`` diffs it re-anchors with a fresh
    full (and asks the store to fold the old chain), bounding both
    restore cost and the lossy tail. One instance per server; the
    server's tick thread drives ``tick``."""

    def __init__(self, store: ModelStore, node: str, *,
                 model_id: str = "", config: str = "",
                 compress: str = "off", compact_every: int = 8) -> None:
        self.store = store
        self.node = node
        self.model_id = model_id
        self.config = config
        self.compress = compress
        self.compact_every = max(int(compact_every), 1)
        self._belief: Any = None
        self._belief_hlc = 0
        self._chain_len = 0
        self._last_version = -1
        self._tick_lock = threading.Lock()

    def tick(self, driver, model_version: int, *,
             force_full: bool = False) -> Optional[str]:
        """One upload cycle. Packs under the driver lock, encodes and
        uploads OUTSIDE it (the serving path never waits on the blob
        store). No-op when the model hasn't advanced since the last
        upload. Returns the uploaded key (None = skipped). Upload
        errors propagate — the caller counts and keeps serving.

        Serialized: two concurrent ticks would each diff against the
        same belief and upload two diffs naming the same base_hlc —
        the replayer's gap check would refuse the second and truncate
        the chain there."""
        with self._tick_lock:
            return self._tick_locked(driver, model_version,
                                     force_full=force_full)

    def _tick_locked(self, driver, model_version: int, *,
                     force_full: bool = False) -> Optional[str]:
        if model_version == self._last_version and not force_full:
            return None
        with on_driver(driver):
            version = model_version
            user_payload = pack_obj([driver.USER_DATA_VERSION,
                                     driver.pack()])
            driver_type = driver.TYPE
        hlc = events.hlc_now()
        full_due = (force_full or self._belief is None
                    or self._chain_len >= self.compact_every)
        if full_due:
            system = {
                "version": FORMAT_VERSION,
                "timestamp": int(time.time()),  # wall-clock
                "type": driver_type,
                "id": self.model_id,
                "config": self.config,
            }
            blob = pack_envelope(pack_obj(system), user_payload)
            key = self.store.put_blob(blob, kind="full", node=self.node,
                                      model_version=version, hlc=hlc)
            # belief = exactly what a replayer unpacks from the record
            _, state = unpack_obj(user_payload)
            self._belief = state
            self._belief_hlc = hlc
            if self._chain_len:
                try:
                    self.store.compact(node=self.node)
                except (SaveLoadError, OSError, faults.FaultInjected):
                    pass  # compaction is advisory; the chain still replays
            self._chain_len = 0
        else:
            _, state = unpack_obj(user_payload)
            doc, belief = diff_tree(self._belief, state,
                                    compress=self.compress)
            if not doc["changed"]:
                self._last_version = version
                return None
            key = self.store.put_diff(
                doc, node=self.node, model_version=version,
                base_hlc=self._belief_hlc, model_id=self.model_id,
                config=self.config, hlc=hlc)
            self._belief = belief
            self._belief_hlc = hlc
            self._chain_len += 1
        self._last_version = version
        return key
