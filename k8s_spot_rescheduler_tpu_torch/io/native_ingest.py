"""ctypes bindings for the native LIST decoder (``native/ingest.cc``).

The port of the JAX package's ``io/native_ingest.py``, with its own copy
of the C++ source. The engine parses apiserver LIST JSON (50k pods ~= 30
MB) into columnar batches in one native pass instead of ``json.loads``
and ``decode_pod`` per object. Rows come back as numpy arrays plus a
shared string heap; pods/nodes are wrapped in **lazy views**
(``PodView``/``NodeView``) that quack like ``models/cluster.PodSpec``/
``NodeSpec`` but only materialize dicts (requests, labels) on first
access — the solver path reads the numeric columns and never touches
them.

The library is host C++17, built at first use: one ``g++`` (``$CXX``,
else ``g++``, else ``c++``) with ``CXX_FLAGS`` into
``build/torch_native/libingest_<hash>.so``, named by the hash of the
source and the flags, written to a temporary name and moved into place
so that concurrent processes never load a half-written file, then
loaded with ``ctypes.CDLL`` (``RTLD_LOCAL``, so that it can share a
process with the JAX package's own library). Then the ABI handshake
checks the layout the library describes.

``available()`` is False only when no library is built and no compiler
is on the machine; callers then take the Python decoders (``io/kube.py``
``decode_pod``/``decode_node``), which stay the semantic reference. With
a compiler present, a failed build or a failed handshake raises
``NativeBuildError`` with the compiler's output: it never degrades
silently. ``tests/test_torch_native.py`` holds every view against the
JAX package's Python decoders.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from k8s_spot_rescheduler_tpu_torch.models.cluster import (
    MIRROR_POD_ANNOTATION,
    NodeSpec,
    OwnerRef,
    PodSpec,
    Taint,
    Toleration,
)

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE, "native", "ingest.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE), "build", "torch_native")
CXX_FLAGS = ("-std=c++17", "-O2", "-fPIC", "-shared")
_build_lock = threading.Lock()


class NativeBuildError(RuntimeError):
    """The native decoder failed to build, to load or its ABI handshake,
    with a compiler present."""


_UNIT = "\x1f"
_REC = "\x1e"
_TERM = "\x1d"  # node-affinity blob: term separator (ingest.cc TERM_SEP)
_VAL = "\x1c"  # node-affinity blob: In/NotIn value separator (VAL_SEP)

# pod flag bits (native/ingest.cc)
F_MIRROR, F_DAEMONSET, F_REPLICATED, F_TERMINAL, F_PENDING = 1, 2, 4, 8, 16
F_PVC, F_REQAFF = 32, 64
# pod column indices
P_CPU, P_MEM, P_EPH = 0, 1, 2
(P_PRIO, P_NODEID, P_NSID, P_TOLID, P_LABELSID, P_SELID,
 P_AAFFID, P_NAFFID, P_PAFFID, P_ZAFFID, P_PVCID, P_SPREADID,
 P_PZAFFID) = range(13)
PS_NAME, PS_UID = range(2)
# interned-table families
(TBL_NODE, TBL_NS, TBL_TOLS, TBL_LABELS, TBL_NODESEL, TBL_AAFF,
 TBL_NAFF, TBL_PAFF, TBL_ZAFF, TBL_PVC, TBL_SPREAD, TBL_PZAFF) = range(12)
# node column indices
N_CPU, N_MEM, N_EPH, N_PODS = range(4)
N_READY, N_UNSCHED, N_HASPODS = range(3)
NS_NAME, NS_UID, NS_LABELS, NS_TAINTS = range(4)


def _compiler() -> Optional[str]:
    for name in (os.environ.get("CXX"), "g++", "c++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    return None


def library_path() -> str:
    """The library of ``SOURCE``, named by the hash of the source and
    ``CXX_FLAGS``."""
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libingest_{h.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """The path of the built library, compiling it if it is not built
    yet; None when it is not and no compiler is on the machine. Raises
    ``NativeBuildError`` with the compiler's output when the build
    fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = _compiler()
    if cxx is None:
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise NativeBuildError(
            f"{' '.join(cmd)} failed ({proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=1)
def _lib() -> Optional[ctypes.CDLL]:
    with _build_lock:
        path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as err:
        raise NativeBuildError(f"cannot load {path}: {err}") from err
    lib.ingest_pods.restype = ctypes.c_void_p
    lib.ingest_pods.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.ingest_nodes.restype = ctypes.c_void_p
    lib.ingest_nodes.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.ingest_free.argtypes = [ctypes.c_void_p]
    lib.batch_count.restype = ctypes.c_long
    lib.batch_count.argtypes = [ctypes.c_void_p]
    for name in ("batch_i64", "batch_str"):
        fn = getattr(lib, name)
        fn.restype = ctypes.POINTER(ctypes.c_int64)
        fn.argtypes = [ctypes.c_void_p]
    lib.batch_i32.restype = ctypes.POINTER(ctypes.c_int32)
    lib.batch_i32.argtypes = [ctypes.c_void_p]
    lib.batch_u8.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.batch_u8.argtypes = [ctypes.c_void_p]
    lib.batch_heap.restype = ctypes.POINTER(ctypes.c_char)
    lib.batch_heap.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
    lib.batch_rv.restype = ctypes.c_char_p
    lib.batch_rv.argtypes = [ctypes.c_void_p]
    lib.batch_table.restype = ctypes.POINTER(ctypes.c_int64)
    lib.batch_table.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_long),
    ]
    # ABI handshake: a library built for another column layout would be
    # silently misread, so any mismatch raises
    try:
        ok = (
            lib.pod_ncols_i64() == 3
            and lib.pod_ncols_i32() == 13
            and lib.pod_ncols_u8() == 1
            and lib.pod_ncols_str() == 2
            and lib.node_ncols_i64() == 4
            and lib.node_ncols_u8() == 3
            and lib.node_ncols_str() == 4
            and lib.table_count() == 12
            # the acceptance version covers blob format AND the
            # modeled/unmodeled decision surface
            and lib.blob_format_version() == 3
        )
    except AttributeError:
        ok = False
    if not ok:
        raise NativeBuildError(
            f"{path} failed the ABI handshake: native/ingest.cc and "
            "io/native_ingest.py describe different layouts"
        )
    return lib


def available() -> bool:
    return _lib() is not None


# The native schema carries exactly the resources the framework plans on;
# exotic resources (e.g. extended/GPU) must take the Python decode path,
# which preserves arbitrary request/allocatable keys.
SUPPORTED_RESOURCES = frozenset({"cpu", "memory", "ephemeral-storage", "pods"})


def supports(resources) -> bool:
    """True if the native schema carries every configured resource."""
    return set(resources) <= SUPPORTED_RESOURCES


def _copy_batch(lib, handle, ni64: int, ni32: int, nu8: int, nstr: int,
                tables: int = 0):
    """Copy the batch arrays out of native memory and free the handle.

    One memcpy per column family; the string heap comes out as a single
    Python bytes object the views slice lazily. ``tables`` interned-blob
    families come out as lists of bytes.
    """
    count = lib.batch_count(handle)
    i64 = np.ctypeslib.as_array(
        lib.batch_i64(handle), shape=(count * ni64,)
    ).reshape(count, ni64).copy() if ni64 and count else np.zeros(
        (count, ni64), np.int64
    )
    i32 = np.ctypeslib.as_array(
        lib.batch_i32(handle), shape=(count * ni32,)
    ).reshape(count, ni32).copy() if ni32 and count else np.zeros(
        (count, ni32), np.int32
    )
    u8 = np.ctypeslib.as_array(
        lib.batch_u8(handle), shape=(count * nu8,)
    ).reshape(count, nu8).copy() if nu8 and count else np.zeros(
        (count, nu8), np.uint8
    )
    stroff = np.ctypeslib.as_array(
        lib.batch_str(handle), shape=(count * nstr * 2,)
    ).reshape(count, nstr, 2).copy() if count else np.zeros(
        (0, nstr, 2), np.int64
    )
    hlen = ctypes.c_long()
    hptr = lib.batch_heap(handle, ctypes.byref(hlen))
    heap = ctypes.string_at(hptr, hlen.value)
    tbls: List[List[bytes]] = []
    for family in range(tables):
        tcount = ctypes.c_long()
        toff = lib.batch_table(handle, family, ctypes.byref(tcount))
        blobs = []
        for t in range(tcount.value):
            off, ln = toff[2 * t], toff[2 * t + 1]
            blobs.append(heap[off : off + ln])
        tbls.append(blobs)
    rv = (lib.batch_rv(handle) or b"").decode()
    lib.ingest_free(handle)
    return count, i64, i32, u8, stroff, heap, rv, tbls


@functools.lru_cache(maxsize=4096)
def _parse_tolerations(blob: bytes) -> Tuple[Toleration, ...]:
    out = []
    for rec in blob.decode().split(_REC):
        if not rec:
            continue
        key, value, operator, effect = rec.split(_UNIT)
        out.append(
            Toleration(key=key, value=value, operator=operator, effect=effect)
        )
    return tuple(out)


def _parse_kv(blob: bytes) -> Dict[str, str]:
    out: Dict[str, str] = {}
    for rec in blob.decode().split(_REC):
        if rec:
            k, _, v = rec.partition(_UNIT)
            out[k] = v
    return out


@functools.lru_cache(maxsize=4096)
def _parse_spread(blob: bytes) -> Tuple:
    """Spread blob (ingest.cc extract_topology_spread) -> the exact
    canonical tuples io/kube.py ``decode_topology_spread`` produces:
    (topology_key, max_skew, selector requirements), entries
    sorted+deduped. Round-5 format: requirements joined by TERM_SEP,
    each ``key VAL_SEP op VAL_SEP v1 VAL_SEP v2 ...`` (no values for
    Exists/DoesNotExist). The engine emits source order;
    canonicalization lives here (same contract as the node-affinity
    blob)."""
    if not blob:
        return ()
    out = []
    for rec in blob.decode().split(_REC):
        topo, skew, reqs_field = rec.split(_UNIT)
        reqs = []
        for req in reqs_field.split(_TERM):
            key, op, *values = req.split(_VAL)
            if op in ("Exists", "DoesNotExist"):
                vals: Tuple[str, ...] = ()
            else:
                vals = tuple(sorted(set(values)))
            reqs.append((key, op, vals))
        out.append((topo, int(skew), tuple(sorted(set(reqs)))))
    return tuple(sorted(set(out)))


@functools.lru_cache(maxsize=4096)
def _parse_affinity_terms(blob: bytes) -> Tuple:
    """Pod-affinity term blob (ingest.cc term_selector_blob) -> proto
    terms ``((namespaces | None, selector), ...)`` in source order,
    each selector canonicalized (sorted, deduped). ``None`` namespaces
    mean the pod's own namespace — resolved per pod by
    ``_resolve_terms`` (the blob is interned ACROSS pods of different
    namespaces, so resolution cannot happen here). Format: terms joined
    by TERM_SEP; term records joined by REC_SEP — record 0 is the
    namespaces list joined by VAL_SEP (empty = own namespace), the rest
    are ``key UNIT_SEP op UNIT_SEP values-joined-by-VAL_SEP``."""
    if not blob:
        return ()
    out = []
    for term_rec in blob.decode().split(_TERM):
        recs = term_rec.split(_REC)
        ns_rec = recs[0]
        nss = tuple(sorted(set(ns_rec.split(_VAL)))) if ns_rec else None
        reqs = []
        for rec in recs[1:]:
            key, op, values = rec.split(_UNIT)
            if op in ("Exists", "DoesNotExist"):
                vals: Tuple[str, ...] = ()
            else:
                vals = tuple(sorted(set(values.split(_VAL))))
            reqs.append((key, op, vals))
        out.append((nss, tuple(sorted(set(reqs)))))
    return tuple(out)


def _resolve_terms(proto: Tuple, ns: str, drop_nothing: bool) -> Tuple:
    """Finalize proto terms for one pod namespace: own-namespace scopes
    resolve to ``(ns,)``; anti-affinity families drop never-matching
    selectors exactly (they constrain nothing — io/kube.py lockstep)
    while positive families keep them (no resident can match -> the
    carrier is exactly unplaceable)."""
    from k8s_spot_rescheduler_tpu_torch.predicates.selectors import (
        selector_matches_nothing,
    )

    out = []
    for nss, sel in proto:
        if drop_nothing and selector_matches_nothing(sel):
            continue
        out.append((nss if nss is not None else (ns,), sel))
    return tuple(sorted(set(out)))


@functools.lru_cache(maxsize=4096)
def _parse_node_affinity(blob: bytes) -> Tuple:
    """Node-affinity blob (ingest.cc extract_node_affinity) -> the exact
    canonical tuples io/kube.py ``decode_node_affinity`` produces: terms
    and their expressions sorted, In/NotIn value lists sorted+deduped.
    The engine emits source order; canonicalization lives here so the two
    languages share no sort-order contract."""
    if not blob:
        return ()
    terms = []
    for term_rec in blob.decode().split(_TERM):
        exprs = []
        for rec in term_rec.split(_REC):
            key, op, values = rec.split(_UNIT)
            if op in ("Exists", "DoesNotExist"):
                vals: Tuple[str, ...] = ()
            elif op in ("Gt", "Lt"):
                vals = (values,)
            else:  # In / NotIn
                vals = tuple(sorted(set(values.split(_VAL))))
            exprs.append((key, op, vals))
        terms.append(tuple(sorted(exprs)))
    return tuple(sorted(set(terms)))


@functools.lru_cache(maxsize=1024)
def _parse_taints(blob: bytes) -> Tuple[Taint, ...]:
    out = []
    for rec in blob.decode().split(_REC):
        if not rec:
            continue
        key, value, effect = rec.split(_UNIT)
        out.append(Taint(key, value, effect))
    return tuple(out)


class PodBatch:
    """Columnar pods from one LIST response, with lazy row views.

    Interned tables (node names, namespaces, toleration sets, label sets)
    decode once per distinct value; rows carry int32 ids into them.
    """

    def __init__(self, count, i64, i32, u8, stroff, heap, rv, tables):
        self.count = count
        self.i64, self.i32, self.u8 = i64, i32, u8
        self.stroff, self.heap = stroff, heap
        self.resource_version = rv
        self.node_names = [b.decode() for b in tables[TBL_NODE]]
        self.namespaces = [b.decode() for b in tables[TBL_NS]]
        self.tol_sets = [_parse_tolerations(b) for b in tables[TBL_TOLS]]
        self.label_blobs = tables[TBL_LABELS]
        self._label_sets: List[Optional[Dict[str, str]]] = [None] * len(
            self.label_blobs
        )
        self.selector_sets = [_parse_kv(b) for b in tables[TBL_NODESEL]]
        # proto affinity terms (own-ns unresolved); resolved per
        # (set_id, namespace) on demand below
        self.match_protos = [_parse_affinity_terms(b) for b in tables[TBL_AAFF]]
        self.paff_protos = [_parse_affinity_terms(b) for b in tables[TBL_PAFF]]
        self.zaff_protos = [_parse_affinity_terms(b) for b in tables[TBL_ZAFF]]
        self.pzaff_protos = [
            _parse_affinity_terms(b) for b in tables[TBL_PZAFF]
        ]
        self._resolved: Dict[Tuple[int, int, str], Tuple] = {}
        self.pvc_lists = [
            tuple(b.decode().split(_REC)) if b else () for b in tables[TBL_PVC]
        ]
        self.naff_sets = [_parse_node_affinity(b) for b in tables[TBL_NAFF]]
        self.spread_sets = [_parse_spread(b) for b in tables[TBL_SPREAD]]

    def _terms(self, family: int, protos, set_id: int, ns: str,
               drop_nothing: bool) -> Tuple:
        key = (family, set_id, ns)
        cached = self._resolved.get(key)
        if cached is None:
            cached = self._resolved[key] = _resolve_terms(
                protos[set_id], ns, drop_nothing
            )
        return cached

    def match_terms(self, set_id: int, ns: str) -> Tuple:
        return self._terms(0, self.match_protos, set_id, ns, True)

    def zaff_terms(self, set_id: int, ns: str) -> Tuple:
        return self._terms(1, self.zaff_protos, set_id, ns, True)

    def paff_terms(self, set_id: int, ns: str) -> Tuple:
        return self._terms(2, self.paff_protos, set_id, ns, False)

    def pzaff_terms(self, set_id: int, ns: str) -> Tuple:
        return self._terms(3, self.pzaff_protos, set_id, ns, False)

    def pvc_list(self, set_id: int) -> tuple:
        return self.pvc_lists[set_id]

    def any_pvc_resolvable(self) -> bool:
        """Vectorized ``any(view.pvc_resolvable)`` over the batch — the
        same predicate PodView evaluates (F_PVC set, non-empty claim
        list, no F_REQAFF), without materializing 50k lazy views on the
        polling hot path. The per-list emptiness check runs
        over the small interned table, not per pod."""
        import numpy as np

        flags = self.u8[: self.count, 0]
        pvc = (flags & F_PVC) != 0
        if not pvc.any():
            return False
        nonempty = np.fromiter(
            (bool(l) for l in self.pvc_lists), bool, count=len(self.pvc_lists)
        )
        return bool(
            (
                pvc
                & ((flags & F_REQAFF) == 0)
                & nonempty[self.i32[: self.count, P_PVCID]]
            ).any()
        )

    def label_set(self, set_id: int) -> Dict[str, str]:
        cached = self._label_sets[set_id]
        if cached is None:
            cached = self._label_sets[set_id] = _parse_kv(
                self.label_blobs[set_id]
            )
        return cached

    def selector_set(self, set_id: int) -> Dict[str, str]:
        return self.selector_sets[set_id]

    def _str(self, i: int, col: int) -> bytes:
        off, ln = self.stroff[i, col]
        return self.heap[off : off + ln]

    def view(self, i: int) -> "PodView":
        return PodView(self, i)

    def views(self) -> List["PodView"]:
        return [PodView(self, i) for i in range(self.count)]


class PodView:
    """Duck-typed ``PodSpec`` over a batch row; dicts materialize lazily.

    Covers every attribute the framework reads off a pod: the columnar
    store (requests/priority/flags/tolerations/labels), the evictability
    filter, the node-map builder, the actuator (name/namespace/uid), and
    the unschedulable gate (phase/node_name).
    """

    __slots__ = ("_b", "_i", "_requests", "_labels")

    def __init__(self, batch: PodBatch, i: int):
        self._b = batch
        self._i = i
        self._requests: Optional[Dict[str, int]] = None
        self._labels: Optional[Dict[str, str]] = None

    @property
    def name(self) -> str:
        return self._b._str(self._i, PS_NAME).decode()

    @property
    def namespace(self) -> str:
        return self._b.namespaces[self._b.i32[self._i, P_NSID]]

    @property
    def node_name(self) -> str:
        return self._b.node_names[self._b.i32[self._i, P_NODEID]]

    @property
    def uid(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def meta_uid(self) -> str:
        """metadata.uid — the watch-store key (PodSpec has no analog)."""
        return self._b._str(self._i, PS_UID).decode()

    @property
    def requests(self) -> Dict[str, int]:
        if self._requests is None:
            row = self._b.i64[self._i]
            self._requests = {}
            if row[P_CPU]:
                self._requests["cpu"] = int(row[P_CPU])
            if row[P_MEM]:
                self._requests["memory"] = int(row[P_MEM])
            if row[P_EPH]:
                self._requests["ephemeral-storage"] = int(row[P_EPH])
        return self._requests

    @property
    def priority(self) -> int:
        return int(self._b.i32[self._i, P_PRIO])

    @property
    def labels(self) -> Dict[str, str]:
        if self._labels is None:
            self._labels = self._b.label_set(
                int(self._b.i32[self._i, P_LABELSID])
            )
        return self._labels

    @property
    def annotations(self) -> Dict[str, str]:
        # only the mirror annotation is ever read; synthesize it from flags
        if self._b.u8[self._i, 0] & F_MIRROR:
            return {MIRROR_POD_ANNOTATION: "true"}
        return {}

    @property
    def owner_refs(self) -> List[OwnerRef]:
        flags = self._b.u8[self._i, 0]
        if flags & F_REPLICATED:
            kind = "DaemonSet" if flags & F_DAEMONSET else "ReplicaSet"
            return [OwnerRef(kind=kind, name="", controller=True)]
        return []

    @property
    def tolerations(self) -> Tuple[Toleration, ...]:
        return self._b.tol_sets[self._b.i32[self._i, P_TOLID]]

    @property
    def anti_affinity_group(self) -> str:
        return ""  # the simplified group field is synthetic-only

    @property
    def anti_affinity_match(self) -> Tuple:
        return self._b.match_terms(
            int(self._b.i32[self._i, P_AAFFID]), self.namespace
        )

    @property
    def pod_affinity_match(self) -> Tuple:
        return self._b.paff_terms(
            int(self._b.i32[self._i, P_PAFFID]), self.namespace
        )

    @property
    def anti_affinity_zone_match(self) -> Tuple:
        return self._b.zaff_terms(
            int(self._b.i32[self._i, P_ZAFFID]), self.namespace
        )

    @property
    def pvc_names(self) -> tuple:
        return self._b.pvc_list(int(self._b.i32[self._i, P_PVCID]))

    @property
    def pvc_resolvable(self) -> bool:
        # decode_pod lockstep: claims present with a clean name list and
        # no other unmodeled constraint (F_REQAFF covers affinity shapes
        # AND hard spread constraints on the native side)
        flags = self._b.u8[self._i, 0]
        return bool(
            (flags & F_PVC)
            and self.pvc_names
            and not (flags & F_REQAFF)
        )

    @property
    def spread_constraints(self) -> tuple:
        return self._b.spread_sets[int(self._b.i32[self._i, P_SPREADID])]

    @property
    def pod_affinity_zone_match(self) -> Tuple:
        return self._b.pzaff_terms(
            int(self._b.i32[self._i, P_PZAFFID]), self.namespace
        )

    @property
    def node_selector(self) -> Dict[str, str]:
        return self._b.selector_set(int(self._b.i32[self._i, P_SELID]))

    @property
    def node_affinity(self) -> tuple:
        return self._b.naff_sets[int(self._b.i32[self._i, P_NAFFID])]

    @property
    def unmodeled_constraints(self) -> bool:
        return bool(self._b.u8[self._i, 0] & (F_PVC | F_REQAFF))

    @property
    def phase(self) -> str:
        flags = self._b.u8[self._i, 0]
        if flags & F_PENDING:
            return "Pending"
        if flags & F_TERMINAL:
            return "Succeeded"
        return "Running"

    def is_mirror(self) -> bool:
        return bool(self._b.u8[self._i, 0] & F_MIRROR)

    def is_daemonset(self) -> bool:
        return bool(self._b.u8[self._i, 0] & F_DAEMONSET)

    def controller_ref(self) -> Optional[OwnerRef]:
        refs = self.owner_refs
        return refs[0] if refs else None

    def to_pod_spec(self) -> PodSpec:
        """Full materialization (tests / fallback interop)."""
        return PodSpec(
            name=self.name,
            namespace=self.namespace,
            node_name=self.node_name,
            requests=dict(self.requests),
            priority=self.priority,
            labels=dict(self.labels),
            annotations=dict(self.annotations),
            owner_refs=list(self.owner_refs),
            tolerations=list(self.tolerations),
            phase=self.phase,
            node_selector=dict(self.node_selector),
            anti_affinity_match=self.anti_affinity_match,
            anti_affinity_zone_match=self.anti_affinity_zone_match,
            pvc_names=self.pvc_names,
            pvc_resolvable=self.pvc_resolvable,
            pod_affinity_match=self.pod_affinity_match,
            pod_affinity_zone_match=self.pod_affinity_zone_match,
            node_affinity=self.node_affinity,
            spread_constraints=self.spread_constraints,
            unmodeled_constraints=self.unmodeled_constraints,
        )

    def __repr__(self) -> str:
        return f"PodView({self.uid} on {self.node_name!r})"


class NodeBatch:
    def __init__(self, count, i64, i32, u8, stroff, heap, rv, tables):
        self.count = count
        self.i64, self.u8 = i64, u8
        self.stroff, self.heap = stroff, heap
        self.resource_version = rv

    def _str(self, i: int, col: int) -> bytes:
        off, ln = self.stroff[i, col]
        return self.heap[off : off + ln]

    def views(self) -> List["NodeView"]:
        return [NodeView(self, i) for i in range(self.count)]


class NodeView:
    """Duck-typed ``NodeSpec`` over a batch row."""

    __slots__ = ("_b", "_i", "_labels", "_alloc", "_taints")

    def __init__(self, batch: NodeBatch, i: int):
        self._b = batch
        self._i = i
        self._labels: Optional[Dict[str, str]] = None
        self._alloc: Optional[Dict[str, int]] = None
        self._taints: Optional[List[Taint]] = None

    @property
    def name(self) -> str:
        return self._b._str(self._i, NS_NAME).decode()

    @property
    def meta_uid(self) -> str:
        return self._b._str(self._i, NS_UID).decode()

    @property
    def labels(self) -> Dict[str, str]:
        if self._labels is None:
            self._labels = _parse_kv(self._b._str(self._i, NS_LABELS))
        return self._labels

    @property
    def allocatable(self) -> Dict[str, int]:
        if self._alloc is None:
            row = self._b.i64[self._i]
            self._alloc = {}
            if row[N_CPU]:
                self._alloc["cpu"] = int(row[N_CPU])
            if row[N_MEM]:
                self._alloc["memory"] = int(row[N_MEM])
            if row[N_EPH]:
                self._alloc["ephemeral-storage"] = int(row[N_EPH])
            if self._b.u8[self._i, N_HASPODS]:
                self._alloc["pods"] = int(row[N_PODS])
        return self._alloc

    @property
    def taints(self) -> List[Taint]:
        if self._taints is None:
            self._taints = list(_parse_taints(self._b._str(self._i, NS_TAINTS)))
        return self._taints

    # the actuator mutates taints via the apiserver, not on the view;
    # watch MODIFIED events deliver fresh views
    @taints.setter
    def taints(self, value) -> None:
        self._taints = list(value)

    @property
    def ready(self) -> bool:
        return bool(self._b.u8[self._i, N_READY])

    @property
    def unschedulable(self) -> bool:
        return bool(self._b.u8[self._i, N_UNSCHED])

    def allocatable_cpu(self) -> int:
        return int(self.allocatable.get("cpu", 0))

    def to_node_spec(self) -> NodeSpec:
        return NodeSpec(
            name=self.name,
            labels=dict(self.labels),
            allocatable=dict(self.allocatable),
            taints=list(self.taints),
            ready=self.ready,
            unschedulable=self.unschedulable,
        )

    def __repr__(self) -> str:
        return f"NodeView({self.name!r})"


def parse_pod_list(data: bytes) -> Optional[PodBatch]:
    """Parse a PodList JSON body natively; None if the engine is absent
    or the body doesn't parse (caller falls back to Python)."""
    lib = _lib()
    if lib is None:
        return None
    handle = lib.ingest_pods(data, len(data))
    if not handle:
        return None
    return PodBatch(*_copy_batch(lib, handle, 3, 13, 1, 2, tables=12))


def parse_node_list(data: bytes) -> Optional[NodeBatch]:
    lib = _lib()
    if lib is None:
        return None
    handle = lib.ingest_nodes(data, len(data))
    if not handle:
        return None
    return NodeBatch(*_copy_batch(lib, handle, 4, 0, 3, 4))
