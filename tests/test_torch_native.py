"""The port's native LIST decoder (``io/native_ingest`` over its own
``native/ingest.cc``) on the CPU against the JAX package.

- The library builds at first use into ``build/torch_native/`` and passes
  its ABI handshake; it is never the JAX package's ``_ingest.so``. With a
  compiler present a failed build or a failed handshake raises; with
  none (and nothing built) the decoder is unavailable and the callers
  take the Python decoders.
- Every ``PodView``/``NodeView`` of the port's native decode equals the
  JAX package's Python decoders (``io/kube.decode_pod``/``decode_node``),
  as plain data, once the decoded object is cut to what the native
  schema carries (``_native_pod``/``_native_node``): on the
  ``testing.encode_*`` LISTs of synthetic configs 1-4, on
  ``raw_variants`` for 8 seeds and on the quantity grammar, escape and
  unicode cases of ``tests/test_native_ingest.py``.
- The port's ``PodBatch`` columns equal those of the JAX package's own
  native engine (its source compiled into a temporary directory).
- ``ColumnarStore.bulk_add_pods`` packs bit-identically to ``add_pod``
  per pod, and to the JAX package's per-pod mirror.
- A watch mirror seeds natively in one bulk pass and re-lists natively
  after a 410 Gone, packing as a mirror fed by the Python decoders; the
  polling client decodes natively and drains as the JAX package's.
- ``supports()`` keeps exotic resources on the Python decoders.

Tolerance: exact everywhere.
"""

import dataclasses
import functools
import json
import os
import subprocess

import numpy as np
import pytest

from k8s_spot_rescheduler_tpu.io import kube as ref_kube
from k8s_spot_rescheduler_tpu.io import native_ingest as ref_native
from k8s_spot_rescheduler_tpu.models.columnar import (
    ColumnarStore as RefStore,
)
from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.io import kube as port_kube
from k8s_spot_rescheduler_tpu_torch.io import native_ingest
from k8s_spot_rescheduler_tpu_torch.io import synthetic as port_synthetic
from k8s_spot_rescheduler_tpu_torch.io.watch import WatchingKubeClusterClient
from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
from k8s_spot_rescheduler_tpu_torch.models.cluster import NodeSpec
from k8s_spot_rescheduler_tpu_torch.models.columnar import ColumnarStore
from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
    TorchSolverPlanner,
)
from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from tests.test_torch_kube import (
    _assert_same_pack,
    _mirror_pack,
    raw_variants,
)
from tests.torch_port_fixtures import reference_poll_run

ON_DEMAND = "kubernetes.io/role=worker"
SPOT = "kubernetes.io/role=spot-worker"
NATIVE_REQUESTS = ("cpu", "memory", "ephemeral-storage")
HAVE_CXX = native_ingest._compiler() is not None

needs_cxx = pytest.mark.skipif(
    not HAVE_CXX, reason="no C++ compiler: the port takes its Python decoders"
)


@pytest.fixture(scope="module", autouse=True)
def port_library():
    """Build (or find) the port's library once; a build or handshake
    failure fails here, never a silent fallback."""
    native_ingest._lib.cache_clear()
    if HAVE_CXX:
        assert native_ingest.available()


def _native_pod(pod) -> dict:
    """A decoded pod as plain data, cut to what the native schema
    carries: the non-zero cpu/memory/ephemeral-storage requests, the
    mirror annotation alone, the controller ref as its kind class
    (DaemonSet or ReplicaSet, no name), the phase as its class
    (Pending, terminal = Succeeded, else Running)."""
    d = dataclasses.asdict(pod)
    d["requests"] = {k: v for k, v in pod.requests.items()
                     if v and k in NATIVE_REQUESTS}
    d["annotations"] = ({"kubernetes.io/config.mirror": "true"}
                        if pod.is_mirror() else {})
    ref = pod.controller_ref()
    d["owner_refs"] = [] if ref is None else [{
        "kind": "DaemonSet" if ref.kind == "DaemonSet" else "ReplicaSet",
        "name": "", "controller": True}]
    d["phase"] = ("Pending" if pod.phase == "Pending" else "Succeeded"
                  if pod.phase in ("Succeeded", "Failed") else "Running")
    return d


def _native_node(node) -> dict:
    """A decoded node as plain data, cut to the allocatable the native
    schema carries (non-zero cpu/memory/ephemeral-storage, and pods
    when present)."""
    d = dataclasses.asdict(node)
    d["allocatable"] = {k: v for k, v in node.allocatable.items()
                        if (v and k in NATIVE_REQUESTS) or k == "pods"}
    return d


def _body(items, rv="42") -> bytes:
    return json.dumps({"metadata": {"resourceVersion": rv},
                       "items": items}).encode()


def _assert_views(pods=(), nodes=()):
    """Every native view equals the JAX package's decode of its raw
    object; the batch counts and resourceVersion agree."""
    if pods:
        batch = native_ingest.parse_pod_list(_body(list(pods)))
        assert batch.count == len(pods) and batch.resource_version == "42"
        for i, raw in enumerate(pods):
            view = batch.view(i)
            assert dataclasses.asdict(view.to_pod_spec()) == _native_pod(
                ref_kube.decode_pod(raw)), raw
            assert view.meta_uid == (raw.get("metadata") or {}).get("uid", "")
    if nodes:
        batch = native_ingest.parse_node_list(_body(list(nodes)))
        assert batch.count == len(nodes)
        for view, raw in zip(batch.views(), nodes):
            assert dataclasses.asdict(view.to_node_spec()) == _native_node(
                ref_kube.decode_node(raw)), raw


# --- the library ---------------------------------------------------------------


@needs_cxx
def test_library_builds_into_the_build_dir_and_is_never_the_jax_one():
    lib = native_ingest._lib()
    path = native_ingest.library_path()
    assert lib._name == path and os.path.exists(path)
    assert os.path.dirname(path) == native_ingest.BUILD_DIR
    assert os.path.basename(path).startswith("libingest_")
    assert "k8s_spot_rescheduler_tpu_torch" in native_ingest.SOURCE
    assert os.path.realpath(path) != os.path.realpath(ref_native._LIB_PATH)
    assert lib.blob_format_version() == 3 and lib.table_count() == 12


@needs_cxx
@pytest.mark.parametrize("fault", ["build", "handshake"])
def test_a_failing_build_or_handshake_raises(fault, tmp_path, monkeypatch):
    with open(native_ingest.SOURCE) as f:
        src = f.read()
    if fault == "build":
        src += "\nthis is not C++;\n"
    else:
        assert src.count("return 3;") >= 1
        src = src.replace("int blob_format_version() { return 3; }",
                          "int blob_format_version() { return 4; }")
        assert "return 4;" in src
    broken = tmp_path / "ingest.cc"
    broken.write_text(src)
    monkeypatch.setattr(native_ingest, "SOURCE", str(broken))
    monkeypatch.setattr(native_ingest, "BUILD_DIR", str(tmp_path / "build"))
    native_ingest._lib.cache_clear()
    try:
        with pytest.raises(native_ingest.NativeBuildError,
                           match="failed" if fault == "build" else "handshake"):
            native_ingest.available()
        # never cached as "unavailable": the next call raises again
        with pytest.raises(native_ingest.NativeBuildError):
            native_ingest.parse_pod_list(b'{"items": []}')
    finally:
        native_ingest._lib.cache_clear()


def test_without_a_compiler_the_python_decoders_serve(tmp_path, monkeypatch):
    monkeypatch.setattr(native_ingest, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_ingest, "_compiler", lambda: None)
    native_ingest._lib.cache_clear()
    try:
        assert not native_ingest.available()
        assert native_ingest.parse_pod_list(b'{"items": []}') is None
    finally:
        native_ingest._lib.cache_clear()


def test_supports_keeps_exotic_resources_on_the_python_decoders():
    assert native_ingest.supports(("cpu", "memory"))
    assert native_ingest.supports(("cpu", "memory", "ephemeral-storage",
                                   "pods"))
    assert not native_ingest.supports(("cpu", "nvidia.com/gpu"))
    for resources in (("cpu",), ("cpu", "nvidia.com/gpu"), ("memory", "pods")):
        assert native_ingest.supports(resources) == ref_native.supports(
            resources)


# --- views against the JAX package's Python decoders --------------------------


@functools.lru_cache(maxsize=None)
def _encoded(config_id: int):
    client = port_synthetic.generate_cluster(
        port_synthetic.CONFIGS[config_id], 0)
    nodes = [testing.encode_node(n, uid=f"node-{i}")
             for i, n in enumerate(client.nodes.values())]
    pods = [testing.encode_pod(p, uid=f"pod-{i}")
            for i, p in enumerate(client.pods.values())]
    return client, nodes, pods


@needs_cxx
@pytest.mark.parametrize("config_id", [1, 2, 3, 4])
def test_views_equal_the_reference_on_encoded_configs(config_id):
    _, nodes, pods = _encoded(config_id)
    _assert_views(pods, nodes)


@needs_cxx
@pytest.mark.parametrize("seed", range(8))
def test_views_equal_the_reference_on_raw_variants(seed):
    pods, nodes, *_ = raw_variants(seed)
    _assert_views(pods, nodes)


def _pod_obj(**over):
    """``tests/test_native_ingest.py``'s base pod."""
    obj = {
        "metadata": {
            "name": "p", "namespace": "ns1", "uid": "u-1",
            "labels": {"app": "web", "tier": "fe"},
            "ownerReferences": [
                {"kind": "ReplicaSet", "name": "rs", "controller": True}
            ],
        },
        "spec": {
            "nodeName": "n1",
            "priority": 7,
            "tolerations": [
                {"key": "a", "value": "b", "operator": "Equal",
                 "effect": "NoSchedule"},
                {"operator": "Exists"},
            ],
            "containers": [
                {"resources": {"requests": {
                    "cpu": "250m", "memory": "512Mi",
                    "ephemeral-storage": "1Gi"}}},
                {"resources": {"requests": {"cpu": "0.3", "memory": "1e6"}}},
            ],
        },
        "status": {"phase": "Running"},
    }
    obj.update(over)
    return obj


QUANTITIES = ["100m", "0.5", "1", "2", "1536Mi", "2Gi", "1e3", "1.5e2", "500n",
              "250u", "3k", "1M", "0.000001", "7Ti", "0", "123456789"]


def _quantity_pod(q):
    return _pod_obj(spec={"nodeName": "n1", "containers": [{"resources": {
        "requests": {"cpu": q, "memory": q, "ephemeral-storage": q}}}]})


def _vol_pod(name, volumes):
    return _pod_obj(metadata={"name": name, "namespace": "ns1"},
                    spec={"nodeName": "n1", "containers": [],
                          "volumes": volumes})


EDGE_CASES = {
    **{f"quantity-{q}": [_quantity_pod(q)] for q in QUANTITIES},
    "numeric-json-quantities": [_pod_obj(spec={"nodeName": "n1", "containers": [
        {"resources": {"requests": {"cpu": 2, "memory": 1048576}}}]})],
    "bare": [{"metadata": {"name": "bare"}, "spec": {}, "status": {}}],
    "nulls": [{"metadata": {"name": "nulls", "labels": None,
                            "ownerReferences": None},
               "spec": {"tolerations": None, "containers": None},
               "status": {"phase": "Pending"}}],
    "succeeded": [_pod_obj(status={"phase": "Succeeded"})],
    "failed": [_pod_obj(status={"phase": "Failed"})],
    "mirror": [_pod_obj(metadata={
        "name": "mirror", "namespace": "kube-system",
        "annotations": {"kubernetes.io/config.mirror": "abc"}})],
    "daemonset": [_pod_obj(metadata={
        "name": "ds", "namespace": "kube-system", "ownerReferences": [
            {"kind": "DaemonSet", "name": "d", "controller": True}]})],
    "no-controller": [_pod_obj(metadata={
        "name": "noctl", "ownerReferences": [
            {"kind": "ReplicaSet", "name": "rs", "controller": False}]})],
    "escapes-and-unicode": [_pod_obj(metadata={
        "name": "esc", "namespace": "nsé",
        "labels": {"quote\\\"d": "tab\there", "emoji": "😀-ok"}})],
    "pvc-shapes": [
        _vol_pod("v1", [{"persistentVolumeClaim": {"claimName": "data"}},
                        {"configMap": {"name": "cm"}},
                        {"persistentVolumeClaim": {"claimName": "logs"}}]),
        _vol_pod("v2", [{"persistentVolumeClaim": {"claimName": "ok"}},
                        {"persistentVolumeClaim": {}}]),
        _vol_pod("v3", [{"persistentVolumeClaim": None}]),
        _vol_pod("v4", [{"persistentVolumeClaim": {"claimName": ""}}]),
        _vol_pod("v5", [{"persistentVolumeClaim":
                         {"claimName": "bad\u001ename"}}]),
        _vol_pod("v6", None),
        _vol_pod("v7", []),
    ],
}


@needs_cxx
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_views_equal_the_reference_on_edge_cases(case):
    _assert_views(EDGE_CASES[case])
    batch = native_ingest.parse_pod_list(_body(EDGE_CASES[case]))
    assert batch.any_pvc_resolvable() == any(
        v.pvc_resolvable for v in batch.views())


@needs_cxx
def test_node_edge_cases_equal_the_reference():
    _assert_views(nodes=[
        {"metadata": {"name": "n1", "uid": "u-n1",
                      "labels": {"kubernetes.io/role": "spot-worker"}},
         "spec": {"taints": [
             {"key": "k", "value": "v", "effect": "NoExecute"},
             {"key": "pref", "effect": "PreferNoSchedule"},
             {"key": "noval"}], "unschedulable": True},
         "status": {"allocatable": {"cpu": "3900m", "memory": "15Gi",
                                    "pods": "110",
                                    "ephemeral-storage": "93Gi"},
                    "conditions": [{"type": "Ready", "status": "True"}]}},
        {"metadata": {"name": "n2"}, "spec": {},
         "status": {"conditions": [
             {"type": "Ready", "status": "False"},
             {"type": "MemoryPressure", "status": "True"}]}},
    ])


# --- the JAX package's own native engine ---------------------------------------


@pytest.fixture(scope="module")
def jax_engine(tmp_path_factory):
    """The JAX package's ``native/ingest.cc`` compiled into a temporary
    directory and bound by its own ``io/native_ingest``; the package's
    ``_ingest.so`` is left alone."""
    if not HAVE_CXX:
        pytest.skip("no C++ compiler: the JAX package's engine cannot load")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        ref_native.__file__))), "native", "ingest.cc")
    out = str(tmp_path_factory.mktemp("jax_ingest") / "_ingest.so")
    subprocess.run([native_ingest._compiler(), "-std=c++17", "-O2", "-fPIC",
                    "-shared", "-o", out, src], check=True,
                   capture_output=True)
    saved = ref_native._LIB_PATH
    ref_native._LIB_PATH = out
    ref_native._lib.cache_clear()
    try:
        if not ref_native.available():
            pytest.skip("the JAX package's native engine does not load")
        yield ref_native
    finally:
        ref_native._LIB_PATH = saved
        ref_native._lib.cache_clear()


def _assert_same_batch(got, want):
    assert got.count == want.count
    assert got.resource_version == want.resource_version
    for name in ("i64", "u8", "stroff"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.heap == want.heap
    if hasattr(want, "i32"):
        np.testing.assert_array_equal(got.i32, want.i32)
        for name in ("node_names", "namespaces", "tol_sets", "label_blobs",
                     "selector_sets", "match_protos", "paff_protos",
                     "zaff_protos", "pzaff_protos", "pvc_lists", "naff_sets",
                     "spread_sets"):
            assert [repr(x) for x in getattr(got, name)] == [
                repr(x) for x in getattr(want, name)], name


@needs_cxx
@pytest.mark.parametrize("source", ["config1", "config2", "config4",
                                    "raw-variants", "edge-cases"])
def test_batches_equal_the_jax_engine(source, jax_engine):
    if source.startswith("config"):
        _, nodes, pods = _encoded(int(source[len("config"):]))
    elif source == "raw-variants":
        pods, nodes = [], []
        for seed in range(8):
            p, n, *_ = raw_variants(seed)
            pods += p
            nodes += n
    else:
        pods = [p for case in EDGE_CASES.values() for p in case]
        nodes = []
    body = _body(pods)
    _assert_same_batch(native_ingest.parse_pod_list(body),
                       jax_engine.parse_pod_list(body))
    body = _body(nodes)
    _assert_same_batch(native_ingest.parse_node_list(body),
                       jax_engine.parse_node_list(body))


# --- the bulk seed -------------------------------------------------------------


@needs_cxx
@pytest.mark.parametrize("config_id", [1, 2, 3, 4])
def test_bulk_seed_packs_as_the_per_pod_mirror(config_id, monkeypatch):
    """``bulk_add_pods`` over the native batch of a config's encoded
    LIST packs bit-identically to ``add_pod`` over the port's Python
    decodes and to the JAX package's per-pod mirror."""
    client, nodes, pods = _encoded(config_id)
    resources = tuple(port_synthetic.CONFIGS[config_id].resources)
    batch = native_ingest.parse_pod_list(_body(pods))

    def store(cls, pod_objs=None, bulk=False):
        s = cls(resources, on_demand_label=ON_DEMAND, spot_label=SPOT)
        decode = port_kube.decode_node if cls is ColumnarStore else (
            ref_kube.decode_node)
        for raw in nodes:
            s.add_node(decode(raw))
        if bulk:
            assert s.bulk_add_pods(batch)
            assert not s.bulk_add_pods(batch)  # no upsert semantics
        else:
            for pod in pod_objs:
                s.add_pod(pod)
        return s

    pdbs = list(client.pdbs)
    bulk, _ = store(ColumnarStore, bulk=True).pack(pdbs)
    per_pod, _ = store(ColumnarStore,
                       [port_kube.decode_pod(p) for p in pods]).pack(pdbs)
    ref, _ = store(RefStore, [ref_kube.decode_pod(p) for p in pods]).pack(
        [ref_kube.decode_pdb(testing.encode_pdb(p)) for p in pdbs])
    _assert_same_pack(per_pod, bulk, "bulk vs per-pod")
    _assert_same_pack(ref, bulk, "bulk vs the JAX per-pod mirror")


@needs_cxx
def test_bulk_seed_parks_orphans_as_add_pod_does():
    pods = [_pod_obj(metadata={"name": f"p{i}", "namespace": "ns", "uid":
                               f"u{i}"},
                     spec={"nodeName": "mystery" if i == 2 else "n0",
                           "containers": [{"resources": {"requests": {
                               "cpu": f"{100 + i}m"}}}]})
            for i in range(4)]
    batch = native_ingest.parse_pod_list(_body(pods))
    stores = []
    for bulk in (True, False):
        s = ColumnarStore(("cpu",), on_demand_label=ON_DEMAND,
                          spot_label=SPOT)
        s.add_node(NodeSpec(name="n0", labels={"kubernetes.io/role": "worker"},
                            allocatable={"cpu": 4000, "pods": 10}))
        if bulk:
            assert s.bulk_add_pods(batch)
        else:
            for v in batch.views():
                s.add_pod(v)
        assert s.n_pods == 3
        s.add_node(NodeSpec(name="mystery",
                            labels={"kubernetes.io/role": "spot-worker"},
                            allocatable={"cpu": 4000, "pods": 10}))
        assert s.n_pods == 4
        stores.append(s.pack([])[0])
    _assert_same_pack(stores[1], stores[0], "orphans")


# --- the watch mirror and the polling client ---------------------------------


@needs_cxx
def test_watch_seeds_in_one_bulk_pass_and_relists_natively(monkeypatch):
    spec = port_synthetic.CONFIGS[4]
    small = dataclasses.replace(spec, n_on_demand=10, n_spot=10, n_pods=120)
    resources = tuple(spec.resources)
    stub = testing.StubApiServer.from_cluster(
        port_synthetic.generate_cluster(small, 5))
    calls = {"parse": 0, "bulk": 0}
    parse, bulk = native_ingest.parse_pod_list, ColumnarStore.bulk_add_pods

    def counted_parse(data):
        calls["parse"] += 1
        return parse(data)

    def counted_bulk(self, batch):
        calls["bulk"] += 1
        return bulk(self, batch)

    monkeypatch.setattr(native_ingest, "parse_pod_list", counted_parse)
    monkeypatch.setattr(ColumnarStore, "bulk_add_pods", counted_bulk)
    native = python = None
    try:
        native = WatchingKubeClusterClient(
            port_kube.KubeClusterClient(stub.url), clock=FakeClock())
        python_client = port_kube.KubeClusterClient(stub.url)
        python_client.use_native_ingest = False
        python = WatchingKubeClusterClient(python_client, clock=FakeClock())
        trackers = [testing.MirrorTracker(native),
                    testing.MirrorTracker(python)]
        native.start(timeout=30)
        python.start(timeout=30)
        assert calls["parse"] == 1
        pods_store = next(w for w in native._watchers
                          if w.list_path == "/api/v1/pods").store
        kinds = {type(v).__name__ for _, v in pods_store.snapshot_items()}
        assert kinds == {"PodView"}
        seeded, _ = _mirror_pack(native, resources)
        assert calls["bulk"] == 1  # the feed seeded from the one batch
        _assert_same_pack(_mirror_pack(python, resources)[0], seeded, "seed")
        # 410 Gone: both re-list, the native one natively
        stub.expire()
        victim = sorted(stub.objects["pods"])[3]
        stub.push("pods", "DELETED", stub.objects["pods"][victim])
        for t in trackers:
            t.wait(stub)
        assert calls["parse"] >= 2
        assert {type(v).__name__ for _, v in pods_store.snapshot_items()} == {
            "PodView"}
        _assert_same_pack(_mirror_pack(python, resources)[0],
                          _mirror_pack(native, resources)[0], "relist")
    finally:
        for wc in (native, python):
            if wc is not None:
                wc.stop()
        stub.close()


@needs_cxx
def test_polling_client_decodes_natively_and_drains_as_the_reference():
    """The polling kube client (no watch cache) through a stub: every
    LIST decodes into native views, and the controller's ticks equal
    the JAX package's polling run on config 1."""
    name, _, ticks, horizon = testing.POLL_RUNS[0]
    config_id = 1
    spec = port_synthetic.CONFIGS[config_id]
    cfg = testing.controller_config(ReschedulerConfig, spec, horizon,
                                    "columnar")
    planner = TorchSolverPlanner(cfg, device="cpu")
    seen = testing.track_observations(planner)
    clock = FakeClock()
    stub = testing.StubApiServer.from_cluster(
        port_synthetic.generate_cluster(spec, 0))
    client = port_kube.KubeClusterClient(stub.url)
    assert client.use_native_ingest
    try:
        got = testing.run_kube_ticks(
            Rescheduler(client, planner, cfg, clock=clock, recorder=client),
            stub, None, clock, ticks)
        views = {type(p).__name__ for pods in client._all_pods().values()
                 for p in pods}
        assert views == {"PodView"}
        assert {type(n).__name__ for n in client.list_ready_nodes()} == {
            "NodeView"}
    finally:
        stub.close()
    assert set(seen) == {"NodeMap"}
    want = reference_poll_run(name, config_id, ticks, horizon)["records"]
    assert got == want
    assert any(rec["drained"] for rec in got)


def test_request_raw_is_read_only():
    client = port_kube.KubeClusterClient("http://127.0.0.1:9")
    with pytest.raises(ValueError, match="read-only"):
        client._request_raw("POST", "/api/v1/pods")
