"""The port's wire protocol, fingerprints and shape buckets against the
JAX package's, on the CPU: every message kind encodes to the same bytes
in both packages and decodes across them, and the bucket padding and
stacking are bit-identical, so agents and services of either package
talk to each other (``tests/test_torch_service.py`` runs them)."""

import numpy as np
import pytest

from k8s_spot_rescheduler_tpu.models import columnar as jax_columnar
from k8s_spot_rescheduler_tpu.service import buckets as jax_buckets
from k8s_spot_rescheduler_tpu.service import wire as jax_wire
from k8s_spot_rescheduler_tpu_torch.models import delta as port_delta
from k8s_spot_rescheduler_tpu_torch.service import buckets as port_buckets
from k8s_spot_rescheduler_tpu_torch.service import wire as port_wire
from k8s_spot_rescheduler_tpu_torch.testing import random_pack
from tests.torch_port_fixtures import pack_config

SPANS = (("service.queue-wait", 0.0, 1.25), ("service.solve", 1.25, 0.5))


def _pack(seed: int, C=6, K=4, S=9, R=2):
    return random_pack(np.random.default_rng(seed), C, K, S, R)


def _delta(seed: int):
    prev = _pack(seed)
    new = _pack(seed + 1)
    return prev, new, port_delta.emit_packed_delta(prev, new)


def _messages(w):
    """(name, bytes) of every message kind, encoded by wire module ``w``
    from the same seeded inputs, in each version that changes its
    layout."""
    packed = _pack(0)
    prev, new, delta = _delta(3)
    fp_prev = port_delta.pack_fingerprint(prev)
    fp_new = port_delta.pack_fingerprint(new)
    row = np.arange(4, dtype=np.int32) - 1
    steps = np.arange(3 * 7, dtype=np.int32).reshape(3, 7) - 2
    reply = w.PlanReply(
        found=True, index=3, n_feasible=5, row=row, solve_ms=1.5,
        queue_wait_ms=0.25, batch_lanes=24, batch_tenants=3, spans=SPANS,
    )
    sched = w.PlanScheduleReply(
        steps=steps, solve_ms=2.5, queue_wait_ms=0.5, batch_lanes=12,
        batch_tenants=2, spans=SPANS,
    )
    return {
        "request-v1": w.encode_plan_request("tenant-a", packed, version=1),
        "request-v2-trace": w.encode_plan_request(
            "tenant-a", packed, trace_id="abc123", version=2),
        "request-v3-schedule": w.encode_plan_request(
            "tenant-a", packed, trace_id="abc123", schedule_horizon=8,
            version=3),
        "request-v4-fingerprint": w.encode_plan_request(
            "tenant-a", packed, pack_fingerprint=fp_prev),
        "delta-v4": w.encode_packed_delta(
            "tenant-a", delta, base_fingerprint=fp_prev,
            new_fingerprint=fp_new, trace_id="abc123"),
        "reply-v1": w.encode_plan_reply(reply._replace(spans=()), version=1),
        "reply-v4-spans": w.encode_plan_reply(reply),
        "schedule-reply": w.encode_plan_schedule_reply(sched),
        "error": w.encode_error("solve failed: boom", version=4),
        "error-v1": w.encode_error("bad request", version=1),
        "resync": w.encode_resync("fingerprint mismatch"),
    }


MESSAGE_NAMES = tuple(_messages(port_wire))


@pytest.mark.parametrize("name", MESSAGE_NAMES)
def test_every_message_encodes_to_the_same_bytes(name):
    assert _messages(port_wire)[name] == _messages(jax_wire)[name]


def _same_packed(a, b):
    for f in a._fields:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("src, dst", [(jax_wire, port_wire),
                                      (port_wire, jax_wire)],
                         ids=["jax-to-port", "port-to-jax"])
def test_messages_decode_across_packages(src, dst):
    msgs = _messages(src)
    packed = _pack(0)
    prev, new, delta = _delta(3)
    req = dst.decode_plan_request_ex(msgs["request-v3-schedule"])
    assert (req.tenant, req.trace_id, req.schedule_horizon, req.version) == (
        "tenant-a", "abc123", 8, 3)
    _same_packed(req.packed, packed)
    req = dst.decode_plan_request_ex(msgs["request-v4-fingerprint"])
    assert req.pack_fingerprint == port_delta.pack_fingerprint(prev)
    dreq = dst.decode_packed_delta_ex(msgs["delta-v4"])
    assert dreq.base_fingerprint == port_delta.pack_fingerprint(prev)
    assert dreq.new_fingerprint == port_delta.pack_fingerprint(new)
    _same_packed(dreq.delta, delta)
    reply = dst.decode_plan_reply(msgs["reply-v4-spans"])
    assert (reply.found, reply.index, reply.n_feasible) == (True, 3, 5)
    assert reply.spans == SPANS
    assert np.array_equal(reply.row, np.arange(4) - 1)
    sched = dst.decode_plan_schedule_reply(msgs["schedule-reply"])
    assert np.array_equal(sched.steps,
                          np.arange(21, dtype=np.int32).reshape(3, 7) - 2)
    demand = dst.decode_plan_or_resync(msgs["resync"])
    assert demand.cause == "fingerprint mismatch"
    with pytest.raises(dst.WireError, match="boom"):
        dst.decode_plan_reply(msgs["error"])


@pytest.mark.parametrize("config_id", [1, 2])
def test_fingerprints_and_digests_match(config_id):
    packed = pack_config(config_id)
    assert port_delta.pack_fingerprint(packed) == \
        jax_columnar.pack_fingerprint(packed)
    _, _, delta = _delta(config_id)
    assert port_wire.delta_digest("a", "b", delta) == \
        jax_wire.delta_digest("a", "b", delta)


def test_corrupt_delta_is_a_typed_error_in_both():
    data = bytearray(_messages(port_wire)["delta-v4"])
    data[-3] ^= 0xFF  # a bit flip in the last payload
    for w in (port_wire, jax_wire):
        with pytest.raises(w.WireError):
            w.decode_packed_delta_ex(bytes(data))


@pytest.mark.parametrize("config_id", [1, 2])
def test_buckets_pad_and_stack_bit_identical(config_id):
    packed = pack_config(config_id)
    other = pack_config(config_id, seed=1)
    b = port_buckets.bucket_for(packed)
    assert tuple(b) == tuple(jax_buckets.bucket_for(packed))
    assert b.key == jax_buckets.bucket_for(packed).key
    jb = jax_buckets.Bucket(*b)
    padded = [port_buckets.pad_to_bucket(p, b) for p in (packed, other)]
    jax_padded = [jax_buckets.pad_to_bucket(p, jb) for p in (packed, other)]
    for p, q in zip(padded, jax_padded):
        _same_packed(p, q)
    _same_packed(port_buckets.stack_bucket(padded, b),
                 jax_buckets.stack_bucket(jax_padded, jb))
    per = port_buckets.per_tenant_hbm_bytes(b)
    assert per == jax_buckets.per_tenant_hbm_bytes(jb)
    for budget in (per // 2, 5 * per, 10**18):
        assert port_buckets.max_batch_tenants(b, budget_bytes=budget) == \
            jax_buckets.max_batch_tenants(jb, budget_bytes=budget)


def test_pad_packed_delta_and_empty_delta_match():
    prev, new, delta = _delta(7)
    for kw in ({}, {"lane_rows": 16, "cand_rows": 8, "spot_rows": 32,
                    "K": 8}):
        _same_packed(port_delta.pad_packed_delta(delta, 6, 9, **kw),
                     jax_columnar.pad_packed_delta(delta, 6, 9, **kw))
    jax_delta = jax_columnar.PackedDelta(*delta)
    for src, jax_src in ((prev, prev), (delta, jax_delta)):
        _same_packed(port_delta.empty_packed_delta(src),
                     jax_columnar.empty_packed_delta(jax_src))


def test_batch_cap_reads_the_named_device(monkeypatch):
    """Without a budget the cap is the device's: the card's memory for a
    CUDA device (here a stand-in of 80 GB), the default otherwise."""
    from k8s_spot_rescheduler_tpu_torch.solver import memory

    b = port_buckets.Bucket(C=4096, K=64, S=4096, R=4, W=1, A=2)
    per = port_buckets.per_tenant_hbm_bytes(b)
    monkeypatch.setattr(memory.torch.cuda, "mem_get_info",
                        lambda device=None: (0, 80 * 10**9))
    assert port_buckets.max_batch_tenants(b, device="cuda:0") == int(
        80 * 10**9 * memory.BUDGET_FRACTION) // per
    assert port_buckets.max_batch_tenants(b) == int(
        memory.DEFAULT_HBM_BYTES * memory.BUDGET_FRACTION) // per
