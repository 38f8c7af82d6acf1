"""The handoff's wire format on the port against the JAX package's, on the
CPU in f32 with the JAX init's parameters carried across
(``compat/convert.py``).

* JAX's wire cases (``tests/test_serve_multiproc.py``) run on the port:
  serialize -> frame -> deserialize -> merge bit-exact with the in-process
  handoff, truncated and corrupt frames typed, the deadline crossing as its
  remaining budget, the transport counters merging.
* Across the packages, in the dense, paged, 8-bit-pages, speculative,
  infill and LoRA modes: one prefill round on a JAX engine and on a port
  engine gives frames with equal manifests (paths, dtypes, shapes) and
  equal leaves (integer and boolean exactly, f32 at 1e-5; the LoRA
  ``tenant`` leaf among them); the JAX frames, read by the port's
  ``deserialize_handle`` and admitted into a port ``remote_prefill``
  replica, give the JAX in-process engine's tokens; and JAX's
  ``unpack_frame`` and ``deserialize_handle`` read the port's frames (but
  for the infill mode's: JAX's reader passes no vocabulary for a request's
  mask and raises, where the port's takes it from the ``lmask`` leaf)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from progen_tpu.core.precision import make_policy as jax_policy
from progen_tpu.decode import Request as JaxRequest
from progen_tpu.decode import ServingEngine as JaxServingEngine
from progen_tpu.decode import handoff as jax_handoff
from progen_tpu.models import ProGen as JaxProGen
from progen_tpu.models import ProGenConfig as JaxConfig
from progen_tpu.observe.transport import TransportCounters as JaxTransportCounters
from progen_tpu.parallel import unbox
from progen_tpu.workloads import lora as jax_lora
from progen_tpu.workloads.infill import ScaffoldSpec as JaxScaffoldSpec
from progen_tpu_torch.compat.convert import bank_from_numpy, params_from_flax
from progen_tpu_torch.core.precision import make_policy
from progen_tpu_torch.decode.engine import Request, ServingEngine
from progen_tpu_torch.decode.handoff import (
    FrameCorrupt,
    FrameDesync,
    _flatten_state,
    deserialize_handle,
    pack_frame,
    request_from_wire,
    request_to_wire,
    serialize_handle,
    unpack_frame,
)
from progen_tpu_torch.models import ProGen, ProGenConfig
from progen_tpu_torch.observe.transport import TransportCounters
from progen_tpu_torch.serve.worker import build_engine_from_spec, make_spec

torch.set_num_threads(1)

# tests/test_serve_multiproc.py:35-38
KW = dict(num_tokens=32, dim=16, seq_len=24, depth=2, window_size=4,
          global_mlp_depth=1, heads=2, dim_head=8, ff_mult=2)
CFG, JAX_CFG = ProGenConfig(**KW), JaxConfig(**KW)
ENGINE_KW = dict(num_slots=4, chunk_size=4, max_len=24, prefill_batch=2,
                 handoff_depth=2)
VARIANT_KW = {
    "dense": {},
    "paged": dict(paged=True, page_size=4, num_pages=32),
    "spec": dict(spec=True, spec_k=2),  # identity draft
}
MODES = {
    "dense": {},
    "paged": VARIANT_KW["paged"],
    "paged_q8": dict(VARIANT_KW["paged"], quantize="weights+pages"),
    "spec": VARIANT_KW["spec"],
    "infill": VARIANT_KW["paged"],
    "lora": {},
}
SCAFFOLD = dict(template=[0, 5, None, (3, 4, 7), None, 9, None], vocab=32)


def _spec(variant="dense"):
    return make_spec(CFG, mixed_precision=False, init_seed=7, device="cpu",
                     engine={**ENGINE_KW, **VARIANT_KW[variant]})


def _requests(n=4, start=0, cls=Request):
    """Mixed greedy (odd uid) and sampled (even uid) requests."""
    return [
        cls(uid=i, tokens=[1 + i, 2, 3], max_new_tokens=6,
            top_k=(None if i % 2 else 8),
            temperature=(0.0 if i % 2 else 1.0), seed=100 + i)
        for i in range(start, start + n)
    ]


_REFERENCE_CACHE: dict = {}


def _run_reference(variant="dense", n=4):
    """The port's single-process disaggregated engine on the spec: the
    token-identity oracle of the wire round trip."""
    key = (variant, n)
    if key not in _REFERENCE_CACHE:
        eng = build_engine_from_spec(_spec(variant))
        for r in _requests(n):
            eng.submit(r)
        _REFERENCE_CACHE[key] = {
            c.uid: [int(t) for t in c.tokens] for c in eng.run_until_idle() if c.ok}
    return _REFERENCE_CACHE[key]


# ------------------------------------------------- JAX's wire cases, on the port


@pytest.mark.parametrize("variant", [
    "dense", "paged",
    # spec handles carry draft caches on top: covered, but kept out of the
    # tier-1 budget as the JAX test is (runs under -m slow)
    pytest.param("spec", marks=pytest.mark.slow),
])
def test_handle_wire_roundtrip_bit_exact(variant):
    """serialize -> frame -> deserialize -> merge is bit-exact with the
    in-process handoff for every handle flavour: the split engines' tokens
    match the single disaggregated engine's, greedy and sampled."""
    reference = _run_reference(variant)

    peng = build_engine_from_spec(_spec(variant))           # prefill side
    deng = build_engine_from_spec(_spec(variant), remote_prefill=True)
    for r in _requests():
        peng.submit(r)
    got = {}
    counters = TransportCounters()
    while peng.pending or deng.has_work:
        h = peng.run_prefill_round()
        if h is not None:
            frame = serialize_handle(h, counters=counters,
                                     extra_header={"batch_id": "t:0"})
            header, _ = unpack_frame(frame)
            assert header["batch_id"] == "t:0"
            assert header["p_pad"] == h.p_pad
            before = {p: v.clone() for p, v in _flatten_state(h.state)}
            h2 = deserialize_handle(frame, counters=counters, device=deng.device)
            after = dict(_flatten_state(h2.state))
            assert sorted(before) == sorted(after)
            for path, exp in before.items():
                assert after[path].dtype == exp.dtype, path
                assert torch.equal(after[path], exp), path
            assert [r.uid for r in h2.requests] == [r.uid for r in h.requests]
            assert deng.admit_handle(h2)
        for c in deng.step():
            if c.ok:
                got[c.uid] = [int(t) for t in c.tokens]
    assert got == reference
    assert deng.stage_seconds["prefill_s"] == 0.0  # never ran prefill
    assert counters.ser_s > 0 and counters.de_s > 0


def test_truncated_frame_raises_desync():
    peng = build_engine_from_spec(_spec())
    for r in _requests(2):
        peng.submit(r)
    frame = serialize_handle(peng.run_prefill_round())
    with pytest.raises(FrameDesync):
        unpack_frame(frame[:20])            # inside the prefix
    with pytest.raises(FrameDesync):
        unpack_frame(frame[:-5])            # payload cut short
    with pytest.raises(FrameDesync):
        unpack_frame(b"XXXX" + frame[4:])   # bad magic
    with pytest.raises(FrameDesync):        # header bit flip
        buf = bytearray(frame)
        buf[30] ^= 0xFF
        unpack_frame(bytes(buf))


def test_payload_crc_mismatch_sheds_typed_with_header():
    """A payload flip raises FrameCorrupt CARRYING the header: the stream is
    still framed, so the router sheds or replays exactly the requests named
    in it instead of crashing."""
    peng = build_engine_from_spec(_spec())
    for r in _requests(2):
        peng.submit(r)
    frame = serialize_handle(peng.run_prefill_round(),
                             extra_header={"batch_id": "p:7"})
    buf = bytearray(frame)
    buf[-1] ^= 0xFF
    with pytest.raises(FrameCorrupt) as ei:
        deserialize_handle(bytes(buf))
    assert ei.value.header["batch_id"] == "p:7"
    assert [d["uid"] for d in ei.value.header["reqs"]] == [0, 1]


def test_request_wire_roundtrip_carries_deadline_budget():
    r = Request(uid="a", tokens=[1, 2], max_new_tokens=3, top_k=5,
                temperature=0.5, seed=9, ttl=10.0, submit_time=100.0)
    wire = request_to_wire(r, now=104.0)
    assert wire["deadline_remaining"] == pytest.approx(6.0)
    back = request_from_wire(wire, now=200.0)
    assert (back.uid, list(back.tokens), back.max_new_tokens) == ("a", [1, 2], 3)
    assert (back.top_k, back.temperature, back.seed) == (5, 0.5, 9)
    assert back.deadline == pytest.approx(206.0)
    none = request_to_wire(Request(uid="b", tokens=[1]), now=0.0)
    assert "deadline_remaining" not in none
    # the JAX package writes the same row for the same request
    jr = JaxRequest(uid="a", tokens=[1, 2], max_new_tokens=3, top_k=5,
                    temperature=0.5, seed=9, ttl=10.0, submit_time=100.0)
    assert jax_handoff.request_to_wire(jr, now=104.0) == wire


def test_frame_counters_merge():
    for cls in (TransportCounters, JaxTransportCounters):
        a, b = cls(), cls()
        a.sent(100), b.received(40)
        b.crc_failures += 1
        a.merge(b)
        a.merge({"frames_out": 2, "bytes_out": 10, "ser_s": 0.5})
        d = a.as_dict()
        assert d["frames_out"] == 3 and d["bytes_out"] == 110
        assert d["frames_in"] == 1 and d["bytes_in"] == 40
        assert d["crc_failures"] == 1 and d["ser_s"] == 0.5


def test_frames_are_byte_compatible():
    """``pack_frame`` writes JAX's bytes for the same header and payload, and
    each package unpacks the other's."""
    header = {"type": "ack", "batch_id": "0.0:3", "x": [1, 2.5, None]}
    payload = np.arange(10, dtype=np.float32)
    ours = pack_frame(header, [payload])
    assert ours == jax_handoff.pack_frame(header, [payload])
    got, view = jax_handoff.unpack_frame(ours)
    assert got == header and bytes(view) == payload.tobytes()
    assert unpack_frame(jax_handoff.pack_frame(header))[0] == header


# ----------------------------------------------------- across the packages


@pytest.fixture(scope="module")
def flax_params():
    model = JaxProGen(config=JAX_CFG, policy=jax_policy(False))
    tokens = jnp.zeros((1, CFG.seq_len), jnp.int32)
    return unbox(jax.jit(model.init)(jax.random.key(7), tokens))


@pytest.fixture(scope="module")
def model(flax_params):
    m = ProGen(CFG, make_policy(False), device="cpu")
    m.load_state_dict(params_from_flax(flax_params))
    return m.eval()


@pytest.fixture(scope="module")
def jax_bank():
    return jax_lora.random_lora_bank(JAX_CFG, num_tenants=3, rank=2, seed=3, scale=0.5)


def _mode_requests(mode: str) -> list[dict]:
    out = [dict(uid=i, tokens=[1 + i, 2, 3 + i % 2], max_new_tokens=6,
                top_k=None if i % 2 else 8, temperature=0.0 if i % 2 else 1.0,
                seed=100 + i) for i in range(4)]
    if mode == "infill":
        kw = JaxScaffoldSpec(**SCAFFOLD).request_kwargs()
        out[0].update(kw)
        out[3].update(kw)
    if mode == "lora":
        for i, r in enumerate(out):
            r["tenant"] = i % 3
    return out


def _leaves(frame) -> dict:
    """A frame's leaves as numpy arrays, read with JAX's ``unpack_frame``."""
    header, payload = jax_handoff.unpack_frame(frame)
    view = memoryview(payload).cast("B")
    return {path: np.frombuffer(view[off:off + nbytes], dtype=np.dtype(dtype)).reshape(shape)
            for path, dtype, shape, off, nbytes in header["manifest"]}


@pytest.fixture(scope="module", params=sorted(MODES))
def mode_run(request, flax_params, model, jax_bank):
    """One mode: the JAX engine's prefill frames (its rounds' handles, also
    admitted in process) and its in-process tokens; the port engine's
    frames of the same rounds."""
    mode = request.param
    kw = {**ENGINE_KW, **MODES[mode]}
    jax_kw, port_kw = dict(kw), dict(kw)
    if mode == "lora":
        jax_kw["lora_bank"] = jax_bank
        port_kw["lora_bank"] = bank_from_numpy(jax_bank)
    reqs = _mode_requests(mode)
    jeng = JaxServingEngine(JAX_CFG, flax_params, policy=jax_policy(False),
                            disagg=True, **jax_kw)
    peng = ServingEngine(model, disagg=True, **port_kw)
    for r in reqs:
        jeng.submit(JaxRequest(**r))
        peng.submit(Request(**r))
    handles, jax_frames, port_frames = [], [], []
    while jeng.pending:
        handles.append(jeng.run_prefill_round())
        jax_frames.append(jax_handoff.serialize_handle(handles[-1]))
        port_frames.append(serialize_handle(peng.run_prefill_round()))
    assert peng.pending == 0 and len(jax_frames) == 2
    for h in handles:  # the in-process handoff (after the rounds: a queued
        assert jeng.admit_handle(h)  # handle would be popped again)
    want = {c.uid: (c.tokens.tolist(), c.status)
            for c in jeng.run_until_idle(max_chunks=200)}
    return dict(mode=mode, kw=port_kw, model=model, reqs=reqs, want=want,
                jax_frames=jax_frames, port_frames=port_frames)


def test_manifests_and_leaves_equal_across_packages(mode_run):
    for jf, pf in zip(mode_run["jax_frames"], mode_run["port_frames"]):
        jh, _ = jax_handoff.unpack_frame(jf)
        ph, _ = jax_handoff.unpack_frame(pf)
        assert [m[:3] for m in ph["manifest"]] == [m[:3] for m in jh["manifest"]]
        assert ph["manifest"] == jh["manifest"]  # the same byte layout too
        assert ph["p_pad"] == jh["p_pad"]
        strip = lambda rows: [{k: v for k, v in d.items() if k != "trace"} for d in rows]
        assert strip(ph["reqs"]) == strip(jh["reqs"])
        want, got = _leaves(jf), _leaves(pf)
        assert ("tenant" in got) == (mode_run["mode"] == "lora")
        if mode_run["mode"] == "lora":
            assert got["tenant"].dtype == np.int32
            rows = [d.get("tenant", 0) for d in ph["reqs"]]
            assert got["tenant"][:len(rows)].tolist() == rows and any(rows)
        assert got["keys"].dtype == np.uint32
        for path, w in want.items():
            g = got[path]
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=path)
            else:
                np.testing.assert_array_equal(g, w, err_msg=path)


def test_jax_frames_drive_a_port_replica_to_jax_tokens(mode_run):
    """JAX's frames, read by the port and merged by a ``remote_prefill``
    replica, give the JAX in-process engine's tokens and statuses."""
    replica = ServingEngine(mode_run["model"], disagg=True, remote_prefill=True,
                            **mode_run["kw"])
    frames = list(mode_run["jax_frames"])
    got = {}
    while frames or replica.has_work:
        while frames:
            h = deserialize_handle(frames[0], device=replica.device)
            if not replica.admit_handle(h):
                break
            frames.pop(0)
        for c in replica.step():
            got[c.uid] = (c.tokens.tolist(), c.status)
    assert got == mode_run["want"]
    assert replica.stage_seconds["prefill_s"] == 0.0


def test_jax_reads_port_frames(mode_run):
    for pf in mode_run["port_frames"]:
        header, _ = jax_handoff.unpack_frame(pf)
        if any("logit_mask" in d for d in header["reqs"]):
            # JAX's reader passes request_from_wire no vocabulary
            with pytest.raises(jax_handoff.FrameCorrupt, match="vocab"):
                jax_handoff.deserialize_handle(pf)
            assert mode_run["mode"] == "infill"
            continue
        h = jax_handoff.deserialize_handle(pf)
        port = {p: v for p, v in _flatten_state(deserialize_handle(pf).state)}
        for path, leaf in jax_handoff._flatten_state(h.state):
            leaf = np.asarray(leaf)
            want = port[path].numpy()
            if path.endswith("keys"):
                want = want.astype(np.uint32)
            np.testing.assert_array_equal(leaf, want.astype(leaf.dtype), err_msg=path)


@pytest.mark.parametrize("mode_run", ["infill"], indirect=True)
def test_infill_masks_cross_with_their_requests(mode_run):
    h = deserialize_handle(mode_run["jax_frames"][0])
    want = JaxScaffoldSpec(**SCAFFOLD).request_kwargs()["logit_mask"]
    assert np.array_equal(h.requests[0].logit_mask, np.asarray(want))
    assert h.requests[1].logit_mask is None


def test_a_port_handle_state_that_jax_cannot_hold_is_refused():
    """An int64 leaf with no wire dtype is a caller bug, not a frame."""
    from progen_tpu_torch.decode.handoff import Handle
    bad = Handle(requests=[], state={"pos": torch.zeros(2, dtype=torch.int64)}, p_pad=4)
    with pytest.raises(TypeError, match="wire dtype"):
        serialize_handle(bad)
    keys = torch.tensor([[0, 0xFFFFFFFF], [0x80000000, 7]], dtype=torch.int64)
    frame = serialize_handle(Handle(requests=[], state={"keys": keys}, p_pad=4))
    assert _leaves(frame)["keys"].tolist() == keys.tolist()
    assert torch.equal(deserialize_handle(frame).state["keys"], keys)
