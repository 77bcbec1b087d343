"""Port parity for disaggregated prefill/decode serving
(``serving_plane/disagg.py``) and the serving element's peer migration
(``elements/llm_serve.py`` over ``edge/query.py``'s CTRL channel): the
cases of ``tests/test_disagg.py`` and ``tests/test_llm_migrate_element.py``
run through the port, on the JAX package's seed-5 weights exported as an
npz, against the JAX package's greedy solo run (``decode.generate``). Beside
them: a port prefill server handing off to a reference decode server, and
a drain to a peer server.

Tolerances: greedy token ids identical; the decode side's
``kv_prefill_chunks`` unchanged (no prefill runs again there).
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import decode as jdec
from nnstreamer_tpu.models import transformer as jtfm
from nnstreamer_tpu_torch.edge import query as q
from nnstreamer_tpu_torch.elements.base import ElementError
from nnstreamer_tpu_torch.serving_plane.disagg import parse_decode_peers
from nnstreamer_tpu_torch.tensors.frame import Frame

VOCAB, D_MODEL, N_HEADS, N_LAYERS = 211, 32, 2, 1


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jparams():
    # the reference's own eager init (a jitted init gives other bits)
    return jtfm.init_params(jax.random.PRNGKey(5), vocab=VOCAB, d_model=D_MODEL,
                            n_heads=N_HEADS, n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def npz(jparams, tmp_path_factory):
    path = tmp_path_factory.mktemp("lm") / "lm.npz"
    np.savez(path, **{f"p{i}": np.asarray(x)
                      for i, x in enumerate(jax.tree_util.tree_leaves(jparams))})
    return str(path)


@pytest.fixture(scope="module")
def alone(jparams):
    """The JAX package's greedy solo run of a prompt."""
    def run(prompt, n_new=10):
        toks = jdec.generate(jparams, np.asarray(prompt, np.int32)[None, :], N_HEADS, n_new)
        return [int(t) for t in np.asarray(toks)[0]]
    return run


def _mk(npz, **kw):
    from nnstreamer_tpu_torch.elements.llm_serve import _LlmServer

    kv = dict(kv_layout="paged", block_size=16)
    if "kv_blocks" in kw:
        kv["kv_blocks"] = kw.pop("kv_blocks")
    base = dict(model="zoo:transformer_lm",
                options={"vocab": str(VOCAB), "d_model": str(D_MODEL), "n_heads": str(N_HEADS),
                         "n_layers": str(N_LAYERS), "params": npz},
                n_slots=2, max_len=64, prompt_len=16, default_new=10,
                device=torch.device("cpu"), kv_kw=kv)
    base.update(kw)
    return _LlmServer(**base)


def _pump_until(srv, cond, timeout=120.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        srv.pump()


def _prompt(seed, n=6):
    return np.random.default_rng(seed).integers(1, VOCAB, (n,)).astype(np.int32)


# -- the decode-peers grammar and the role props (no model) -------------------------------

def test_parse_decode_peers_equal_to_reference():
    from nnstreamer_tpu.serving_plane.disagg import parse_decode_peers as jparse

    for spec, dflt in (("h1:9001,h2:9002/3", 0), (" h:5001 , ", 7)):
        assert parse_decode_peers(spec, default_llm_id=dflt) == jparse(spec, default_llm_id=dflt)
    assert parse_decode_peers("h1:9001,h2:9002/3") == [("h1", 9001, 0), ("h2", 9002, 3)]
    for bad in ("", "noport", "h:", "h:0", "h:x", "h:1/abc", "a:1,a:1"):
        with pytest.raises(ValueError):
            parse_decode_peers(bad)


def test_role_props_validation():
    """role= fails at construction, before any model opens."""
    from nnstreamer_tpu_torch.elements.llm_serve import _LlmServer
    from nnstreamer_tpu_torch.serving_plane.llm import LlmPlaneError

    def mk(paged=True, **kw):
        return _LlmServer(model="zoo:transformer_lm", options={}, n_slots=1, max_len=32,
                          prompt_len=8, default_new=4, device=torch.device("cpu"),
                          kv_kw=dict(kv_layout="paged") if paged else None, **kw)

    with pytest.raises(ElementError, match="prefill or decode"):
        mk(role="both")
    with pytest.raises(ElementError, match="role=prefill"):
        mk(role="decode", decode_peers="h:1")
    with pytest.raises(ElementError, match="kv-layout=paged"):
        mk(paged=False, role="prefill")
    with pytest.raises(LlmPlaneError, match="role= refused"):
        mk(role="decode", plane="dg-pl")
    with pytest.raises(ElementError, match="decode-peers"):
        mk(role="prefill", decode_peers="nonsense")


def test_plane_refuses_migration_surface_typed():
    from nnstreamer_tpu_torch.elements.llm_serve import _LlmServer
    from nnstreamer_tpu_torch.serving_plane.llm import LlmPlane, LlmPlaneError

    for bad in (dict(checkpoint_dir="/tmp/nowhere"), dict(checkpoint_every_tokens=2)):
        with pytest.raises(LlmPlaneError, match="refused"):
            _LlmServer(model="zoo:transformer_lm", options={}, n_slots=1, max_len=32,
                       prompt_len=8, default_new=4, device=torch.device("cpu"),
                       kv_kw=dict(kv_layout="paged"), plane="mig-pl", **bad)
    with pytest.raises(LlmPlaneError, match="private kv-layout=paged"):
        LlmPlane("mig-pl0", cb=None).refuse_migration("migrate_span")


# -- the CTRL wire through a real port serversrc (no model) ------------------------------

class _FakeDecode:
    def __init__(self):
        self.adopt_exc = None
        self.done = {7: [1, 2, 3]}
        self.pending = {8}
        self.probed, self.adopted = [], []

    def migration_probe(self, tokens):
        self.probed.append([int(t) for t in tokens])
        return 16

    def migration_advert(self):
        return {"role": "decode", "free_slots": 2, "free_blocks": 40}

    def migration_adopt(self, span_bytes):
        if self.adopt_exc is not None:
            raise self.adopt_exc
        self.adopted.append(bytes(span_bytes))
        return 7

    def disagg_fetch(self, rid):
        from nnstreamer_tpu_torch.kv.migrate import SpanStateError

        if rid in self.done:
            return self.done.pop(rid)
        if rid in self.pending:
            return None
        raise SpanStateError(f"rid {rid} unknown")


class _SrcLoop:
    """A serversrc whose generate() runs on a thread (the CTRL service)."""

    def __init__(self, mod, name, srv_id):
        self.src = mod.TensorQueryServerSrc(name, port=0, id=srv_id)
        self.src.start()
        self.port = self.src.bound_port
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.is_set():
            self.src.generate()

    def stop(self):
        self._stop.set()
        self._t.join(timeout=2)
        self.src.stop()


@pytest.mark.parametrize("client", ["port", "reference"])
def test_disagg_ctrl_wire_roundtrip(client):
    """Probe-ack with the decode advert, the capacity NACK with its retry
    hint, fetch once / None / refused, and a draining endpoint refusing
    spans but serving fetches; the client side of the handshake from
    either package against a port serversrc."""
    from nnstreamer_tpu.edge import query as jq
    from nnstreamer_tpu_torch.kv.blocks import PoolCapacityError

    c = q if client == "port" else jq
    h = _FakeDecode()
    q.register_migration_handler(31, h)
    loop = _SrcLoop(q, f"dg-wire-{client}", f"dg-w-{client}")
    try:
        shared, advert = c.probe_migration_full("127.0.0.1", loop.port, [1, 2, 3], llm_id=31)
        assert shared == 16 and h.probed[-1] == [1, 2, 3]
        assert advert["role"] == "decode" and advert["free_blocks"] == 40
        assert c.send_migration("127.0.0.1", loop.port, b"span-bytes", llm_id=31) == 7
        assert h.adopted == [b"span-bytes"]
        h.adopt_exc = PoolCapacityError("pool full", 8, 2)
        with pytest.raises(c.MigrationRefused, match="PoolCapacityError") as ei:
            c.send_migration("127.0.0.1", loop.port, b"x", llm_id=31)
        assert ei.value.retry_after_ms > 0
        assert c.fetch_handoff("127.0.0.1", loop.port, 7, llm_id=31) == [1, 2, 3]
        with pytest.raises(c.MigrationRefused, match="SpanStateError"):
            c.fetch_handoff("127.0.0.1", loop.port, 7, llm_id=31)
        assert c.fetch_handoff("127.0.0.1", loop.port, 8, llm_id=31) is None
        # the process's only handler answers any llm_id
        assert c.probe_migration("127.0.0.1", loop.port, [5], llm_id=123) == 16
        loop.src.drain()
        with pytest.raises(c.MigrationRefused, match="draining"):
            c.probe_migration_full("127.0.0.1", loop.port, [1], llm_id=31)
        h.done[9] = [4, 5]
        assert c.fetch_handoff("127.0.0.1", loop.port, 9, llm_id=31) == [4, 5]
    finally:
        q.unregister_migration_handler(31)
        loop.stop()
    loop = _SrcLoop(q, f"dg-wire2-{client}", f"dg-w2-{client}")
    try:
        with pytest.raises(c.MigrationRefused, match="no-migration-handler"):
            c.probe_migration("127.0.0.1", loop.port, [1], llm_id=9)
    finally:
        loop.stop()


# -- drain: resume fallback and peer migration ------------------------------------------

def test_drain_resume_fallback_and_draining_refusal(npz, alone):
    """drain(migrate_to=<nothing listening>) resumes by re-prefill, the
    generated tokens kept and the stream equal to the reference's solo
    run; a submit while draining is refused with ``draining``."""
    srv = _mk(npz, srv_id="mig-d1")
    try:
        prompt = _prompt(3)
        srv.submit(Frame((prompt,), meta={"req": "d1", "frame_id": "f-d1"}))
        rid = next(iter(srv._pending))
        _pump_until(srv, lambda: len(srv.cb.partials([rid]).get(rid) or ()) >= 3)
        summary = srv.drain(migrate_to="127.0.0.1:1")
        assert summary["resumed"] == 1 and summary["migrated"] == 0
        with pytest.raises(ElementError, match="draining"):
            srv.submit(Frame((prompt,), meta={}))
        assert srv.drain()["kept"] == 1
        _pump_until(srv, lambda: srv._out)
        toks, meta = srv.pop()
        assert meta["req"] == "d1" and meta["frame_id"] == "f-d1"
        assert [int(t) for t in toks] == alone(prompt, 10)
    finally:
        srv.release_plane()


def test_drain_migrates_to_peer_bitwise(npz, alone):
    """drain(migrate_to=peer) after some tokens: every request continues
    on the peer (behind a real serversrc) and finishes equal to the
    uninterrupted run, with no prefill run on the peer."""
    peer = _mk(npz, srv_id="41")
    loop = _SrcLoop(q, "mig-peer", "mig-peer")
    src = _mk(npz, srv_id="40")
    try:
        prompts = [_prompt(50), _prompt(51, n=20)]
        for i, p in enumerate(prompts):
            src.submit(Frame((p,), meta={"req": f"m{i}", "frame_id": f"f-m{i}"}))
        rids = list(src._pending)
        _pump_until(src, lambda: all(len(src.cb.partials(rids).get(r) or ()) >= 4 for r in rids))
        summary = src.drain(migrate_to=f"127.0.0.1:{loop.port}/41")
        assert summary == {"migrated": 2, "resumed": 0, "completed": 0, "kept": 0}
        assert not src._pending
        _pump_until(peer, lambda: len(peer._out) >= 2)
        got = {}
        while peer._out:
            toks, meta = peer.pop()
            got[meta["req"]] = ([int(t) for t in toks], meta["frame_id"])
        assert got == {f"m{i}": (alone(p, 10), f"f-m{i}") for i, p in enumerate(prompts)}
        st = peer.cb.stats()
        assert st["kv_prefill_chunks"] == 0 and st["kv_migrations_in"] == 2
        assert peer.stats()["adopted"]["spans"] == 2
    finally:
        src.release_plane()
        peer.release_plane()
        loop.stop()


# -- prefill -> decode handoff ----------------------------------------------------------

class _DecodeHost:
    """A decode-role server behind a real serversrc: a CTRL thread and a
    pump thread, the deployment's shape without the client data path."""

    def __init__(self, npz, name, srv_id, **kw):
        self.srv = _mk(npz, srv_id=srv_id, role="decode", **kw)
        self.loop = _SrcLoop(q, name, f"dg-{name}")
        self.port = self.loop.port
        self._stop = threading.Event()
        self._tp = threading.Thread(target=self._pump, daemon=True)
        self._tp.start()

    def _pump(self):
        while not self._stop.is_set():
            try:
                self.srv.pump()
            except Exception:  # noqa: BLE001 — teardown race
                pass
            time.sleep(0.001)

    def stop(self):
        self._stop.set()
        self._tp.join(timeout=2)
        self.loop.stop()
        self.srv.release_plane()


def test_disagg_fp_handoff_bitwise_zero_reprefill(npz, alone):
    """Prefill on A, decode on B: tokens equal to the reference's solo run,
    B's prefill-chunk counter never moves, A delivers under the original
    frame_id; a draining B makes A decode locally with no token lost."""
    host = _DecodeHost(npz, "dg-b1", "52")
    a = _mk(npz, srv_id="51", role="prefill", decode_peers=f"127.0.0.1:{host.port}/52")
    try:
        p1, p2 = _prompt(31), _prompt(32)
        a.submit(Frame((p1,), meta={"req": "r1", "frame_id": "f-1"}))
        a.submit(Frame((p2,), meta={"req": "r2", "frame_id": "f-2"}))
        _pump_until(a, lambda: len(a._out) >= 2, what="2 relayed")
        got = {}
        for _ in range(2):
            toks, meta = a.pop()
            got[meta["req"]] = ([int(t) for t in toks], meta)
        assert got["r1"][0] == alone(p1, 10) and got["r2"][0] == alone(p2, 10)
        assert got["r1"][1]["frame_id"] == "f-1" and got["r2"][1]["frame_id"] == "f-2"
        assert not host.srv._out and not host.srv._disagg_done
        bst = host.srv.cb.stats()
        assert bst["kv_prefill_chunks"] == 0 and bst["kv_migrations_in"] == 2
        ast = a.stats()
        assert ast["disagg_role"] == "prefill"
        assert ast["disagg"]["counts"]["handoff"] == 2
        assert ast["disagg"]["counts"]["relayed"] == 2
        host.loop.src.drain()
        p3 = _prompt(33)
        a.submit(Frame((p3,), meta={"req": "r3", "frame_id": "f-3"}))
        _pump_until(a, lambda: a._out, what="local-fallback generation")
        toks, meta = a.pop()
        assert [int(t) for t in toks] == alone(p3, 10) and meta["frame_id"] == "f-3"
        assert a.stats()["disagg"]["counts"].get("local", 0) >= 1
        assert a._disagg.idle()
        a.eos = True
        assert a.drained
    finally:
        a.release_plane()
        host.stop()


def test_disagg_too_small_peer_decodes_locally(npz, alone):
    """A decode peer whose arena cannot hold the span refuses it: the
    span re-enters the prefill server's own arena (outcome ``local``) and
    the tokens still equal the solo run."""
    # 4 blocks of 16 hold one max_len request; a 40-token prompt plus its
    # budget needs 4, which the 4-block peer's pool cannot free twice
    host = _DecodeHost(npz, "dg-small", "82", kv_blocks=4, n_slots=1)
    a = _mk(npz, srv_id="81", role="prefill", decode_peers=f"127.0.0.1:{host.port}/82")
    filler = _prompt(90, n=40)
    host.srv.submit(Frame((filler,), meta={"req": "filler"}))
    try:
        prompt = _prompt(91, n=40)
        a.submit(Frame((prompt,), meta={"req": "s1", "frame_id": "f-s1"}))
        _pump_until(a, lambda: a._out, what="local generation")
        toks, meta = a.pop()
        assert [int(t) for t in toks] == alone(prompt, 10) and meta["frame_id"] == "f-s1"
        # each refusal benches the peer briefly; a retry after it is refused
        # again, so the count of local outcomes depends on the timing
        counts = a.stats()["disagg"]["counts"]
        assert counts.get("local", 0) >= 1 and set(counts) == {"local"}
    finally:
        a.release_plane()
        host.stop()


def test_disagg_int8_warm_handoff_bitwise(npz):
    """int8 arenas hand off bitwise; a decode peer already holding the
    prompt's blocks gets a stripped span and still prefills nothing."""
    host = _DecodeHost(npz, "dg-b2", "62", cache_dtype="int8")
    a = _mk(npz, srv_id="61", role="prefill", cache_dtype="int8",
            decode_peers=f"127.0.0.1:{host.port}/62")
    try:
        prompt = _prompt(41, n=16)
        host.srv.submit(Frame((prompt,), meta={"req": "ref"}))
        deadline = time.monotonic() + 120.0
        while not host.srv._out:
            assert time.monotonic() < deadline, "solo run timed out"
            time.sleep(0.005)
        ref_toks, _ = host.srv.pop()
        assert host.srv.cb.probe_prefix([int(t) for t in prompt]) == 16
        base_chunks = host.srv.cb.stats()["kv_prefill_chunks"]
        a.submit(Frame((prompt,), meta={"req": "h1", "frame_id": "f-h"}))
        _pump_until(a, lambda: a._out, what="relayed int8 generation")
        toks, meta = a.pop()
        assert [int(t) for t in toks] == [int(t) for t in ref_toks] and meta["frame_id"] == "f-h"
        bst = host.srv.cb.stats()
        assert bst["kv_prefill_chunks"] == base_chunks and bst["kv_migrations_in"] == 1
        assert a.stats()["disagg"]["counts"]["handoff"] == 1
    finally:
        a.release_plane()
        host.stop()


def test_port_prefill_hands_off_to_reference_decode(npz, alone):
    """Across the packages: a port prefill server ships its span to a JAX
    decode server behind a reference serversrc; the reference decodes it
    with no prefill and the port delivers tokens equal to the solo run."""
    from nnstreamer_tpu.edge import query as jq
    from nnstreamer_tpu.elements.llm_serve import _LlmServer as JServer

    jsrv = JServer(model="zoo:transformer_lm",
                   options={"vocab": str(VOCAB), "d_model": str(D_MODEL), "n_heads": str(N_HEADS),
                            "n_layers": str(N_LAYERS), "seed": "5"},
                   n_slots=2, max_len=64, prompt_len=16, default_new=10, kv_layout="paged",
                   block_size=16, kv_blocks=0, srv_id="92", role="decode")
    loop = _SrcLoop(jq, "dg-jx", "dg-jx")
    stop = threading.Event()

    def pump():
        while not stop.is_set():
            try:
                jsrv.pump()
            except Exception:  # noqa: BLE001 — teardown race
                pass
            time.sleep(0.001)

    t = threading.Thread(target=pump, daemon=True)
    t.start()
    a = _mk(npz, srv_id="91", role="prefill", decode_peers=f"127.0.0.1:{loop.port}/92")
    try:
        prompt = _prompt(77, n=20)
        a.submit(Frame((prompt,), meta={"req": "x1", "frame_id": "f-x1"}))
        _pump_until(a, lambda: a._out, what="relayed from the reference")
        toks, meta = a.pop()
        assert [int(t) for t in toks] == alone(prompt, 10) and meta["frame_id"] == "f-x1"
        assert a.stats()["disagg"]["counts"]["handoff"] == 1
        assert jsrv.cb.stats()["kv_migrations_in"] == 1
    finally:
        a.release_plane()
        stop.set()
        t.join(timeout=2)
        loop.stop()
        jsrv.release_plane()


@pytest.mark.slow
def test_disagg_soak_two_by_two_mid_drain(npz, alone):
    """2 prefill x 2 decode under rolling traffic while one decode server
    drains mid-stream: every request ends equal to the solo run."""
    d1 = _DecodeHost(npz, "dgs-d1", "71")
    d2 = _DecodeHost(npz, "dgs-d2", "72")
    peers = f"127.0.0.1:{d1.port}/71,127.0.0.1:{d2.port}/72"
    prefills = [_mk(npz, srv_id="73", role="prefill", decode_peers=peers),
                _mk(npz, srv_id="74", role="prefill", decode_peers=peers)]
    try:
        expect = {}
        deadline = time.monotonic() + 240.0

        def submit(i):
            p = _prompt(100 + i)
            expect[f"s-{i}"] = alone(p, 10)
            prefills[i % 2].submit(Frame((p,), meta={"req": f"s-{i}", "frame_id": f"sf-{i}"}))

        def pump_all_until(n):
            while sum(len(a._out) for a in prefills) < n:
                assert time.monotonic() < deadline, "soak timed out"
                for a in prefills:
                    a.pump()

        for i in range(4):
            submit(i)
        pump_all_until(2)
        d1.loop.src.drain()
        for i in range(4, 8):
            submit(i)
        pump_all_until(8)
        got = {}
        for a in prefills:
            while a._out:
                toks, meta = a.pop()
                got[meta["req"]] = [int(t) for t in toks]
        assert got == expect
        for a in prefills:
            assert a._disagg.idle()
        assert not d1.srv._disagg_done
    finally:
        for a in prefills:
            a.release_plane()
        d1.stop()
        d2.stop()
