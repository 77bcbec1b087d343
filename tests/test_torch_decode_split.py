"""The split history of the decode-attention kernels K3 and K4, on the CPU.

On the card, K3 (``csrc/decode_attention.cu``) and K4
(``csrc/paged_attention.cu``) cut each slot's history in chunks of
``split_plan(...).chunk`` rows, one block each, and a combine kernel merges
the chunks' partial states (``online_softmax_merge``); K4 folds the pending
token after the last chunk. Here the same recurrence runs with the plain
primitives of ``ops/kernels/_primitives.py``: each live chunk from the
initial state, the chunks merged, then the finalize. It is held against
the unsplit plain versions and against the JAX package's reference and
Pallas kernel (interpret mode), on numpy-seeded inputs.

Tolerances: 2e-5 for float32 and int8 caches (float32 sums in another
order), 2e-2 against the JAX package for bfloat16 (the Pallas kernel's own
tolerance); split against unsplit plain in bfloat16 is 2e-5, since both
compute in float32 from the same bfloat16 values.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nnstreamer_tpu.kv.block_attn import paged_attention_ref as jpaged_ref
from nnstreamer_tpu.ops.pallas import _primitives as jprim
from nnstreamer_tpu.ops.pallas.decode_attention import (
    decode_attention as jdecode_attention,
    decode_attention_ref,
)
from nnstreamer_tpu.ops.pallas.paged_attention import paged_decode_attention as jpaged
from nnstreamer_tpu_torch.ops.kernels import _primitives as prim
from nnstreamer_tpu_torch.ops.kernels import decode_attention as da
from nnstreamer_tpu_torch.ops.kernels import paged_attention as pa

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _empty_state(lead, d):
    m = torch.empty(lead)
    l = torch.empty(lead)
    acc = torch.empty((*lead, d))
    prim.online_softmax_init(m, l, acc)
    return m, l, acc


def _chunk_state(q, k, v, rows, live, scale):
    """One chunk's partial state from the initial state: q [KV, g, D],
    k/v [KV, n, D] float32 of history rows ``rows`` (a 1-D index tensor),
    rows at or past ``live`` masked as the kernel masks them."""
    s = prim.scaled_qk(q, k, scale)                             # [KV, g, n]
    s, v = prim.mask_dead_columns(s, v, rows, live)
    return prim.online_softmax_update(s, v, *_empty_state(s.shape[:2], q.shape[-1]))


def _merge_chunks(states, lead, d):
    """The combine: the chunks' states stacked and merged (none: the empty
    state)."""
    if not states:
        return _empty_state(lead, d)
    m, l, acc = (torch.stack(x, dim=-1) for x in zip(*states))
    return prim.online_softmax_merge(m, l, acc.movedim(-1, -2))


def split_decode_attention(q, ck, cv, pos, ks=None, vs=None, chunk=None):
    """K3's split recurrence with the plain primitives: [B, 1, H, D]."""
    b, _, h, d = q.shape
    s_len, n_kv = ck.shape[1], ck.shape[2]
    plan = da.split_plan(s_len)
    chunk = chunk or plan.chunk
    scale = 1.0 / d ** 0.5
    out = []
    for i in range(b):
        live = min(int(pos[i]) + 1, s_len)
        qf = q[i, 0].float().reshape(n_kv, h // n_kv, d)
        k = ck[i].permute(1, 0, 2)                              # [KV, S, D]
        v = cv[i].permute(1, 0, 2)
        if ks is not None:
            k = prim.dequant_rows(k, ks[i].permute(1, 0))
            v = prim.dequant_rows(v, vs[i].permute(1, 0))
        states = []
        for sp in range(da.live_splits(live, chunk)):          # empty chunks: never read
            rows = torch.arange(sp * chunk, min((sp + 1) * chunk, s_len))
            states.append(_chunk_state(qf, k[:, rows].float(), v[:, rows].float(), rows, live,
                                       scale)[:3])
        _, l, acc = _merge_chunks(states, (n_kv, h // n_kv), d)
        out.append(prim.online_softmax_finalize(l, acc).reshape(1, h, d))
    return torch.stack(out)


def split_paged_attention(q, ak, av, tables, pos, fk, fv, ks=None, vs=None, chunk=None):
    """K4's split recurrence with the plain primitives: the history chunks
    through the block table, merged, then the pending token folded last."""
    b, _, h, d = q.shape
    _, bs, n_kv, _ = ak.shape
    nb = tables.shape[1]
    chunk = chunk or pa.split_plan(nb * bs).chunk
    scale = 1.0 / d ** 0.5
    out = []
    for i in range(b):
        hist = min(max(int(pos[i]), 0), nb * bs)
        qf = q[i, 0].float().reshape(n_kv, h // n_kv, d)
        states = []
        for sp in range(da.live_splits(hist, chunk)):
            rows = torch.arange(sp * chunk, min((sp + 1) * chunk, nb * bs))
            live_rows = rows[rows < hist]  # entries past the history are never read
            blk = tables[i, live_rows // bs].long()
            k = torch.zeros((rows.numel(), n_kv, d))
            v = torch.zeros((rows.numel(), n_kv, d))
            kl, vl = ak[blk, live_rows % bs].float(), av[blk, live_rows % bs].float()
            if ks is not None:
                kl = prim.dequant_rows(kl, ks[blk, live_rows % bs])
                vl = prim.dequant_rows(vl, vs[blk, live_rows % bs])
            k[: live_rows.numel()], v[: live_rows.numel()] = kl, vl
            states.append(_chunk_state(qf, k.permute(1, 0, 2), v.permute(1, 0, 2), rows, hist,
                                       scale)[:3])
        m, l, acc = _merge_chunks(states, (n_kv, h // n_kv), d)
        f_k = fk[i, 0].float()[:, None, :]                      # [KV, 1, D]
        f_v = fv[i, 0].float()[:, None, :]
        _, l, acc = prim.online_softmax_update(prim.scaled_qk(qf, f_k, scale), f_v, m, l, acc)
        out.append(prim.online_softmax_finalize(l, acc).reshape(1, h, d))
    return torch.stack(out)


# -- the launch plan -----------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 31, 32, 127, 128, 129, 600, 4096, 4097])
def test_split_plan_covers_every_live_row_once(rows):
    """The chunks K3/K4 launch for a history of up to ``rows`` rows: a
    multiple of 32 rows each (every tile height of csrc/attn_tile.cuh), at
    most 1024, and for every live length the chunks below it, which the
    blocks attend and the combine merges, hold each live row exactly once."""
    chunk, splits = da.split_plan(rows)
    assert chunk % 32 == 0 and 0 < chunk <= 1024
    assert splits * chunk >= rows and (splits - 1) * chunk < rows
    assert pa.split_plan is da.split_plan
    for live in sorted({0, 1, chunk - 1, chunk, chunk + 1, rows - 1, rows}):
        if not 0 <= live <= rows:
            continue
        n = da.live_splits(live, chunk)
        assert n <= splits
        seen = np.zeros(rows, int)
        for sp in range(n):
            lo, hi = sp * chunk, min((sp + 1) * chunk, live)
            assert lo < hi  # a chunk the combine reads holds a live row
            seen[lo:hi] += 1
        assert (seen[:live] == 1).all() and (seen[live:] == 0).all()


# -- the merge ---------------------------------------------------------------------


def test_merge_of_chunk_states_equals_one_update_over_all_columns():
    """online_softmax_merge of states over disjoint columns, in any order,
    equals one update over all of them (the reference's recurrence, JAX),
    and an empty state (NEG_INF, 0, 0) is its identity."""
    rng = np.random.default_rng(0)
    s = rng.standard_normal((3, 40)).astype(np.float32) * 3
    v = rng.standard_normal((40, 8)).astype(np.float32)
    m0 = np.full((3,), jprim.NEG_INF, np.float32)
    l0 = np.zeros((3,), np.float32)
    acc0 = np.zeros((3, 8), np.float32)
    _, jl, jacc = jprim.online_softmax_update(s, v, m0, l0, acc0)
    want = np.asarray(jprim.online_softmax_finalize(jl, jacc, jnp.float32))
    cuts = [0, 7, 8, 25, 40]
    states = [prim.online_softmax_update(_t(s[:, a:b]), _t(v[a:b]), *_empty_state((3,), 8))
              for a, b in zip(cuts, cuts[1:])]
    empty = _empty_state((3,), 8)
    for order in ([0, 1, 2, 3], [3, 1, 0, 2]):
        picked = [states[i] for i in order] + [empty]
        m, l, acc = (torch.stack(x, dim=-1) for x in zip(*picked))
        m, l, acc = prim.online_softmax_merge(m, l, acc.movedim(-1, -2))
        np.testing.assert_allclose(prim.online_softmax_finalize(l, acc).numpy(), want,
                                   atol=TOL, rtol=0)
    m, l, acc = (torch.stack(x, dim=-1) for x in zip(empty, empty))
    m, l, acc = prim.online_softmax_merge(m, l, acc.movedim(-1, -2))
    assert bool((m <= prim.NEG_INF).all()) and not l.any() and not acc.any()
    assert not prim.online_softmax_finalize(l, acc).any()  # nothing attended: exactly 0


# -- K3 ---------------------------------------------------------------------------


def _k3_inputs(b, h, n_kv, d, s_len, pos, dtype="float32", seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    if dtype == "int8":
        ck = rng.integers(-127, 128, (b, s_len, n_kv, d)).astype(np.int8)
        cv = rng.integers(-127, 128, (b, s_len, n_kv, d)).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, (b, s_len, n_kv)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, (b, s_len, n_kv)).astype(np.float32)
    else:
        ck = rng.standard_normal((b, s_len, n_kv, d)).astype(np.float32)
        cv = rng.standard_normal((b, s_len, n_kv, d)).astype(np.float32)
        ks = vs = None
    return q, ck, cv, np.asarray(pos, np.int32), ks, vs


K3_CASES = {
    # live lengths chunk - 1, chunk and chunk + 1 (pos is the last live row)
    "chunk-edges": dict(b=3, h=4, n_kv=2, d=16, s_len=64, pos=[14, 15, 16], chunk=16),
    # pos 0 (one live row), and chunks past the live length that are never read
    "pos0-and-empty-chunks": dict(b=2, h=4, n_kv=4, d=16, s_len=96, pos=[0, 37], chunk=32),
    # a wrapped ring's absolute positions, past the cache length
    "wrapped": dict(b=2, h=2, n_kv=2, d=16, s_len=48, pos=[48, 3 * 48 + 7], chunk=16),
    "int8": dict(b=2, h=4, n_kv=2, d=16, s_len=80, pos=[11, 79], chunk=32, dtype="int8"),
    "bf16": dict(b=2, h=8, n_kv=2, d=32, s_len=70, pos=[5, 69], chunk=32, dtype="bfloat16"),
    # the launch plan's own chunk (128 rows) over a 300-row cache
    "plan-chunk": dict(b=2, h=8, n_kv=2, d=16, s_len=300, pos=[127, 299]),
}


@pytest.mark.parametrize("name", list(K3_CASES))
def test_k3_split_recurrence_matches_unsplit_and_reference(name):
    p = dict(K3_CASES[name])
    chunk, dtype = p.pop("chunk", None), p.pop("dtype", "float32")
    q, ck, cv, pos, ks, vs = _k3_inputs(**p, dtype=dtype)
    tq, tk, tv = _t(q), _t(ck), _t(cv)
    jq, jk, jv = (jnp.asarray(a) for a in (q, ck, cv))
    if dtype == "bfloat16":
        tq, tk, tv = (a.to(torch.bfloat16) for a in (tq, tk, tv))
        jq, jk, jv = (a.astype(jnp.bfloat16) for a in (jq, jk, jv))
    kw_t = dict(k_scale=_t(ks), v_scale=_t(vs)) if ks is not None else {}
    kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)) if ks is not None else {}
    got = split_decode_attention(tq, tk, tv, pos, kw_t.get("k_scale"), kw_t.get("v_scale"),
                                 chunk)
    assert got.dtype == torch.float32 and got.shape == q.shape and torch.isfinite(got).all()
    plain = da.plain_decode_attention(tq, tk, tv, _t(pos), **kw_t)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    tol = 2e-2 if dtype == "bfloat16" else TOL
    ref = decode_attention_ref(jq, jk, jv, jnp.asarray(pos), **kw_j)
    pallas = jdecode_attention(jq, jk, jv, jnp.asarray(pos), block_k=16, interpret=True, **kw_j)
    for want in (ref, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)


def test_k3_split_ignores_nan_past_the_live_rows():
    """Stale cache rows past a slot's live length may hold NaN: rows past
    `live` in a live chunk are masked and zeroed, chunks wholly past it are
    never read, so the output stays finite and equal to the clean cache's
    (and to the reference's on the clean cache)."""
    q, ck, cv, pos, _, _ = _k3_inputs(2, 4, 2, 16, 64, [9, 40])
    clean = split_decode_attention(_t(q), _t(ck), _t(cv), pos, chunk=16)
    # read back before the NaN writes: on the CPU jnp.asarray may share the
    # numpy buffers, and JAX's dispatch is asynchronous
    want = np.asarray(decode_attention_ref(*(jnp.asarray(a) for a in (q, ck, cv, pos))))
    for i, p in enumerate(pos):
        ck[i, p + 1:] = np.nan
        cv[i, p + 1:] = np.nan
    got = split_decode_attention(_t(q), _t(ck), _t(cv), pos, chunk=16)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, clean, rtol=0, atol=0)
    plain = da.plain_decode_attention(_t(q), _t(ck), _t(cv), _t(pos))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


# -- K4 ---------------------------------------------------------------------------------


def _k4_inputs(b, h, n_kv, d, bs, nb, n_blocks, pos, dtype="float32", nan=False, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    tables = rng.permutation(n_blocks)[: b * nb].reshape(b, nb).astype(np.int32)
    fk = rng.standard_normal((b, 1, n_kv, d)).astype(np.float32)
    fv = rng.standard_normal((b, 1, n_kv, d)).astype(np.float32)
    ks = vs = None
    if dtype == "int8":
        ak = rng.integers(-127, 128, (n_blocks, bs, n_kv, d)).astype(np.int8)
        av = rng.integers(-127, 128, (n_blocks, bs, n_kv, d)).astype(np.int8)
        ks = rng.uniform(0.01, 0.1, (n_blocks, bs, n_kv)).astype(np.float32)
        vs = rng.uniform(0.01, 0.1, (n_blocks, bs, n_kv)).astype(np.float32)
    else:
        ak = rng.standard_normal((n_blocks, bs, n_kv, d)).astype(np.float32)
        av = rng.standard_normal((n_blocks, bs, n_kv, d)).astype(np.float32)
    if nan:
        live = np.zeros((n_blocks, bs), bool)
        for i in range(b):
            r = np.arange(min(max(pos[i], 0), nb * bs))
            live[tables[i, r // bs], r % bs] = True
        ak[~live] = np.nan
        av[~live] = np.nan
    return q, ak, av, tables, np.asarray(pos, np.int32), fk, fv, ks, vs


K4_CASES = {
    # histories of chunk - 1, chunk and chunk + 1 rows (pos is the history length)
    "chunk-edges": dict(b=3, h=4, n_kv=2, d=16, bs=8, nb=6, n_blocks=18, pos=[15, 16, 17],
                        chunk=16),
    # pos 0: no history, only the pending token's column
    "pos0-fresh-only": dict(b=2, h=4, n_kv=4, d=16, bs=8, nb=4, n_blocks=8, pos=[0, 0],
                            chunk=16),
    # a pos past the table's reach (clamped to nb * bs), and an empty slot
    "pos-past-table": dict(b=2, h=4, n_kv=2, d=16, bs=8, nb=3, n_blocks=8, pos=[90, 0],
                           chunk=16),
    "int8": dict(b=2, h=2, n_kv=2, d=16, bs=8, nb=6, n_blocks=12, pos=[9, 40], chunk=32,
                 dtype="int8"),
    "nan-outside-history": dict(b=2, h=4, n_kv=2, d=16, bs=8, nb=8, n_blocks=20, pos=[5, 43],
                                chunk=16, nan=True),
    "bf16": dict(b=2, h=4, n_kv=2, d=16, bs=8, nb=6, n_blocks=12, pos=[7, 33], chunk=32,
                 dtype="bfloat16"),
    # the launch plan's own chunk (128 rows) over a 256-row table
    "plan-chunk": dict(b=2, h=8, n_kv=2, d=16, bs=16, nb=16, n_blocks=40, pos=[128, 250]),
}


@pytest.mark.parametrize("name", list(K4_CASES))
def test_k4_split_recurrence_matches_unsplit_and_reference(name):
    p = dict(K4_CASES[name])
    chunk, dtype = p.pop("chunk", None), p.get("dtype", "float32")
    q, ak, av, tables, pos, fk, fv, ks, vs = _k4_inputs(**p)
    tq, tk, tv, tfk, tfv = (_t(a) for a in (q, ak, av, fk, fv))
    jq, jk, jv, jfk, jfv = (jnp.asarray(a) for a in (q, ak, av, fk, fv))
    if dtype == "bfloat16":
        tq, tk, tv, tfk, tfv = (a.to(torch.bfloat16) for a in (tq, tk, tv, tfk, tfv))
        jq, jk, jv, jfk, jfv = (a.astype(jnp.bfloat16) for a in (jq, jk, jv, jfk, jfv))
    tks, tvs = (_t(ks), _t(vs)) if ks is not None else (None, None)
    kw_j = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)) if ks is not None else {}
    got = split_paged_attention(tq, tk, tv, _t(tables), pos, tfk, tfv, tks, tvs, chunk)
    assert got.dtype == torch.float32 and got.shape == q.shape and torch.isfinite(got).all()
    plain = pa.plain_paged_attention(tq, tk, tv, _t(tables), _t(pos), tfk, tfv, tks, tvs)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=0)
    tol = 2e-2 if dtype == "bfloat16" else TOL
    jt, jpos = jnp.asarray(tables), jnp.asarray(pos)
    ref = jpaged_ref(jq, jk, jv, jt, jpos, (jfk, jfv), **kw_j)
    pallas = jpaged(jq, jk, jv, jt, jpos, jfk, jfv, interpret=True, **kw_j)
    for want in (ref, pallas):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol, rtol=0)
