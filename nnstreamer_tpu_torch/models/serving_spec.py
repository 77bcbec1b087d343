"""Speculative decoding and registered prefixes for the serving engine.

The speculative half of ``nnstreamer_tpu/models/serving.py``, kept in a
module of its own beside ``serving_paged.py``: the device-side helpers of a
speculative round, the batched draft model, and the batcher methods
(``spec_step``, ``spec_pump``, ``register_prefix``, ...) mixed into
:class:`~nnstreamer_tpu_torch.models.serving.ContinuousBatcher`.

A round: each active slot offers its pending token plus ``k - 1`` proposals
(the most recent earlier occurrence of its suffix ``g``-gram in its token
history, :func:`device_ngram_propose`, or ``k`` greedy steps of a draft
model, :class:`_DraftEngine`); one ``k``-column forward of the target
(:func:`batched_verify_step`, or ``kv/block_attn.py
batched_verify_step_block`` / the gather oracle on the paged layout) scores
them and writes their K/V; :func:`spec_accept` keeps the accepted prefix
plus one correction or bonus token; :func:`spec_emit_hist` records the
emitted tokens in the history. Everything is device work gated by masks,
with no read of the host and no shape that depends on the acceptance, so a
pump of ``R`` rounds is one program: on CUDA a captured CUDA graph.

Greedy slots accept while the proposal equals the target's argmax, so
their streams are the plain steps' (up to the verify forward's summation
order against K3 / K4, as the reference says of its XLA verify against its
Pallas kernels). Sampling slots use point-mass rejection sampling against
the filtered distribution ``sample_tokens`` draws from, with uniforms and
residual draws from the sampler's counter-based hash keyed by (request
seed, fill, draw), so their streams are distribution-exact, not
byte-identical to ``step()``'s, as in the reference.

The verify attention is the reference's inline formulation (masked matmul
and softmax over the cache), not a kernel.

On a windowed ring (``windowed=True``) a write at ``(pos + j) % W`` would
clobber a row still inside the window of the chunk's earlier queries, so
the round verifies against the pre-write ring beside the chunk's own K/V
(:func:`batched_windowed_verify`, the draft's :func:`draft_windowed_propose`)
and writes only the certified columns after the acceptance
(:func:`commit_ring_chunk`); the token history is a ring too
(``hist_write_row(..., wrap=True)``).
"""

from __future__ import annotations

import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nnstreamer_tpu_torch.models import decode as dec
from nnstreamer_tpu_torch.models import transformer as tfm
from nnstreamer_tpu_torch.models.speculative import ngram_lookup

_M32 = 0xFFFFFFFF
_GOLDEN32 = 0x9E3779B9


# -- device helpers ----------------------------------------------------------------------


def batched_verify_step(model: tfm.TransformerLM, toks, pos, active, cache, n_heads: int,
                        compute_dtype: torch.dtype = torch.float32):
    """Score per-slot k-token chunks in one forward: toks [B, k] (column
    0 the pending token, columns 1.. the proposals), pos [B] the fill,
    active [B] → (logits [B, k, V] float32, cache). Column j sits at
    position pos + j and attends cache positions ≤ pos + j; the chunk's
    K/V are written in place at pos .. pos + k - 1 for active slots
    (quantized for an int8 cache, then attended dequantized). The caller
    keeps pos + k ≤ max_len for every active slot; rejected columns are
    overwritten before any mask reaches them."""
    from nnstreamer_tpu_torch.models.serving import dequantize_kv, quantize_kv, write_cols

    quantized = isinstance(cache[0], tuple)
    if quantized:
        (ck8, ksc), (cv8, vsc) = cache
        max_len = ck8.shape[2]
    else:
        ck_all, cv_all = cache
        max_len = ck_all.shape[2]
    b, k = toks.shape
    x = tfm.embed_lookup(model.embed, toks, compute_dtype)
    positions = pos[:, None] + torch.arange(k, dtype=pos.dtype, device=pos.device)[None, :]
    mask = torch.arange(max_len, device=pos.device)[None, None, :] <= positions[:, :, None]
    for layer, blk in enumerate(model.blocks):
        q, kk, v = tfm.block_qkv(x, blk, n_heads, positions)
        if quantized:
            k8, ks = quantize_kv(kk)
            v8, vs = quantize_kv(v)
            write_cols(ck8[layer], k8, pos, active)
            write_cols(ksc[layer], ks, pos, active)
            write_cols(cv8[layer], v8, pos, active)
            write_cols(vsc[layer], vs, pos, active)
            ck = dequantize_kv(ck8[layer], ksc[layer])
            cv = dequantize_kv(cv8[layer], vsc[layer])
        else:
            write_cols(ck_all[layer], kk, pos, active)
            write_cols(cv_all[layer], v, pos, active)
            ck, cv = ck_all[layer], cv_all[layer]
        o = tfm.cache_attention(q, ck, cv, mask)
        o = o.to(x.dtype).reshape(b, k, -1)
        x = x + F.linear(o, tfm.wt(blk.wo.weight, x.dtype))
        x = tfm.block_ffn(x, blk)
    x = tfm.rmsnorm(x, model.ln_f)
    return F.linear(x, tfm.wt(model.head.weight, x.dtype)).float(), cache


def _draw_row(keys: torch.Tensor, fill: torch.Tensor, draw: int) -> torch.Tensor:
    """The 32-bit row hash of (slot key, fill, draw): the sampler's
    (key, fill) row mixed once more with the draw number, so a round's
    acceptance uniform (draw 1) and residual sample (draw 2) at a fill
    never share noise with each other or with a plain step's."""
    from nnstreamer_tpu_torch.models.serving import _mix32

    row = _mix32(_mix32(keys.long()) ^ (fill.long() & _M32))
    return _mix32(row ^ ((draw * _GOLDEN32) & _M32))


def uniform_draw(keys: torch.Tensor, fill: torch.Tensor, draw: int) -> torch.Tensor:
    """One uniform in (0, 1) float32 a slot, keyed by (key, fill, draw):
    the top 23 bits of the row's hash centred in their bin."""
    from nnstreamer_tpu_torch.models.serving import _mix32

    h = _mix32(_draw_row(keys, fill, draw))
    return ((h >> 9).float() + 0.5) * (1.0 / (1 << 23))


def gumbel_draw(keys: torch.Tensor, fill: torch.Tensor, vocab: int, draw: int) -> torch.Tensor:
    """Gumbel noise [B, V] keyed by (key, fill, draw, vocab index), the
    construction of ``serving.gumbel_noise`` on the draw's row."""
    from nnstreamer_tpu_torch.models.serving import _gumbel_of_hash, _mix32

    row = _draw_row(keys, fill, draw)
    cols = torch.arange(vocab, dtype=torch.int64, device=keys.device)
    return _gumbel_of_hash(_mix32(_mix32((row[:, None] + cols[None, :]) & _M32)))


def spec_accept(logits, toks, temp, topk, topp, keys, pos, sampling: bool):
    """Device-side acceptance of one speculative round.

    logits [B, k, V] (column j conditioned on toks[:, :j+1]), toks
    [B, k] (column 0 the pending token, -1 a column with no proposal),
    the slots' sampling settings and keys, pos [B] → (m [B] int32, final
    [B] int32): the round commits m chunk columns and emits toks[:, 1:m]
    then ``final``. Greedy slots accept while the proposal equals the
    previous column's argmax. Sampling slots (temp > 0) accept a proposal
    x with probability p̃(x) under the filtered distribution, else draw
    from p̃ with x removed (a plain p̃ draw for a column with no
    proposal); on full acceptance the bonus token is drawn from the last
    column. ``sampling`` False: the greedy-only program, without the
    filtering and the noise."""
    from nnstreamer_tpu_torch.models.serving import _filtered_logits

    b, k, v = logits.shape
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not sampling:
        match = toks[:, 1:] == greedy[:, :-1]
        m = 1 + torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
        final = torch.gather(greedy, 1, (m - 1).long()[:, None])[:, 0]
        return m, final
    is_sampling = temp > 0
    m = torch.ones((b,), dtype=torch.int32, device=logits.device)
    done = torch.zeros((b,), dtype=torch.bool, device=logits.device)
    final = torch.zeros((b,), dtype=torch.int32, device=logits.device)
    vocab = torch.arange(v, device=logits.device)
    for j in range(1, k):
        lg = logits[:, j - 1]
        prop = toks[:, j]
        greedy_col = greedy[:, j - 1]
        valid = prop >= 0
        safe = torch.clamp(prop, 0, v - 1).long()
        filt = _filtered_logits(lg, temp, topk, topp)
        p_prop = torch.gather(torch.softmax(filt, dim=-1), 1, safe[:, None])[:, 0]
        fill = pos + j
        acc = torch.where(is_sampling, uniform_draw(keys, fill, 1) < p_prop,
                          greedy_col == prop) & valid
        residual = torch.where((vocab[None, :] == safe[:, None]) & valid[:, None],
                               torch.full_like(filt, float("-inf")), filt)
        resampled = torch.argmax(residual + gumbel_draw(keys, fill, v, 2), dim=-1)
        final_rej = torch.where(is_sampling, resampled.to(torch.int32), greedy_col)
        rejecting = ~done & ~acc
        final = torch.where(rejecting, final_rej, final)
        m = m + (~done & acc).to(torch.int32)
        done = done | rejecting
    last = logits[:, k - 1]
    bonus_s = torch.argmax(_filtered_logits(last, temp, topk, topp)
                           + gumbel_draw(keys, pos + k, v, 1), dim=-1).to(torch.int32)
    bonus = torch.where(is_sampling, bonus_s, greedy[:, k - 1])
    return m, torch.where(done, final, bonus)


def hist_write_row(hist: torch.Tensor, row: torch.Tensor, start: torch.Tensor,
                   count: torch.Tensor, wrap: bool = False) -> None:
    """In place: hist [B, H][b, start[b] + j] ← row[b, j] for the first
    count[b] columns of ``row`` [B, K]. ``wrap=True``: hist is a ring over
    the last H stream positions (the token at absolute position a lives
    at a % H), the windowed batcher's layout beside its KV ring; without
    it writes past H - 1 clamp onto the last cell (unreachable: submit
    keeps fill + budget ≤ max_len)."""
    b, h = hist.shape
    kk = row.shape[1]
    cols = torch.arange(kk, device=hist.device)
    raw = start.long()[:, None] + cols[None, :]
    idx = raw % h if wrap else torch.clamp(raw, 0, h - 1)
    keep = cols[None, :] < count[:, None]
    lanes = torch.arange(b, device=hist.device)[:, None]
    hist[lanes, idx] = torch.where(keep, row.to(hist.dtype), hist[lanes, idx])


def device_ngram_propose(hist: torch.Tensor, pos: torch.Tensor, k: int, g: int,
                         wrap: bool = False) -> torch.Tensor:
    """Prompt-lookup proposals on the device: hist [B, H] int32 the slots'
    token histories (-1 padded, hist[pos] the pending token), pos [B] →
    [B, k - 1] int32: the tokens that followed the most recent earlier
    occurrence of the suffix ``g``-gram ending at ``pos``, -1 where the
    lookup finds nothing or runs past ``pos``. A fixed-width scan of the
    whole history: no data-dependent shape. ``wrap=True``: hist is a ring
    (:func:`hist_write_row`), unrolled into stream order first, so the
    pending token is the last cell once the ring has wrapped."""
    b, h = hist.shape
    idx = torch.arange(h, device=hist.device)
    p = pos.long()[:, None]
    if wrap:
        start = torch.where(p >= h, (p + 1) % h, torch.zeros_like(p))
        hist = torch.gather(hist, 1, (idx[None, :] + start) % h)
        p = torch.clamp(p, max=h - 1)
    ok = idx[None, :] < p
    for i in range(g):
        shifted = hist[:, torch.clamp(idx - i, min=0)]
        tgt = torch.gather(hist, 1, torch.clamp(p - i, 0, h - 1))
        ok = ok & (shifted == tgt) & (shifted >= 0) & (idx - i >= 0)[None, :] & (p - i >= 0)
    j = torch.max(torch.where(ok, idx[None, :], torch.full_like(idx[None, :], -1)), dim=1).values
    cols = j[:, None] + 1 + torch.arange(k - 1, device=hist.device)[None, :]
    valid = (j >= 0)[:, None] & (cols <= p)
    got = torch.gather(hist, 1, torch.clamp(cols, 0, h - 1))
    return torch.where(valid, got, torch.full_like(got, -1))


def spec_emit_hist(toks, m, final, active, hist, pos, windowed: bool = False) -> torch.Tensor:
    """The emitted row [B, k] of one round (the m - 1 accepted proposals,
    then the correction or bonus token, -1 beyond and on idle slots),
    recorded in ``hist`` at pos + 1 .. pos + m in place (a ring when
    ``windowed``), so later rounds mine the whole context."""
    b, kk = toks.shape
    j = torch.arange(kk, device=toks.device)[None, :]
    prop_part = torch.cat([toks[:, 1:], torch.full_like(toks[:, :1], -1)], dim=1)
    neg = torch.full_like(toks, -1)
    emit = torch.where(j < (m - 1)[:, None], prop_part,
                       torch.where(j == (m - 1)[:, None], final[:, None].expand_as(toks), neg))
    emit = torch.where(active[:, None], emit, neg)
    hist_write_row(hist, emit, pos + 1, m, wrap=windowed)
    return emit


# -- the windowed ring's verify-then-commit ------------------------------------------------


def _ring_live_mask(pos: torch.Tensor, W: int, row: torch.Tensor) -> torch.Tensor:
    """Ring-row liveness for chunk queries on a pre-write W-ring: pos [B]
    absolute fill, row [R] chunk-column indices → [B, R, W] bool. Ring row
    s last held absolute position pos - 1 - d with d = (wp - 1 - s) mod W
    (wp = pos % W); the query of column r (absolute pos + r) attends it iff
    written (d ≤ pos - 1) and inside the window (d ≤ W - 2 - r). One
    definition for the target's verify and the draft's propose: masks
    that drifted apart would only lower the acceptance, silently."""
    p = pos.long()
    d = (p[:, None] % W - 1 - torch.arange(W, device=pos.device)[None, :]) % W  # [B, W]
    lim = torch.minimum(p[:, None] - 1, W - 2 - row.long()[None, :])             # [B, R]
    return d[:, None, :] <= lim[:, :, None]


def batched_windowed_verify(model: tfm.TransformerLM, toks, pos, active, cache, n_heads: int,
                            compute_dtype: torch.dtype = torch.float32):
    """Score per-slot k-token chunks against a ring cache without writing
    it: the windowed form of :func:`batched_verify_step`. Column j's row
    (pos + j) % W still holds position pos + j - W, inside the window of
    every earlier query, so the forward attends the pre-write ring beside
    the chunk's own K/V, and :func:`commit_ring_chunk` writes the accepted
    columns after. toks [B, k], pos [B] absolute, ring [L, B, W, KV, Dh]
    (float, or the int8 ``((ck8, ksc), (cv8, vsc))``) → (logits [B, k, V]
    float32, chunk_ks, chunk_vs [L, B, k, KV, Dh] in the compute dtype).
    With an int8 ring the chunk's columns are attended as their
    quantize → dequantize round trip, what a plain int8 step attends after
    its write, so greedy rounds stay the plain int8 steps' tokens.
    Chunk columns are causal (k ≤ W keeps them in the window)."""
    from nnstreamer_tpu_torch.models.serving import dequantize_kv, quantize_kv

    quantized = isinstance(cache[0], tuple)
    if quantized:
        (ck8, ksc), (cv8, vsc) = cache
        W = ck8.shape[2]
    else:
        ck_all, cv_all = cache
        W = ck_all.shape[2]
    b, k = toks.shape
    dev = toks.device
    x = tfm.embed_lookup(model.embed, toks, compute_dtype)
    row = torch.arange(k, device=dev)
    positions = pos[:, None] + row.to(pos.dtype)[None, :]
    chunk_mask = (row[None, :] <= row[:, None])[None].expand(b, k, k)
    mask = torch.cat([_ring_live_mask(pos, W, row), chunk_mask], dim=2)  # [B, k, W + k]
    chunk_ks, chunk_vs = [], []
    for layer, blk in enumerate(model.blocks):
        q, kk, v = tfm.block_qkv(x, blk, n_heads, positions)
        if quantized:
            ck = dequantize_kv(ck8[layer], ksc[layer])
            cv = dequantize_kv(cv8[layer], vsc[layer])
            ka = dequantize_kv(*quantize_kv(kk)).to(kk.dtype)
            va = dequantize_kv(*quantize_kv(v)).to(v.dtype)
        else:
            ck, cv = ck_all[layer], cv_all[layer]
            ka, va = kk, v
        o = tfm.cache_attention(q, torch.cat([ck.to(kk.dtype), ka], dim=1),
                                torch.cat([cv.to(v.dtype), va], dim=1), mask)
        o = o.to(x.dtype).reshape(b, k, -1)
        x = x + F.linear(o, tfm.wt(blk.wo.weight, x.dtype))
        x = tfm.block_ffn(x, blk)
        chunk_ks.append(kk.to(compute_dtype))
        chunk_vs.append(v.to(compute_dtype))
    x = tfm.rmsnorm(x, model.ln_f)
    logits = F.linear(x, tfm.wt(model.head.weight, x.dtype)).float()
    return logits, torch.stack(chunk_ks), torch.stack(chunk_vs)


def commit_ring_chunk(cache, chunk_ks, chunk_vs, pos, n_commit, active) -> None:
    """In place: the first n_commit[b] chunk columns [L, B, k, KV, Dh] into
    the ring at rows (pos_b + j) % W where active: the commit after the
    acceptance (only certified columns overwrite window history). Each
    column wraps on its own: a decode-time chunk may start anywhere in the
    ring. Quantizes for an int8 ring."""
    from nnstreamer_tpu_torch.models.serving import quantize_kv

    quantized = isinstance(cache[0], tuple)
    W = (cache[0][0] if quantized else cache[0]).shape[2]
    b = pos.shape[0]
    lanes = torch.arange(b, device=pos.device)

    def write(c, col, rows, keep):
        # c [L, B, W, ...] ← col [L, B, ...] at each lane's ring row
        gate = keep.view(1, -1, *([1] * (col.dim() - 2)))
        c[:, lanes, rows] = torch.where(gate, col.to(c.dtype), c[:, lanes, rows])

    for j in range(chunk_ks.shape[2]):
        rows = (pos.long() + j) % W
        keep = active & (j < n_commit)
        kj, vj = chunk_ks[:, :, j], chunk_vs[:, :, j]
        if quantized:
            (ck8, ksc), (cv8, vsc) = cache
            k8, ks = quantize_kv(kj)
            v8, vs = quantize_kv(vj)
            write(ck8, k8, rows, keep)
            write(ksc, ks, rows, keep)
            write(cv8, v8, rows, keep)
            write(vsc, vs, rows, keep)
        else:
            write(cache[0], kj, rows, keep)
            write(cache[1], vj, rows, keep)


def draft_windowed_propose(model: tfm.TransformerLM, tok, pos, cache, n_heads: int, k: int,
                           compute_dtype: torch.dtype = torch.float32):
    """k - 1 greedy draft proposals per slot against a ring cache without
    writing it: the draft's side of the verify-then-commit discipline.
    The k-step chain runs against the pre-write ring beside its own chunk
    (column j attends the ring rows inside position pos + j's window and
    the chunk columns ≤ j), kept in a fixed [L, B, k] buffer that
    :func:`commit_ring_chunk` lands once the target has ruled. tok [B]
    (the pending tokens, column 0), pos [B] absolute → (props [B, k - 1]
    int32, chunk_ks, chunk_vs [L, B, k, KV, Dh]). Idle slots are not
    gated here: the commit's ``active`` gate keeps their columns out."""
    ck_all, cv_all = cache
    L, b, W, kv, hd = ck_all.shape
    dev = tok.device
    cks = torch.zeros((L, b, k, kv, hd), dtype=compute_dtype, device=dev)
    cvs = torch.zeros_like(cks)
    cur = tok
    props = []
    for j in range(k):
        x = tfm.embed_lookup(model.embed, cur, compute_dtype)[:, None, :]
        positions = (pos + j)[:, None]
        # the column index made on the device (a host copy would break a capture)
        ring_mask = _ring_live_mask(pos, W, torch.full((1,), j, device=dev))  # [B, 1, W]
        chunk_mask = (torch.arange(k, device=dev) <= j)[None, None, :].expand(b, 1, k)
        mask = torch.cat([ring_mask, chunk_mask], dim=2)
        for layer, blk in enumerate(model.blocks):
            q, kk, v = tfm.block_qkv(x, blk, n_heads, positions)
            cks[layer, :, j] = kk[:, 0].to(compute_dtype)
            cvs[layer, :, j] = v[:, 0].to(compute_dtype)
            o = tfm.cache_attention(q, torch.cat([ck_all[layer].to(compute_dtype), cks[layer]], 1),
                                    torch.cat([cv_all[layer].to(compute_dtype), cvs[layer]], 1),
                                    mask)
            o = o.to(x.dtype).reshape(b, 1, -1)
            x = x + F.linear(o, tfm.wt(blk.wo.weight, x.dtype))
            x = tfm.block_ffn(x, blk)
        x = tfm.rmsnorm(x, model.ln_f)
        logits = F.linear(x, tfm.wt(model.head.weight, x.dtype)).float()
        cur = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        if j + 1 < k:
            props.append(cur)
    return torch.stack(props, dim=1), cks, cvs


# -- the batched draft model -------------------------------------------------------------


class _DraftEngine:
    """A draft model proposing for every slot at once (reference
    ``serving.py _DraftEngine``): its own slot cache [L, B, max_len, KV,
    Dh] in the compute dtype (never quantized), filled at admission with
    the request's whole context and kept at the target's positions.
    Proposing on a linear cache runs k greedy batched steps, writing as it
    goes: rejected positions are overwritten before a mask reaches them,
    and the k-th step's write covers the last proposal on full acceptance.
    On a windowed ring (``windowed``) that write would clobber live window
    rows, so the draft proposes against its pre-write ring
    (:meth:`propose_windowed`) and the round commits only the accepted
    columns (:meth:`commit`), as the target does. Every plain step of the
    target steps the draft too (:meth:`advance_one`), so the draft never
    falls behind. Its steps take no attention kernel, as in the
    reference."""

    def __init__(self, params: tfm.TransformerLM, n_heads: int, n_slots: int, max_len: int,
                 prompt_len: int, compute_dtype: torch.dtype, device: torch.device,
                 windowed: bool = False) -> None:
        self.params = params
        self.n_heads = n_heads
        self.max_len = max_len
        self.prompt_len = prompt_len
        self.compute_dtype = compute_dtype
        self.device = device
        self.windowed = windowed
        d = params.d_model
        hd = d // n_heads
        kv = tfm.n_kv_heads_of(params.blocks[0].wqkv.weight, d, n_heads)
        shape = (params.n_layers, n_slots, max_len, kv, hd)
        self._cache = tuple(torch.zeros(shape, dtype=compute_dtype, device=device)
                            for _ in range(2))
        stage_len = (-(-max_len // prompt_len) + 1) * prompt_len
        self._stage_shape = (params.n_layers, 1, stage_len, kv, hd)
        self._ring_shape = (params.n_layers, 1, max_len, kv, hd)

    def prefill_tokens(self, tokens: np.ndarray):
        """The draft's K/V of a request's whole context (prefix + prompt),
        in prompt_len buckets → (ks, vs) [L, 1, max_len, KV, Dh] (on a
        windowed batcher the ring of the context's last max_len tokens).
        No logits: the first pending token is the target's."""
        P = self.prompt_len
        t = int(tokens.shape[0])
        shape = self._ring_shape if self.windowed else self._stage_shape
        stage = tuple(torch.zeros(shape, dtype=self.compute_dtype, device=self.device)
                      for _ in range(2))
        cpos = 0
        while cpos < t:
            n = min(P, t - cpos)
            chunk = np.zeros((1, P), np.int64)
            chunk[0, :n] = tokens[cpos:cpos + n]
            chunk_t = torch.as_tensor(chunk, device=self.device)
            if self.windowed:
                _, stage, _ = dec.windowed_chunk(
                    self.params, chunk_t, cpos, n, stage, self.n_heads,
                    compute_dtype=self.compute_dtype, return_logits=False,
                )
            else:
                _, stage, _ = dec.verify_chunk(
                    self.params, chunk_t, cpos, stage, self.n_heads,
                    compute_dtype=self.compute_dtype, return_logits=False,
                )
            cpos += n
        return stage[0][:, :, :self.max_len], stage[1][:, :, :self.max_len]

    def admit(self, slot: int, draft_kv) -> None:
        from nnstreamer_tpu_torch.models.serving import insert_slot

        insert_slot(self._cache, draft_kv[0], draft_kv[1], slot)

    def _step(self, tok, pos, active):
        from nnstreamer_tpu_torch.models.serving import batched_decode_step

        logits, _, pos2 = batched_decode_step(self.params, tok, pos, active, self._cache,
                                              self.n_heads, self.compute_dtype,
                                              windowed=self.windowed)
        return torch.argmax(logits, dim=-1).to(torch.int32), pos2

    def propose(self, tok, pos, active, k: int) -> torch.Tensor:
        """k greedy steps from the pending tokens → proposals [B, k - 1]
        int32 (the k-th step exists for its write). Linear caches only."""
        cur, p = tok, pos
        props = []
        for _ in range(k):
            cur, p = self._step(cur, p, active)
            props.append(cur)
        return torch.stack(props[:k - 1], dim=1)

    def propose_windowed(self, tok, pos, k: int):
        """The ring's proposals: → (props [B, k - 1], the chunk's K/V for
        :meth:`commit`), the ring untouched."""
        return draft_windowed_propose(self.params, tok, pos, self._cache, self.n_heads, k,
                                      self.compute_dtype)

    def commit(self, chunk_ks, chunk_vs, pos, m, active) -> None:
        """Land the accepted columns of a :meth:`propose_windowed` chunk."""
        commit_ring_chunk(self._cache, chunk_ks, chunk_vs, pos, m, active)

    def advance_one(self, tok, pos, active) -> None:
        """Write the pending tokens' K/V without proposing: the draft's
        half of a plain step."""
        self._step(tok, pos, active)


# -- the batcher's speculative and prefix methods ------------------------------------------

class SpecDecoding:
    """Speculative rounds and registered prefixes, mixed into
    ``ContinuousBatcher``, which provides the slot state, the device
    buffers, ``_prepare_locked``, ``_launch``, ``_harvest_locked``,
    ``_run_locked`` and the staging helpers."""

    def _init_spec(self, draft_params, draft_n_heads: Optional[int]) -> None:
        self._draft = None
        if draft_params is not None:
            if draft_params.embed.device != self.device:
                raise ValueError(
                    f"draft params live on {draft_params.embed.device}, the batcher runs on "
                    f"{self.device}"
                )
            heads = draft_n_heads or self.n_heads
            if self._shards is None:
                self._draft = _DraftEngine(draft_params, heads, self.n_slots, self.max_len,
                                           self.prompt_len, self.compute_dtype, self.device,
                                           self.windowed)
            else:
                import copy

                # the batcher's own engine only prefills (no slots); each
                # shard's steps and proposes over its slots on its device
                self._draft = _DraftEngine(draft_params, heads, 0, self.max_len,
                                           self.prompt_len, self.compute_dtype, self.device,
                                           self.windowed)
                for sh in self._shards:
                    sparams = (draft_params if sh.device == self.device
                               else copy.deepcopy(draft_params).to(sh.device))
                    sh._draft = _DraftEngine(sparams, heads, sh.n, self.max_len,
                                             self.prompt_len, self.compute_dtype, sh.device,
                                             self.windowed)
        elif self._shards is not None:
            for sh in self._shards:
                sh._draft = None
        # slot layout: id → ((ks, vs) trimmed to the prefix, its length, its tokens);
        # paged: id → (tokens, pinned blocks)
        self._prefixes: Dict[int, Tuple] = {}
        self._next_prefix = 0
        self._n_spec_rounds = 0
        self._n_spec_accepted = 0
        self._n_spec_columns = 0  # proposal columns offered (the rate's normalizer)
        # the reference's plain-step fallbacks inside spec_step, counted
        self._n_spec_fallback_no_room = 0
        self._n_spec_fallback_no_proposal = 0
        self._n_spec_sentinel_rounds = 0

    # -- registered prefixes ---------------------------------------------------------------
    def register_prefix(self, tokens) -> int:
        """Prefill a shared prompt prefix (a system prompt) once and return
        its id; ``submit(prefix=id)`` then starts from its K/V. The slot
        layout keeps the staged K/V trimmed to the prefix on the device
        and loads it into each request's stage; the paged layout prefills
        it into pool blocks, registers them in the prefix index and pins
        them until :meth:`unregister_prefix`, so later submits hit the
        index whether or not they pass ``prefix=``.

        A windowed batcher stores the prefix's ring: a prefix starts at
        absolute position 0, so its ring placement is the same for every
        request. Its length must be a multiple of prompt_len (and max_len
        too), so each request's continuation chunks stay bucket-aligned and
        never wrap the ring mid-write; it may exceed the window, whose ring
        then holds its last max_len tokens."""
        self._check_failed()
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        plen = int(tokens.shape[0])
        if self.windowed:
            P = self.prompt_len
            if plen <= 0 or plen % P:
                raise ValueError(
                    f"windowed prefix length {plen} must be a positive multiple of "
                    f"prompt_len({P}) so per-request continuation chunks stay bucket-aligned"
                )
            if self.max_len % P:
                raise ValueError(
                    f"windowed prefix caching needs max_len({self.max_len}) to be a multiple "
                    f"of prompt_len({P})"
                )
            with torch.no_grad():
                _, ring, _ = self._stage_ring(tokens, 0, None, False)
            with self._lock:
                pid = self._next_prefix
                self._next_prefix += 1
                self._prefixes[pid] = (ring, plen, tokens)
            return pid
        if not 0 < plen < self.max_len:
            raise ValueError(f"prefix length {plen} not in (0, max_len={self.max_len})")
        if self._paged:
            # the block writes land in the live arena: serialized with the steps
            with self._step_lock, torch.no_grad():
                _, stage = self._stage_chunks(tokens, 0, self._empty_stage(), False)
                bs = self.block_size
                n_blocks = -(-plen // bs)
                with self._lock:
                    blocks = self._pool.alloc(n_blocks)
                ids = np.zeros((self._stage_len // bs,), np.int32)
                valid = np.zeros((self._stage_len // bs,), bool)
                ids[:n_blocks] = blocks
                valid[:n_blocks] = True
                try:
                    self._land_stage(self._cache, stage, ids, valid)
                except Exception as exc:
                    self._mark_failed(exc)  # the arena was written in place
                    raise
                with self._lock:
                    self._pool.register(tokens, blocks)
                    pid = self._next_prefix
                    self._next_prefix += 1
                    self._prefixes[pid] = (tokens, blocks)
            return pid
        with torch.no_grad():
            _, stage = self._stage_chunks(tokens, 0, self._empty_stage(), False)
            stored = (stage[0][:, :, :plen].clone(), stage[1][:, :, :plen].clone())
        with self._lock:
            pid = self._next_prefix
            self._next_prefix += 1
            self._prefixes[pid] = (stored, plen, tokens)
        return pid

    def unregister_prefix(self, pid: int) -> bool:
        """Release a registered prefix (requests already admitted keep
        their copy or their own block references)."""
        with self._lock:
            item = self._prefixes.pop(pid, None)
            if item is None:
                return False
            if self._paged:
                self._pool.free(item[1])
            return True

    def probe_prefix(self, tokens) -> int:
        """Leading tokens of ``tokens`` whose K/V the pool holds in full
        indexed blocks (read-only; 0 on the slot layout)."""
        if not self._paged:
            return 0
        toks = np.asarray(tokens, np.int32).reshape(-1)
        with self._lock:
            m = self._pool.match(toks)
        return len(m.full) * self.block_size

    def _prefix_locked(self, prefix: Optional[int]):
        """The registered prefix's entry (caller holds _lock)."""
        if prefix not in self._prefixes:
            raise ValueError(f"unknown prefix id {prefix}")
        return self._prefixes[prefix]

    def _load_prefix(self, pfx) -> Tuple[torch.Tensor, torch.Tensor]:
        """A fresh stage with a registered prefix's K/V at positions 0.."""
        (ks, vs), plen, _ = pfx
        stage = self._empty_stage()
        stage[0][:, :, :plen] = ks
        stage[1][:, :, :plen] = vs
        return stage

    # -- the spec programs -----------------------------------------------------------------
    def _verify(self, st, toks, pos, active):
        """The k-column verify forward over holder ``st``'s cache (this
        layout's) → logits [B, k, V] (the cache written in place)."""
        if not self._paged:
            return batched_verify_step(st.params, toks, pos, active, st._cache,
                                       self.n_heads, self.compute_dtype)[0]
        tables = self._tables_dev
        if self._kv_attn == "gather":
            from nnstreamer_tpu_torch.kv import gather as kvg

            view = kvg.gather_cache(self._cache, tables)
            logits, _ = batched_verify_step(self.params, toks, pos, active, view,
                                            self.n_heads, self.compute_dtype)
            kvg.scatter_window(self._cache, tables, view, pos, toks.shape[1], active)
            return logits
        from nnstreamer_tpu_torch.kv.block_attn import batched_verify_step_block

        return batched_verify_step_block(self.params, toks, pos, active, self._cache, tables,
                                         self.n_heads, self.compute_dtype)[0]

    def _spec_body(self, st, rounds: int, k: int, g: int, sampling: bool, source: str):
        """The spec program's body (the reference's ``spec_pump_impl`` /
        ``paged_spec_pump_impl`` scan, unrolled ``rounds`` times): each
        round propose → verify → accept → emit into the history → budget
        / stop / active update, over the device-carried state, written
        back into its buffers → one packed int32 vector: the emitted
        tokens [B, rounds, k] flattened ‖ accepted proposals ‖ proposal
        columns. The state is holder ``st``'s (the batcher, or one mesh
        shard's slots). Device work only: on CUDA it is captured."""
        tok, pos = st._tok, st._pos
        active, budget, stop = st._active_dev, st._budget_dev, st._stop_dev
        hist = st._hist
        ring = self.windowed
        zero = torch.zeros((), dtype=torch.int32, device=tok.device)
        acc, cols = zero, zero
        emits = []
        for _ in range(rounds):
            if source == "draft" and ring:
                props, dks, dvs = st._draft.propose_windowed(tok, pos, k)
            elif source == "draft":
                props = st._draft.propose(tok, pos, active, k)
            elif source == "ngram":
                props = device_ngram_propose(hist, pos, k, g, wrap=ring)
            else:
                props = torch.full((tok.shape[0], k - 1), -1, dtype=torch.int32,
                                   device=tok.device)
            props = torch.where(active[:, None], props, torch.full_like(props, -1))
            toks = torch.cat([tok[:, None], props], dim=1)
            if ring:
                logits, cks, cvs = batched_windowed_verify(
                    st.params, toks, pos, active, st._cache, self.n_heads,
                    self.compute_dtype)
            else:
                logits = self._verify(st, toks, pos, active)
            m, final = spec_accept(logits, toks, st._temp, st._topk, st._topp,
                                   st._keys, pos, sampling)
            m = torch.where(active, m, torch.zeros_like(m))
            if ring:
                # the certified columns only, the target's and the draft's
                commit_ring_chunk(st._cache, cks, cvs, pos, m, active)
                if source == "draft":
                    st._draft.commit(dks, dvs, pos, m, active)
            emit = spec_emit_hist(toks, m, final, active, hist, pos, ring)
            acc = acc + torch.clamp(m - 1, min=0).sum().to(torch.int32)
            cols = cols + (props >= 0).sum().to(torch.int32)
            budget = budget - m
            hit_stop = ((emit == stop[:, None]) & (stop[:, None] >= 0)).any(dim=1)
            active = active & (budget > 0) & ~hit_stop
            tok = torch.where(m > 0, final, tok)
            pos = pos + m
            emits.append(emit)
        st._tok.copy_(tok)
        st._pos.copy_(pos)
        st._active_dev.copy_(active)
        st._budget_dev.copy_(budget)
        return torch.cat([torch.stack(emits, dim=1).reshape(-1), torch.stack([acc, cols])])

    def _spec_launch_locked(self, plan, rounds: int, k: int, g: int, source: str,
                            eager: bool, t0):
        """Run one spec program over the state ``plan`` (what
        _prepare_locked returned) describes and commit its packed result
        (caller holds _step_lock) → {rid: tokens emitted}."""
        active_np, sampling = plan
        if source != "ngram":
            g = 0  # the miner's width keys only the n-gram programs
        key = ("spec", rounds, k, g, sampling, source)
        outs = self._launch(key, lambda st: self._spec_body(st, rounds, k, g, sampling, source),
                            eager)
        # each holder's packed vector: its slots' emits, then its counts
        acc = sum(int(p[-2]) for p in outs)
        cols = sum(int(p[-1]) for p in outs)
        emits = np.concatenate([p[:-2].reshape(-1, rounds, k) for p in outs], axis=0)
        with self._lock:
            out = self._harvest_locked(active_np, emits, rounds, t0)
            self._n_spec_rounds += rounds
            self._n_spec_accepted += acc
            self._n_spec_columns += cols
        return out

    # -- the client API ----------------------------------------------------------------------
    def spec_step(self, k: int = 4, ngram: int = 2) -> Dict[int, int]:
        """One speculative round (the rounds = 1 spec program): every
        active slot verifies k - 1 proposals in one batched forward and
        commits its accepted prefix plus one correction or bonus token.
        The reference's fallbacks, each counted in ``stats()``: when the
        tightest slot has room for fewer than two columns, a plain step;
        when no slot's n-gram lookup finds anything, a plain step on an
        ``attn_impl="xla"`` batcher and a width-2 verify of sentinels
        (never accepted, so it emits the plain step's token) on a
        ``"pallas"`` one. Returns {rid: last emitted token}; use
        partials() for the whole stream."""
        return self._spec_step(k, ngram, eager=False)

    def spec_step_eager(self, k: int = 4, ngram: int = 2) -> Dict[int, int]:
        """:meth:`spec_step` with the program's body run eagerly, never
        captured: the oracle a replay is held against."""
        return self._spec_step(k, ngram, eager=True)

    def _spec_step(self, k: int, ngram: int, eager: bool) -> Dict[int, int]:
        self._check_failed()
        t0 = _time.perf_counter()
        k = int(k)
        with self._step_lock:
            self._admit()
            with self._lock:
                if not self._active.any():
                    return {}
                if self._paged:
                    # before the active snapshot: may preempt a victim
                    self._ensure_decode_room_locked(k)
                live = [(s, r) for s, r in enumerate(self._slots)
                        if r is not None and self._active[s]]
                # a ring has no end: its only bound is the window
                room = (self.max_len - 1 if self.windowed else
                        min(self.max_len - (r.fill0 + len(r.tokens) - 1) for _, r in live))
                k_round = max(1, min(k, room))
                source = "draft" if self._draft is not None else "ngram"
                if k_round < 2:
                    self._n_spec_fallback_no_room += room < 2
                elif source == "ngram" and not any(
                        _found(ngram_lookup(np.concatenate(
                            [r.prompt, np.asarray(r.tokens, np.int32)]), k_round - 1, ngram))
                        for _, r in live):
                    if self.attn_impl == "pallas":
                        # a Pallas batcher keeps every token of a speculative
                        # generation certified by the verify forward
                        k_round, source = 2, "none"
                        self._n_spec_sentinel_rounds += 1
                    else:
                        k_round = 1
                        self._n_spec_fallback_no_proposal += 1
            if k_round < 2:
                return self._run_locked(1, eager, per_token=True, t0=t0)
            with self._lock:
                plan = self._prepare_locked(0)
            out = self._spec_launch_locked(plan, 1, k_round, int(ngram), source, eager, t0)
            with self._lock:
                self._pump_state_dirty = True  # a host-stepped round, as the reference's
            return {rid: toks[-1] for rid, toks in out.items()}

    def spec_pump(self, rounds: int = 8, k: int = 4, ngram: int = 2) -> Dict[int, List[int]]:
        """``rounds`` whole speculative rounds as one program (a CUDA-graph
        replay on the card) with one read of the host: the emitted tokens
        and the acceptance counts in one packed vector. ``rounds`` is
        clamped so the worst-case verify writes stay inside max_len (from
        the host's own record of each slot's fill) and quantized down to a
        power of two, which bounds the number of programs; when not even
        one round fits, rounds of :meth:`spec_step` finish the tail.
        Slots that spend their budget or emit their stop token idle on the
        device. A windowed batcher needs no room clamp; a windowed batcher
        with a draft runs its rounds as :meth:`spec_step` s, as the
        reference does (its draft is stepped outside the pump).
        Returns {rid: [tokens emitted]}."""
        return self._spec_pump(rounds, k, ngram, eager=False)

    def spec_pump_eager(self, rounds: int = 8, k: int = 4,
                        ngram: int = 2) -> Dict[int, List[int]]:
        """:meth:`spec_pump` with the program's body run eagerly, never
        captured: the oracle a replay is held against."""
        return self._spec_pump(rounds, k, ngram, eager=True)

    def _spec_pump(self, rounds: int, k: int, ngram: int, eager: bool):
        self._check_failed()
        t0 = _time.perf_counter()
        k = max(2, int(k))
        if self._draft is not None and self.windowed:
            return self._spec_fallback_rounds(int(rounds), k, ngram, eager)
        with self._step_lock:
            self._admit()
            with self._lock:
                if not self._active.any():
                    return {}
                r = int(rounds)
                if not self.windowed:
                    pos_max = max(r_.fill0 + len(r_.tokens) - 1
                                  for s, r_ in enumerate(self._slots)
                                  if r_ is not None and self._active[s])
                    r = min(r, (self.max_len - pos_max) // k)
                if r >= 1:
                    # blocks for the clamped rounds, before the floor (the reference's order)
                    plan = self._prepare_locked(r * k)
                    while r & (r - 1):  # the power-of-two floor
                        r &= r - 1
            if r >= 1:
                source = "draft" if self._draft is not None else "ngram"
                return self._spec_launch_locked(plan, r, k, int(ngram), source, eager, t0)
        # no verify room at any width ≥ 2 for a whole round: spec_step's
        # shrinking width finishes the tail
        return self._spec_fallback_rounds(1, k, ngram, eager)

    def _spec_fallback_rounds(self, rounds: int, k: int, ngram: int,
                              eager: bool) -> Dict[int, List[int]]:
        """``rounds`` of :meth:`spec_step` with spec_pump's return contract
        ({rid: every token emitted}), rebuilt from each request's growth;
        request objects are held from the first time each is seen, so a
        request evicted from the result pool meanwhile keeps its tokens."""
        before: Dict[int, int] = {}
        refs = {}
        with self._lock:
            for req in self._slots:
                if req is not None:
                    # token 0 is the prefill's, never pump output
                    before[req.rid] = max(1, len(req.tokens))
        emitted = set()
        for _ in range(int(rounds)):
            with self._lock:
                for req in [r for r in self._slots if r is not None] + [
                        p.req for p in self._pending]:
                    refs.setdefault(req.rid, req)
            em = self._spec_step(k, ngram, eager)
            if not em:
                break
            emitted |= set(em)
            with self._lock:
                for rid in em:
                    if rid not in refs:
                        live = {r.rid: r for r in self._slots if r is not None}
                        req = live.get(rid) or self._done_pool.get(rid)
                        if req is not None:
                            refs[rid] = req
        with self._lock:
            out = {rid: list(req.tokens[before.get(rid, 1):])
                   for rid, req in refs.items() if rid in emitted}
        return {rid: toks for rid, toks in out.items() if toks}

    def _spec_stats_locked(self) -> Dict:
        return {
            "spec_rounds": self._n_spec_rounds,
            "spec_accepted_tokens": self._n_spec_accepted,
            # accepted / columns: the per-proposal acceptance rate whatever
            # the occupancy or k of each round (sentinels count in neither)
            "spec_columns": self._n_spec_columns,
            "spec_acceptance_rate": (self._n_spec_accepted / self._n_spec_columns
                                     if self._n_spec_columns else 0.0),
            "spec_fallback_no_room": self._n_spec_fallback_no_room,
            "spec_fallback_no_proposal": self._n_spec_fallback_no_proposal,
            "spec_sentinel_rounds": self._n_spec_sentinel_rounds,
            "prefixes_registered": len(self._prefixes),
        }


def _found(cand) -> bool:
    return cand is not None and cand.size > 0
