"""Greedy speculative decoding of one stream: a proposer guesses, the target
verifies.

The counterpart of ``nnstreamer_tpu/models/speculative.py``. A draft model
(:func:`speculative_generate`) or an n-gram lookup in the context
(:func:`ngram_speculative_generate`, :func:`ngram_generate_scanned`)
proposes ``k - 1`` tokens; the target scores the pending token and the
proposals in one chunked forward (``decode.verify_chunk``) and keeps the
longest prefix that equals its own greedy choice, plus one corrected token.
The output is the target's greedy stream alone, whatever the proposals
were: rejected K/V past the accepted position are never attended before a
later chunk overwrites them.

The reference jits its draft and verify steps; here they run eagerly, one
read of the host a round (the accepted count).
:func:`ngram_generate_scanned` is the reference's one-program loop with
the n-gram mining and the acceptance on the device
(``serving_spec.device_ngram_propose`` / ``spec_accept``); its loop
condition is read on the host, one int a round, so the zoo's
``decode=ngram`` module is not captured (``CAPTURABLE = False``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nnstreamer_tpu_torch.models import decode as dec
from nnstreamer_tpu_torch.models import transformer as tfm


def _draft_k(model: tfm.TransformerLM, cache, pos: int, tok: torch.Tensor, k: int,
             n_heads: int, compute_dtype: torch.dtype):
    """k greedy draft steps from ``tok`` → (proposals [B, k - 1], cache,
    pos + k). The k-th step's token is dropped; its input (the last
    proposal) gets its K/V written, which full acceptance needs."""
    props = []
    for _ in range(k):
        logits, cache, pos = dec.decode_step(model, tok, pos, cache, n_heads, compute_dtype)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        props.append(tok)
    return torch.stack(props, dim=1)[:, :k - 1], cache, pos


def _verify(model: tfm.TransformerLM, cache, pos: int, chunk: torch.Tensor, n_heads: int,
            compute_dtype: torch.dtype):
    logits, cache, _ = dec.verify_chunk(model, chunk, pos, cache, n_heads,
                                        compute_dtype=compute_dtype)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache  # [B, k]


def _speculative_loop(target: tfm.TransformerLM, prompt, n_heads: int, max_new_tokens: int,
                      k: int, compute_dtype: torch.dtype, propose, on_accept=None,
                      caller: str = "speculative_generate"):
    """The verify / accept / roll-back loop every proposer shares.
    ``propose(cur, context) -> [k - 1]`` gives the candidates;
    ``on_accept(n_acc)`` rolls a stateful proposer forward. → (tokens
    [1, max_new_tokens] int32, accepted proposals per round)."""
    prompt = torch.as_tensor(prompt).to(torch.int32)
    b, t = prompt.shape
    if b != 1:
        raise ValueError(f"{caller} serves one stream (B=1)")
    if k < 2:
        raise ValueError("k must be ≥ 2 (one proposal + one correction)")
    # chunk writes can run past the accepted point by up to k - 1
    max_len = t + max_new_tokens + k
    logits, cache, pos = dec.prefill(target, prompt, n_heads, max_len, compute_dtype)
    cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)  # [1]
    context = prompt[0].cpu().numpy().tolist()
    out, accept_lens = [], []
    while len(out) < max_new_tokens:
        c = int(cur[0])
        out.append(c)  # the pending token is target-certified
        context.append(c)
        if len(out) >= max_new_tokens:
            break
        props = np.asarray(propose(cur, np.asarray(context, np.int32)), np.int32).reshape(-1)
        chunk = torch.cat([cur[:, None], torch.as_tensor(props, device=cur.device)[None, :]],
                          dim=1)
        preds, cache = _verify(target, cache, pos, chunk, n_heads, compute_dtype)
        pn = preds[0].cpu().numpy()
        n_acc = 0
        while n_acc < k - 1 and props[n_acc] == pn[n_acc]:
            n_acc += 1
        accept_lens.append(n_acc)
        out.extend(int(x) for x in props[:n_acc])
        context.extend(int(x) for x in props[:n_acc])
        cur = preds[:, n_acc]  # the target's correction after the prefix
        pos += n_acc + 1
        if on_accept is not None:
            on_accept(n_acc)
    toks = torch.tensor(out[:max_new_tokens], dtype=torch.int32, device=prompt.device)
    return toks[None, :], accept_lens


def speculative_generate(target: tfm.TransformerLM, draft: tfm.TransformerLM, prompt,
                         n_heads: int, max_new_tokens: int,
                         draft_n_heads: Optional[int] = None, k: int = 4,
                         compute_dtype: torch.dtype = torch.float32):
    """prompt [1, T] → (tokens [1, max_new_tokens] int32, accepted
    proposals per round): the target's greedy stream, ``k`` the draft's
    lookahead a round. Both models share the vocabulary."""
    if draft_n_heads is None:
        draft_n_heads = n_heads
    prompt = torch.as_tensor(prompt).to(torch.int32)
    max_len = prompt.shape[1] + max_new_tokens + k
    _, d_cache, d_pos = dec.prefill(draft, prompt, draft_n_heads, max_len, compute_dtype)
    state = {"cache": d_cache, "pos": d_pos}

    def propose(cur, _context):
        props, state["cache"], _ = _draft_k(draft, state["cache"], state["pos"], cur, k,
                                            draft_n_heads, compute_dtype)
        return props[0].cpu().numpy()

    def on_accept(n_acc):
        state["pos"] += n_acc + 1  # the draft rolls back with the target

    return _speculative_loop(target, prompt, n_heads, max_new_tokens, k, compute_dtype,
                             propose, on_accept)


def ngram_lookup(context: np.ndarray, k: int, ngram: int = 1) -> Optional[np.ndarray]:
    """The (up to k) tokens that followed the most recent earlier
    occurrence of the context's final ``ngram`` tokens, or None when that
    tail occurs nowhere earlier."""
    n = context.shape[0]
    if n < ngram + 1:
        return None
    tail = context[n - ngram:]
    # windows over context[:-1] start at 0 .. n-1-ngram: never the tail itself
    windows = np.lib.stride_tricks.sliding_window_view(context[:-1], ngram)
    hits = np.flatnonzero((windows == tail).all(axis=1))
    if not hits.size:
        return None
    return context[hits[-1] + ngram:hits[-1] + ngram + k]


def ngram_propose(context: np.ndarray, k: int, ngram: int = 1) -> np.ndarray:
    """:func:`ngram_lookup` zero-padded to [k]."""
    props = np.zeros((k,), np.int32)
    cand = ngram_lookup(context, k, ngram)
    if cand is not None:
        props[:cand.size] = cand
    return props


def ngram_speculative_generate(target: tfm.TransformerLM, prompt, n_heads: int,
                               max_new_tokens: int, k: int = 4,
                               compute_dtype: torch.dtype = torch.float32):
    """Draft-free speculative decoding: proposals from 1-gram matches in
    the context (:func:`ngram_propose`), verified like a draft's → the
    target's greedy stream, (tokens, accepted proposals per round)."""
    return _speculative_loop(
        target, prompt, n_heads, max_new_tokens, k, compute_dtype,
        lambda cur, context: ngram_propose(context, k - 1),
        caller="ngram_speculative_generate",
    )


def ngram_generate_scanned(target: tfm.TransformerLM, prompt, n_heads: int,
                           max_new_tokens: int, k: int = 4, g: int = 2,
                           compute_dtype: torch.dtype = torch.float32):
    """The reference's one-program n-gram generation: proposals mined on
    the device from a token history (``device_ngram_propose``, B = 1),
    the chunk verify, the greedy acceptance of ``spec_accept``, and the
    emitted tokens kept on the device; the host reads the accepted count
    once a round for the loop's condition. → (tokens [1, max_new_tokens]
    int32, accepted proposals in all)."""
    from nnstreamer_tpu_torch.models.serving_spec import device_ngram_propose, spec_accept

    prompt = torch.as_tensor(prompt).to(torch.int32)
    b, t = prompt.shape
    if b != 1:
        raise ValueError("ngram_generate_scanned serves one stream (B=1)")
    if k < 2:
        raise ValueError("k must be ≥ 2 (one proposal + one correction)")
    n_new = max_new_tokens
    dev = prompt.device
    max_len = t + n_new + k  # the chunks' overshoot
    H = t + n_new + 1
    logits, cache, pos = dec.prefill(target, prompt, n_heads, max_len, compute_dtype)
    cur = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)  # [1]
    hist = torch.full((1, H), -1, dtype=torch.int32, device=dev)
    hist[0, :t] = prompt[0]
    hist[0, t] = cur[0]
    out = torch.zeros((n_new,), dtype=torch.int32, device=dev)
    zf = torch.zeros((1,), dtype=torch.float32, device=dev)
    zi = torch.zeros((1,), dtype=torch.int32, device=dev)
    n_out, acc_total = 0, 0
    cols = torch.arange(k, device=dev)
    while n_out < n_new:
        out[n_out] = cur[0]  # the pending token is target-certified: emitted first
        n_out += 1
        if n_out >= n_new:
            break
        p = torch.full((1,), pos, dtype=torch.int32, device=dev)
        props = device_ngram_propose(hist, p, k, g)  # [1, k - 1]
        chunk = torch.cat([cur[:, None], props], dim=1)
        vlogits, cache, _ = dec.verify_chunk(target, chunk, pos, cache, n_heads,
                                             compute_dtype=compute_dtype)
        m, final = spec_accept(vlogits, chunk, zf, zi, zf + 1.0,
                               torch.zeros((1,), dtype=torch.int64, device=dev), p, False)
        n_acc = int(m[0]) - 1  # the round's one read of the host
        take = min(n_acc, n_new - n_out)
        out[n_out:n_out + take] = props[0, :take]
        # the history takes the accepted prefix and the next pending token
        hrow = torch.cat([props[0], zi])
        hrow = torch.where(cols == n_acc, final[0], hrow)
        keep = min(n_acc + 1, H - (pos + 1))
        hist[0, pos + 1:pos + 1 + keep] = hrow[:keep]
        cur = final
        pos += n_acc + 1
        n_out += n_acc
        acc_total += n_acc
    return out[None, :], acc_total
