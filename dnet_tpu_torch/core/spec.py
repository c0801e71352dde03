"""Prompt-lookup speculative decoding: the draft, the acceptance and the
history buffer.

Counterpart of dnet_tpu/core/spec.py.  Each verify block feeds the
committed token plus L drafted ones through ONE forward of L+1 positions,
so every weight read serves up to L+1 emitted tokens; position i's greedy
argmax must equal draft i+1 for the draft to extend the accepted prefix,
which keeps the stream exactly the plain greedy one.

Drafting is n-gram prompt lookup: the session's own committed tokens
(prompt + generated, kept on the device in `hist`) are searched for the
latest earlier occurrence of the trailing `ngram` tokens, and what
followed it becomes the draft.  `ngram_draft` runs as torch ops on the
device, per lane at the lane's own position, so a draft needs no host
read; `ngram_draft_np` is the host-side single-lane twin.

KV rewind: every one of the L+1 positions writes its K/V row; rows past
the accepted count are left stale, never attended (causal limits at the
rewound position) and overwritten when decode reaches their slot.  A
rotating ring cache breaks that (a wrap-around write evicts live rows), so
engines speculate only on slot-addressed caches (`kv_rewindable`).

Where the reference returns updated copies, `commit_history` writes the
buffer in place.  Out-of-range starts clamp as JAX's dynamic slices clamp
them (a negative start counting from the end), so drafts equal the
reference's bit for bit.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

Pos = Union[int, torch.Tensor]


def _lane_pos(pos: Pos, B: int, device) -> torch.Tensor:
    """pos as int64 [B] on `device` (a scalar applies to every lane)."""
    return torch.as_tensor(pos, device=device).long().reshape(-1).expand(B)


def _window(hist: torch.Tensor, start: torch.Tensor, size: int) -> torch.Tensor:
    """hist[b, start_b : start_b + size] per lane, as a dynamic slice takes
    it: a negative start counts from the end, then the start is clamped
    into [0, S - size].  [B, size]."""
    S = hist.shape[1]
    s = torch.where(start < 0, start + S, start).clamp(0, S - size)
    return hist.gather(1, s[:, None] + torch.arange(size, device=hist.device))


def ngram_draft(hist: torch.Tensor, pos: Pos, lookahead: int, ngram: int = 2) -> torch.Tensor:
    """Draft `lookahead` tokens per lane by matching the trailing `ngram`.

    hist [B, S] committed token ids, valid in [0, pos) (pos: an int or one
    position a lane, [B]).  Finds the latest j with j + ngram <= pos - ngram
    and hist[:, j:j+ngram] == hist[:, pos-ngram:pos] and proposes
    hist[:, j+ngram : j+ngram+lookahead]; no match repeats the last
    committed token.  Windows are compared over the whole buffer under a
    validity mask, as in the reference."""
    B, S = hist.shape
    dev = hist.device
    p = _lane_pos(pos, B, dev)
    key = _window(hist, p - ngram, ngram)  # [B, n]
    idx = torch.arange(S, device=dev)
    match = torch.ones((B, S), dtype=torch.bool, device=dev)
    for k in range(ngram):
        match &= torch.roll(hist, -k, dims=1) == key[:, k : k + 1]  # hist[:, j+k] at column j
    match &= (idx[None, :] + ngram) <= (p[:, None] - ngram)  # complete windows before the key
    score = torch.where(match, idx[None, :] + 1, 0)  # the latest match wins
    best, j = score.max(dim=1)
    found = best > 0
    cont = _window(hist, torch.where(found, j + ngram, 0), lookahead)
    last = _window(hist, p - 1, 1)  # [B, 1]
    return torch.where(found[:, None], cont, last.expand(B, lookahead))


def ngram_draft_np(hist, pos: int, lookahead: int, ngram: int = 2) -> np.ndarray:
    """Host-side single-lane prompt-lookup draft (numpy), the same rule as
    `ngram_draft`: the latest earlier occurrence of the trailing `ngram`
    (candidate windows end at or before the key starts), what followed it,
    padded with the last token; no match repeats the last token."""
    hist = np.asarray(hist)
    if pos < ngram + 1:
        return np.full(lookahead, int(hist[max(pos - 1, 0)]), dtype=np.int64)
    key = hist[pos - ngram : pos]
    best = -1
    for j in range(pos - 2 * ngram, -1, -1):  # latest match wins
        if np.array_equal(hist[j : j + ngram], key):
            best = j
            break
    if best < 0:
        return np.full(lookahead, int(hist[pos - 1]), dtype=np.int64)
    start = best + ngram
    cont = hist[start : start + lookahead]
    if len(cont) < lookahead:
        cont = np.concatenate([cont, np.full(lookahead - len(cont), int(hist[pos - 1]))])
    return cont.astype(np.int64)


def accept_drafts(preds: torch.Tensor, drafts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy acceptance.  preds [B, L+1]: the argmax at each verified
    position; drafts [B, L].  Returns (n_accept [B], out [B, L+1]):
    positions 0..n_accept of preds are emitted (the accepted drafts plus
    the first disagreeing or bonus prediction), -1 past them."""
    L = drafts.shape[1]
    agree = (preds[:, :L] == drafts).long()
    n_accept = agree.cumprod(dim=1).sum(dim=1)  # leading agreements
    emit = torch.arange(L + 1, device=preds.device)[None, :] <= n_accept[:, None]
    return n_accept, torch.where(emit, preds, torch.full_like(preds, -1))


def commit_history(hist: torch.Tensor, pos: Pos, tokens: torch.Tensor, n_valid: int = 0) -> torch.Tensor:
    """Write the whole token block `tokens` [B, W] at hist[:, pos:] IN
    PLACE (pos: an int or one position a lane), -1 sentinels as 0; columns
    past the n_valid real ones hold stale ids that the next write
    overwrites, since pos only advances by what was emitted.  The start
    clamps at the buffer's end as a dynamic update clamps it.  Returns
    hist."""
    B, W = tokens.shape
    S = hist.shape[1]
    start = _lane_pos(pos, B, hist.device).clamp(0, S - W)
    cols = start[:, None] + torch.arange(W, device=hist.device)
    hist.scatter_(1, cols, tokens.clamp(min=0).to(hist.dtype))
    return hist


def make_spec_step(model, window_pass: Callable, L: int) -> Callable:
    """The verify block's body, shared by every engine that speculates by
    prompt lookup (they differ only in how the window pass runs): commit
    the fed token, draft L tokens, verify [tok, d_1..d_L] in one (L+1)-wide
    forward through `window_pass(x, kv, pos, t_real)` (which writes kv in
    place) and return (accept_drafts' sentinel-packed out [B, L+1], hist)."""

    def spec_step(edge_params: dict, tok: torch.Tensor, hist: torch.Tensor, kv, pos: int):
        commit_history(hist, pos, tok, 1)
        drafts = ngram_draft(hist, pos + 1, L)  # [B, L]
        commit_history(hist, pos + 1, drafts, L)
        block = torch.cat([tok.to(drafts.dtype), drafts], dim=1)  # [B, L+1]
        x = window_pass(model.embed(edge_params, block.long()), kv, pos, L + 1)
        logits = model.lm_project(edge_params, model.normalize(edge_params, x))  # [B, L+1, V]
        preds = logits.argmax(dim=-1).to(drafts.dtype)
        _, out = accept_drafts(preds, drafts)
        return out, hist

    return spec_step
