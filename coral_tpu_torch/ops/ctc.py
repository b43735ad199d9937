"""Connectionist Temporal Classification loss with the alpha/beta recursion kernels.

Port of ``coral_tpu/ops/ctc.py`` ``ctc_loss`` (:354) with its ``custom_vjp``
(``_ctc_fwd`` :306, ``_ctc_bwd`` :315-348) and of the recursions of
``coral_tpu/ops/ctc_pallas.py`` (``_alpha_kernel`` :81, ``_beta_kernel``
:125), which the JAX package runs on its accelerator. On a CUDA tensor
``ctc_alpha`` and ``ctc_beta`` launch ``csrc/ctc.cu``; on a CPU tensor they run
the plain versions beside them (a Python loop over time); ``plain=True`` runs
the plain versions on any device.

Semantics are torch's ``ctc_loss``, as the JAX package's: per-sample
``-log p(y|x)``, reductions none/sum/mean (mean divides by the target length
first), ``zero_infinity`` (infeasible rows and their gradients are zero), -100
label padding. -inf is the finite -1e30 with ``_log_add``'s clamp, so the
recursions stay NaN-free and an infeasible row is found by ``-logp >= 5e29``.
The gradient's scatter into the vocabulary (the one-hot einsum of ``_ctc_bwd``)
is ``scatter_add_``; the emissions are a gather.
"""

from __future__ import annotations

import torch

from . import _build

NEG_INF = -1e30


def _log_add(a, b):
    """``log(exp(a) + exp(b))`` with the -1e30 floor (``ctc_pallas._log_add``)."""
    mx_safe = torch.clamp(torch.maximum(a, b), min=NEG_INF)
    return mx_safe + torch.log1p(torch.exp(torch.minimum(a, b) - mx_safe))


def _extended_labels(labels, blank_id: int):
    """labels (B, L) -> (B, 2L+1) with blanks interleaved: ext[2i+1] = labels[i]."""
    B, L = labels.shape
    ext = torch.full((B, 2 * L + 1), blank_id, dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    return ext


def _emissions(log_probs, ext):
    """emit[t, b, s] = log_probs[t, b, ext[b, s]]."""
    T = log_probs.shape[0]
    return torch.gather(log_probs, 2, ext[None].expand(T, -1, -1))


def _state_masks(ext, label_lengths, blank_id: int):
    """(skip s-2 -> s, skip s -> s+2, valid state, terminal state), each (B, S) bool."""
    B, S = ext.shape
    pad = torch.full((B, 2), -1, dtype=ext.dtype, device=ext.device)
    prev2 = torch.cat([pad, ext[:, :-2]], dim=1)
    next2 = torch.cat([ext[:, 2:], pad], dim=1)
    not_blank = ext != blank_id
    pos = torch.arange(S, device=ext.device)[None, :]
    valid = pos < (2 * label_lengths[:, None] + 1)
    last = 2 * label_lengths[:, None]
    terminal = (pos == last) | ((pos == last - 1) & (label_lengths[:, None] > 0))
    return not_blank & (ext != prev2), not_blank & (ext != next2), valid, terminal


def _shift(x, k):
    """x shifted toward higher s by k (k < 0: lower s), filled with NEG_INF."""
    fill = torch.full((x.shape[0], abs(k)), NEG_INF, dtype=x.dtype, device=x.device)
    return torch.cat([fill, x[:, :-k]], 1) if k > 0 else torch.cat([x[:, -k:], fill], 1)


def ctc_alpha_plain(emit, skip, valid, lengths):
    """``_alpha_kernel`` in plain ops: alphas (T, B, S) fp32."""
    T, B, S = emit.shape
    pos = torch.arange(S, device=emit.device)[None, :]
    state = torch.where(valid & (pos <= 1), emit[0], NEG_INF)
    out = [state]
    for t in range(1, T):
        summed = _log_add(state, _shift(state, 1))
        summed = torch.where(skip, _log_add(summed, _shift(state, 2)), summed)
        new = torch.where(valid, summed + emit[t], NEG_INF)
        state = torch.where((t < lengths)[:, None], new, state)
        out.append(state)
    return torch.stack(out)


def ctc_beta_plain(emit, skip_fwd, valid, lengths, terminal):
    """``_beta_kernel`` in plain ops: betas (T, B, S) fp32, the emission at t
    included."""
    T, B, S = emit.shape
    state = torch.full((B, S), NEG_INF, dtype=emit.dtype, device=emit.device)
    out = [state] * T
    for t in range(T - 1, -1, -1):
        summed = _log_add(state, _shift(state, -1))
        summed = torch.where(skip_fwd, _log_add(summed, _shift(state, -2)), summed)
        new = summed + emit[t]
        new = torch.where((t == lengths - 1)[:, None],
                          torch.where(terminal, emit[t], NEG_INF), new)
        new = torch.where(valid, new, NEG_INF)
        state = torch.where((t <= lengths - 1)[:, None], new, state)
        out[t] = state
    return torch.stack(out)


def _launch(name, kernel, emit, masks, lengths):
    T, B, S = emit.shape
    _build.check_cuda(name, torch.float32, emit)
    masks = [m.to(torch.uint8).contiguous() for m in masks]
    lengths = lengths.to(torch.int32).contiguous()
    for m in masks:
        if m.shape != (B, S) or m.device != emit.device:
            raise ValueError(f"{name}: masks must be ({B}, {S}) on {emit.device}")
    if lengths.shape != (B,) or lengths.device != emit.device:
        raise ValueError(f"{name}: lengths must be ({B},) on {emit.device}")
    if 2 * S * 4 > 48 * 1024:
        raise ValueError(f"{name}: the kernel takes S <= 6144 states, got {S}")
    out = torch.empty_like(emit)
    ptrs = [m.data_ptr() for m in masks]
    if kernel == "ctc_alpha":
        args = (emit.data_ptr(), *ptrs, lengths.data_ptr(), out.data_ptr())
    else:
        skip, valid, terminal = ptrs
        args = (emit.data_ptr(), skip, valid, lengths.data_ptr(), terminal, out.data_ptr())
    _build.launch(name, kernel, *args, T, B, S)
    return out


def ctc_alpha(emit, skip, valid, lengths):
    """The alpha recursion: emit (T, B, S) fp32, skip/valid (B, S) bool,
    lengths (B,) -> alphas (T, B, S) fp32, frozen past each row's length."""
    if not _build.require_cuda("coral_ctc_alpha", emit):
        return ctc_alpha_plain(emit, skip, valid, lengths)
    return _launch("coral_ctc_alpha", "ctc_alpha", emit.contiguous(), (skip, valid), lengths)


def ctc_beta(emit, skip_fwd, valid, lengths, terminal):
    """The beta recursion: as ``ctc_alpha`` plus the terminal-state mask."""
    if not _build.require_cuda("coral_ctc_beta", emit):
        return ctc_beta_plain(emit, skip_fwd, valid, lengths, terminal)
    return _launch("coral_ctc_beta", "ctc_beta", emit.contiguous(),
                   (skip_fwd, valid, terminal), lengths)


class _CTC(torch.autograd.Function):
    """``_ctc_neg_log_likelihood``: -log p(y|x) per row; the backward runs the
    beta recursion and scatters the state occupancies into the vocabulary."""

    @staticmethod
    def forward(ctx, log_probs, ext, input_lengths, label_lengths, blank_id, plain):
        skip, skip_fwd, valid, terminal = _state_masks(ext, label_lengths, blank_id)
        emit = _emissions(log_probs, ext).float().contiguous()
        alphas = (ctc_alpha_plain if plain else ctc_alpha)(emit, skip, valid, input_lengths)
        final = alphas[-1]
        last = 2 * label_lengths[:, None]
        a_last = torch.gather(final, 1, last)[:, 0]
        a_prev = torch.where(label_lengths > 0,
                             torch.gather(final, 1, torch.clamp(last - 1, min=0))[:, 0],
                             NEG_INF)
        logp = _log_add(a_last, a_prev)
        ctx.save_for_backward(emit, ext, input_lengths, alphas, logp, skip_fwd, valid,
                              terminal)
        ctx.vocab, ctx.plain, ctx.dtype = log_probs.shape[-1], plain, log_probs.dtype
        return -logp

    @staticmethod
    def backward(ctx, g):
        emit, ext, input_lengths, alphas, logp, skip_fwd, valid, terminal = ctx.saved_tensors
        beta = ctc_beta_plain if ctx.plain else ctc_beta
        betas = beta(emit, skip_fwd, valid, input_lengths, terminal)
        T, B, S = emit.shape
        w = torch.exp(torch.clamp(alphas + betas - emit - logp[None, :, None], max=0.0))
        t_mask = torch.arange(T, device=emit.device)[:, None] < input_lengths[None, :]
        finite = (-logp) < -NEG_INF / 2
        w = w * (t_mask & finite[None, :])[..., None]
        grad = torch.zeros((T, B, ctx.vocab), dtype=w.dtype, device=w.device)
        grad.scatter_add_(2, ext[None].expand(T, -1, -1), -w)
        return (grad * g[None, :, None]).to(ctx.dtype), None, None, None, None, None


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank_id: int = 0,
             reduction: str = "sum", zero_infinity: bool = True, plain: bool = False):
    """CTC loss with torch-compatible semantics.

    Args:
        log_probs: (T, B, V) log-softmax over the vocabulary per frame.
        labels: (B, L) label ids, padded arbitrarily past ``label_lengths``
            (-100 is accepted).
        input_lengths: (B,) valid frames per row.
        label_lengths: (B,) valid labels per row.
        blank_id: the CTC blank (the pad token for wav2vec2).
        reduction: "none" | "sum" | "mean".
        zero_infinity: zero infinite losses (infeasible alignments) and their
            gradients.
        plain: run the plain recursions on any device.

    Returns:
        () for sum/mean, (B,) for "none".
    """
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"Unknown reduction: {reduction!r}")
    labels = torch.where(labels < 0, 0, labels).long()
    ext = _extended_labels(labels, blank_id)
    label_lengths = label_lengths.long()
    per_sample = _CTC.apply(log_probs, ext, input_lengths.long(), label_lengths, blank_id,
                            plain)
    if zero_infinity:
        per_sample = torch.where(per_sample < -NEG_INF / 2, per_sample, 0.0)
    if reduction == "none":
        return per_sample
    if reduction == "sum":
        return per_sample.sum()
    return (per_sample / torch.clamp(label_lengths, min=1).to(per_sample.dtype)).mean()
