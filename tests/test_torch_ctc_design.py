"""K6's Hopper design, walked in plain PyTorch on the CPU.

``csrc/ctc.cu`` runs the CTC alpha and beta recursions in one block a batch
row, which only a card runs. ``_walk`` below does what a block does, in its
order:

- the emissions come in rows of S rounded up to 4 floats (``ops/ctc.py``
  ``_emissions``: a gather at label 0 fills the padding, which is never read
  as a state); a bulk copy brings a time step's row of the batch row;
- a two-stage ring of time chunks (up to 64 steps, fewer where a row of
  states is wide): chunks 0 and 1 are copied before the time loop, and chunk
  k + 1 during chunk k (at its step 8, or its last), into the stage chunk
  k - 1 left; beta's chunks run from the row's last frame down;
- warps of 32 lanes, R consecutive states a lane (1 up to S = 1024, then
  2, 4, 6), the state in registers: a state's s-1 and s-2 (beta's s+1 and
  s+2) come from the lane's own registers, from its neighbour lane (the
  shuffle), and at the warp's edge from the neighbouring warp's two edge
  values, written into a double-buffered slot the step before (slot 0, or
  beta's last slot, -inf); the masks and terminal bits are read once, states
  at or past S invalid;
- each lane writes its new states over the emissions it read; at a chunk's
  end the stage's rows are copied out to rows of the same width;
- only the steps a row needs run: alpha's t = 0 .. len - 1 (t = 0 always),
  then its frozen state; beta's t = len - 1 .. 0, -inf above.

The walk is held against the JAX package's own recursions
(``coral_tpu.ops.ctc_pallas.alpha_recursion`` / ``beta_recursion`` with
``interpret=True``, as its tests run them on the CPU) at atol 1e-3 and rtol
1e-5, the card tests' tolerance (fp32 log-probs of order 100 summed in the
same order; XLA's exp and log1p against torch's), and against the port's
plain versions (``ctc_alpha_plain``, ``ctc_beta_plain``) bit for bit: the
walk applies their elementwise arithmetic to the same values in the same
order. The kernel differs from the walk only in its exp and log (the card's
approximations), which the card tests in ``tests/test_torch_kernels.py``
hold to the same tolerance.

Cases: S = 1 (no labels), 3, 31, 33, 257 and 1,025 states, T not a
multiple of the chunk, rows of length 1, of T and under one chunk, and an
infeasible row (more labels than frames).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coral_tpu.ops import ctc_pallas
from coral_tpu_torch.ops import ctc

# One intra-op thread: the suite runs in several processes at once.
torch.set_num_threads(1)

NEG = ctc.NEG_INF
STAGES = 2
STAGE_BYTES = 96 * 1024
MAX_CHUNK = 64
REFILL_STEP = 8


def states_per_lane(S):
    return 1 if S <= 1024 else 2 if S <= 2048 else 4 if S <= 4096 else 6


def _layout(S, R=None, chunk=None):
    """(R, warps, pitch, chunk): the kernel's launch arithmetic."""
    R = R or states_per_lane(S)
    warps = -(-S // (32 * R))
    pitch = warps * 32 * R
    return R, warps, pitch, chunk or min(MAX_CHUNK, STAGE_BYTES // (pitch * 4))


def _walk(emit, skip, valid, lengths, last=None, R=None, chunk=None):
    """The block of each batch row, walked: emit a (T, B, S) view of rows of
    ld floats (``_emissions``); returns (T, B, S) and the rows the copies out
    wrote, (T, B, ld) (with the padding the stage held)."""
    beta = last is not None
    T, B, S = emit.shape
    ld = emit.stride(1)
    rows = emit.as_strided((T, B, ld), (B * ld, ld, 1))  # what a bulk copy reads
    Sc = -(-S // 4) * 4
    R, warps, pitch, chunk = _layout(S, R, chunk)
    out = torch.full((T, B, ld), float("nan"))
    for b in range(B):
        ok, skp, term = (torch.zeros(pitch, dtype=torch.bool) for _ in range(3))
        ok[:S], skp[:S] = valid[b], skip[b]
        if beta:
            term[:S] = last[b]
        n = max(0, min(int(lengths[b]), T)) if beta else max(1, min(int(lengths[b]), T))
        n_chunks = -(-n // chunk)

        def row(i):
            return n - 1 - i if beta else i

        ring = torch.zeros(STAGES, chunk, pitch)
        tag = torch.full((STAGES, chunk), -1)  # the time step a stage row holds

        def issue(k):
            steps = min(chunk, n - k * chunk)
            for j in range(steps):
                t = row(k * chunk + j)
                ring[k % STAGES, j, :Sc] = rows[t, b, :Sc]
                tag[k % STAGES, j] = t

        for k in range(min(STAGES, n_chunks)):
            issue(k)
        st = torch.full((warps, 32, R), NEG)
        edge = torch.full((2, warps + 1, 2), NEG)  # (buffer, slot, the two edge values)
        for k in range(n_chunks):
            steps = min(chunk, n - k * chunk)
            for j in range(steps):
                i, t = k * chunk + j, row(k * chunk + j)
                if k > 0 and k + 1 < n_chunks and j == min(REFILL_STEP, steps - 1):
                    issue(k + 1)
                assert tag[k % STAGES, j] == t  # the stage holds this step's row
                e = ring[k % STAGES, j].view(warps, 32, R)
                inn = edge[i & 1]
                if not beta and i == 0:
                    s_idx = torch.arange(pitch).view(warps, 32, R)
                    nx = torch.where(ok.view(warps, 32, R) & (s_idx <= 1), e, NEG)
                else:
                    nx = _step(st, e, inn, ok, skp, term, beta, t == int(lengths[b]) - 1)
                st = nx
                flat = st.reshape(warps, 32 * R)
                if beta:  # warp w's first two states into slot w
                    edge[(i + 1) & 1, :warps] = flat[:, :2]
                else:  # its last two into slot w + 1
                    edge[(i + 1) & 1, 1:] = flat[:, -2:]
                ring[k % STAGES, j] = st.reshape(-1)  # over the emissions just read
            for j in range(steps):  # the chunk's rows copied out
                out[row(k * chunk + j), b, :Sc] = ring[k % STAGES, j, :Sc]
        for t in range(n, T):
            out[t, b, :S] = NEG if beta else st.reshape(-1)[:S]
    return out[..., :S], out


def _step(st, e, inn, ok, skp, term, beta, at_last):
    """One step of a block: each state's two neighbours from the lane's own
    registers, the neighbour lane's (shuffles) and the neighbouring warp's
    edge slot, then the log-adds."""
    warps, _, R = st.shape
    ok, skp, term = (m.view(warps, 32, R) for m in (ok, skp, term))
    if not beta:
        # Lane l's first state: s-1 is lane l-1's last, s-2 its second-to-last
        # (lane l-2's state where R = 1); lane 0 (and 1) read the warp below's
        # edge slot (x: its second-to-last state, y: its last).
        lo1 = torch.cat([inn[:warps, 1:2], st[:, :-1, R - 1]], dim=1)
        if R == 1:
            lo2 = torch.cat([inn[:warps, 0:1], inn[:warps, 1:2], st[:, :-2, 0]], dim=1)
        else:
            lo2 = torch.cat([inn[:warps, 0:1], st[:, :-1, R - 2]], dim=1)
        p1 = torch.cat([lo1[..., None], st[..., :-1]], dim=2)
        p2 = torch.cat([lo2[..., None], lo1[..., None], st[..., :-2]], dim=2)[..., :R]
    else:
        # Lane l's last state: s+1 is lane l+1's first, s+2 its second (lane
        # l+2's state where R = 1); lane 31 (and 30) read the warp above's
        # slot (x: its first state, y: its second).
        hi1 = torch.cat([st[:, 1:, 0], inn[1:, 0:1]], dim=1)
        if R == 1:
            hi2 = torch.cat([st[:, 2:, 0], inn[1:, 0:1], inn[1:, 1:2]], dim=1)
        else:
            hi2 = torch.cat([st[:, 1:, 1], inn[1:, 1:2]], dim=1)
        p1 = torch.cat([st[..., 1:], hi1[..., None]], dim=2)
        p2 = torch.cat([st[..., 2:], hi1[..., None], hi2[..., None]], dim=2)[..., -R:]
    summed = ctc._log_add(st, p1)
    summed = torch.where(skp, ctc._log_add(summed, p2), summed)
    new = summed + e
    if beta and at_last:
        new = torch.where(term, e, NEG)
    return torch.where(ok, new, NEG)


def _case(T, B, L, V=12, seed=0):
    """log-probs (T, B, V) from numpy, labels with repeats, the lengths: T, 1,
    under one chunk, and an infeasible row (at L > 0), then the masks and the
    ``_emissions`` view."""
    rng = np.random.default_rng(seed)
    log_probs = torch.log_softmax(torch.from_numpy(
        rng.standard_normal((T, B, V)).astype(np.float32) * 3), dim=-1)
    labels = rng.integers(1, V, size=(B, L))
    if L > 1:
        labels[:, 1] = labels[:, 0]  # a repeated label: no skip into it
    labels = torch.from_numpy(labels)
    in_len = torch.tensor([T, 1, 5, max(1, L // 2)][:B])
    lab_len = torch.tensor([L, 0, min(L, 2), L][:B])
    ext = ctc._extended_labels(labels, 0)
    skip, skip_fwd, valid, terminal = ctc._state_masks(ext, lab_len, 0)
    return ctc._emissions(log_probs, ext), skip, skip_fwd, valid, terminal, in_len


def _jax(emit, skip, valid, lengths, last=None):
    f32 = np.float32
    args = [jnp.asarray(emit.contiguous().numpy()), jnp.asarray(skip.numpy().astype(f32)),
            jnp.asarray(valid.numpy().astype(f32)), jnp.asarray(lengths.numpy().astype(np.int32))]
    if last is None:
        return np.asarray(ctc_pallas.alpha_recursion(*args, interpret=True))
    return np.asarray(ctc_pallas.beta_recursion(*args, jnp.asarray(last.numpy().astype(f32)),
                                                interpret=True))


# (T, L): S = 2 L + 1 = 1, 3, 31, 33, 257, 1025; T not a multiple of the
# chunk (64 steps; 22 at 1025 states, whose ring rows are 1088 floats).
CASES = [(37, 0), (37, 1), (70, 15), (70, 16), (70, 128), (53, 512)]


@pytest.mark.parametrize("T,L", CASES)
def test_walk_matches_the_jax_recursions_and_the_plain_versions(T, L):
    """Alpha and beta, walked at the kernel's own layout, against JAX's
    Pallas recursions in interpret mode (atol 1e-3, rtol 1e-5) and the plain
    versions (bit for bit)."""
    emit, skip, skip_fwd, valid, terminal, in_len = _case(T, 4, L, seed=T + L)
    assert emit.stride(1) % 4 == 0 and emit.stride(1) >= emit.shape[-1]
    alpha, _ = _walk(emit, skip, valid, in_len)
    beta, _ = _walk(emit, skip_fwd, valid, in_len, terminal)
    assert torch.equal(alpha, ctc.ctc_alpha_plain(emit, skip, valid, in_len))
    assert torch.equal(beta, ctc.ctc_beta_plain(emit, skip_fwd, valid, in_len, terminal))
    np.testing.assert_allclose(alpha.numpy(), _jax(emit, skip, valid, in_len), atol=1e-3,
                               rtol=1e-5)
    np.testing.assert_allclose(beta.numpy(), _jax(emit, skip_fwd, valid, in_len, terminal),
                               atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("R", [1, 2, 4, 6])
@pytest.mark.parametrize("chunk", [None, 8])
def test_walk_at_every_states_a_lane_and_short_chunks(R, chunk):
    """257 states at R = 1, 2, 4 and 6 a lane (9, 5, 3 and 2 warps), with the
    kernel's chunk and with 8-step chunks (70 steps: 9 chunks, the last of 6,
    the ring refilled in every one): bit for bit the plain versions."""
    emit, skip, skip_fwd, valid, terminal, in_len = _case(70, 4, 128, seed=R)
    alpha, _ = _walk(emit, skip, valid, in_len, R=R, chunk=chunk)
    beta, _ = _walk(emit, skip_fwd, valid, in_len, terminal, R=R, chunk=chunk)
    assert torch.equal(alpha, ctc.ctc_alpha_plain(emit, skip, valid, in_len))
    assert torch.equal(beta, ctc.ctc_beta_plain(emit, skip_fwd, valid, in_len, terminal))


def test_layout_and_the_rows_the_copies_write():
    """The launch arithmetic (states a lane, warps, the ring's row pitch and
    chunk) at the cases' widths and the 6,144 limit; the copies out write
    whole 16-byte rows, S rounded up to 4, the states past S as -inf."""
    assert [_layout(S)[:3] for S in (1, 3, 31, 33, 257, 1025, 2049, 6144)] == [
        (1, 1, 32), (1, 1, 32), (1, 1, 32), (1, 2, 64), (1, 9, 288), (2, 17, 1088),
        (4, 17, 2176), (6, 32, 6144)]
    assert [_layout(S)[3] for S in (257, 1025, 6144)] == [64, 22, 4]
    emit, skip, _, valid, _, in_len = _case(37, 4, 15, seed=3)  # S 31: rows of 32
    _, rows = _walk(emit, skip, valid, in_len)
    assert rows.shape[-1] == 32
    ran = rows[:, 0]  # row 0 runs every step
    assert torch.equal(ran[:, 31], torch.full((37,), NEG))
