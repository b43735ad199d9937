"""The FFN's fused up-projection kernels: the pre-LN block and fc1 alone.

Port of ``coral_tpu/ops/ffn_pallas.py`` at every width of the repository's
configs (``KERNEL_D``: Whisper tiny, base and small's 384, 512 and 768,
XLS-R-300M's 1024, Whisper large-v3's and XLS-R-1B's 1280, XLS-R-2B's 1920);
other widths raise on the card (ROADMAP.md Queue 2 item 3). Four
differentiable entry points, each a ``torch.autograd.Function`` whose
residuals are its primal inputs and the seeds, as the JAX custom VJPs':

- ``ffn_ln_block``: ``dropout(gelu(layer_norm(x) @ W1^T + b1)) @ W2^T + b2``,
  in the variant its flags select (``block_variant``, the JAX precedence of
  ``ffn_pallas.py:2139-2147``). By default ``dg_in_kernel=True``
  (``_ffn_ln_block_dg``, :1742-1789): the forward writes ``g`` in
  ``csrc/ffn.cu`` (``_fwd_kernel_ln[_drop]``) and fc2 runs as
  ``torch.matmul``, which the JAX package also leaves outside its kernel
  (``_fc2``); the backward (``_bwd_kernel_ln_g_dg[_drop]``) recomputes h,
  forms ``dg = dy @ W2^T`` in the kernel, writes g (the dW2 operand), dh and
  ln_out (the dW1 operand), computes ``dl = dh @ W1`` in a second kernel and
  passes dl through the LayerNorm backward of ``csrc/ln_gelu.cu``. With
  ``dg_in_kernel=False`` (``_ffn_ln_block``) dg is a product outside and N5
  (``csrc/ffn_ln_g.cu``, ``_bwd_kernel_ln_g[_drop]``) reads it; with
  ``fc2_in_kernel`` the forward is N7 (``csrc/ffn_ln_fc2.cu``,
  ``_fwd_kernel_ln_fc2[_drop]``: LayerNorm, fc1, GELU, dropout and fc2 in
  one kernel) and the backward N5's; with ``dw_in_kernel`` the backward is
  N6 (``csrc/ffn_ln_g.cu``, ``_bwd_kernel_ln_dw``: N5's pass, then a kernel
  for dW1 and dW2).
- ``ffn_block``: the same without the LayerNorm (``_ffn_block``,
  :1864-1905): the forward ``csrc/ffn_fc1.cu`` (``_fwd_kernel[_drop]``),
  fc2 outside; the backward forms ``dg = dy @ W2^T`` outside, rounded to the
  working dtype as JAX's ``.astype(dy.dtype)``, and ``csrc/ffn_fc1.cu``
  (``_bwd_kernel_g[_drop]``) writes dh, g and dx = dh @ W1.
- ``ffn_ln_fc1``: ``dropout(gelu(layer_norm(x) @ W1^T + b1))`` alone
  (``_ffn_ln_fc1``, :1604-1642): the forward is the block's, the backward
  ``csrc/ffn_ln_fc1.cu`` (``_bwd_kernel_ln[_drop]``: dh, ln_out, dl) and the
  LayerNorm backward.
- ``ffn_fc1``: ``dropout(gelu(x @ W1^T + b1))`` (``_ffn_fc1``,
  :1645-1674): ``csrc/ffn_fc1.cu`` both ways (``_fwd_kernel[_drop]``,
  ``_bwd_kernel[_drop]``: dh and dx = dh @ W1).
- ``ln_dense``: ``bf16(layer_norm(x)) @ W^T + b`` with no activation, the
  pre-attention LayerNorm folded into the packed (3D, D) QKV projection
  (``fused_qkv_ln``; ``ln_dense`` :1972-2015 and its ``custom_vjp``
  ``_ln_dense`` :1575-1601): ``csrc/ln_dense.cu`` both ways
  (``_fwd_kernel_lnmm``; ``_bwd_kernel_lnmm``: ln_out, db's row partials, dl =
  dy W, then the LayerNorm backward), dW = ``dy^T ln_out`` outside, as the JAX
  backward leaves it. At D or F not a multiple of 128 it takes the JAX
  function's other route, the LayerNorm and the product as plain ops under
  autograd (no kernel there in either package).

dW1, dW2 (but in N6), db2 and the sums of the kernels' row partials stay
outside as products and sums, as in the JAX backward functions. On a CPU
tensor the plain versions beside the kernels run, with the kernels'
roundings: h in fp32, g rounded to x's dtype, dh rounded to x's dtype before
its product with W1 and summed unrounded into db1, as the TPU kernels do
(``_bwd_epilogue``); ``plain=True`` runs them on any device. Each entry point takes ``saved``, a
checkpoint replay's hook: for the blocks a stand-in for the output, which the
backward never reads (nothing launches, as the JAX replay drops the block's
forward); for fc1 alone the kept output g, which fc2's weight gradient reads
(without it the replay runs the forward again, as JAX's does).

Dropout draws its mask from ``ops/philox.py``: a pure function of (seeds[b],
row, column), so the backward regenerates the forward's mask bit for bit and
a checkpoint replay drops the same elements. It cannot reproduce the TPU's
bits (another generator), and the JAX CPU path (``jax.random.bernoulli``,
``ffn_pallas.py:2136``) is another stream again.

Weights use PyTorch's ``Linear`` layout: W1 (F, D), W2 (D, F).
"""

from __future__ import annotations

import torch

from . import _build
from .gelu_poly import _dgelu, _phi, gelu_poly
from .ln_gelu import WIDTHS_ROADMAP, ln_bwd
from .philox import keep_mask, threshold

# Widths the kernels take, each its own instantiation, counted apart: the
# launches at 1024 under the bare names ("ffn_ln", "ffn_bwd"), the others
# under names ending in the width ("ffn_ln_drop_1920").
KERNEL_D = (384, 512, 768, 1024, 1280, 1920)
KERNEL_F_TILE = 256
# Widths of the packed QKV projection's kernels (``ln_dense``): the XLS-R
# encoders' (300M, 1B, 2B), F = 3 D; counted as "ln_dense", "ln_dense_bwd" at
# 1024 and with the width elsewhere ("ln_dense_bwd_1920").
KERNEL_QKV_D = (1024, 1280, 1920)
# N6's dW kernel: 64-row chunks of its reduction; a tile's side along F (the
# other is 128); the tiles that fill the card once (an H100's 132 SMs, one
# block an SM) and the blocks at most (four such waves). Constants, so that
# the row ranges, and with them dW's bits, depend on the shape alone.
_DW_CHUNK = 64
_DW_TILE_F = 256
_DW_FILL = 132
_DW_BLOCKS = 528


def ffn_fc2_cluster(D: int) -> int:
    """C, the blocks of N7's thread-block cluster at width D
    (``csrc/ffn_ln_fc2.cu`` ``cluster_size``): each owns D / C of y's columns
    and computes every C-th of the F / 128 h tiles; D / 128 up to the
    portable cluster size 8 (128 columns a block; 160 at 1280), and 15 at
    1920 (128 columns; a non-portable size, faster there than 8, 10 or 12)."""
    return 15 if D == 1920 else min(D // 128, 8)


def ffn_dw_ranges(M: int, D: int, F: int) -> int:
    """R, the ranges of 64-row chunks (``ceil(M / 64)`` of them) over which N6's
    dW kernel splits its reduction: 1 where its ``2 (F / 256) (D / 128)``
    tiles alone fill the card (each block then writes its tile of dW1 or
    dW2, with no partials to sum), else as many as keep the tiles times R
    within ``_DW_BLOCKS``, at least one chunk each."""
    chunks = -(-M // _DW_CHUNK)
    tiles = 2 * (F // _DW_TILE_F) * (D // 128)
    if tiles >= _DW_FILL:
        return 1
    return max(1, min(chunks, _DW_BLOCKS // tiles))


def _name(base: str, D: int) -> str:
    return base if D == 1024 else f"{base}_{D}"


def _ln_rows(x, gamma, beta, eps):
    """``_ln_rows``: fp32 LayerNorm; returns (ln rounded to x.dtype, xhat, rstd)."""
    x32 = x.float()
    cen = x32 - x32.mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt((cen * cen).mean(dim=-1, keepdim=True) + eps)
    xhat = cen * rstd
    return (xhat * gamma.float() + beta.float()).to(x.dtype), xhat, rstd


def _h(a, w1, b1):
    """The pre-activation ``a @ W1^T + b1``: bf16 operands, fp32 sums and bias."""
    return a.float() @ w1.to(a.dtype).float().t() + b1.float()


def _act(h, T, rate, seeds):
    """``dropout(gelu(h))`` in fp32: the polynomial GELU, the Philox mask of
    (seeds[b], row, column) and the 1/keep scale."""
    g = gelu_poly(h)
    if rate > 0.0:
        keep = keep_mask(seeds, T, h.shape[-1], rate)
        g = torch.where(keep, g * (1.0 / (1.0 - rate)), 0.0)
    return g


def _act_bwd(h, dg, T, rate, seeds):
    """(g, dh) in fp32 from h and dg, the forward's mask regenerated."""
    g = h * _phi(h)
    if rate > 0.0:
        keep = keep_mask(seeds, T, h.shape[-1], rate)
        scale = 1.0 / (1.0 - rate)
        return torch.where(keep, g * scale, 0.0), torch.where(keep, dg * scale * _dgelu(h), 0.0)
    return g, dg * _dgelu(h)


def ffn_ln_fc1_plain(x, w1, b1, gamma, beta, eps: float = 1e-5, rate: float = 0.0,
                     seeds=None):
    """``g`` in plain ops: fp32 LayerNorm rounded to ``x.dtype`` (the
    product's operand, as ``_ln_matmul``), the product accumulated in fp32,
    + b1, polynomial GELU, the dropout mask, cast to ``x.dtype``."""
    ln, _, _ = _ln_rows(x, gamma, beta, eps)
    return _act(_h(ln, w1, b1), x.shape[1], rate, seeds).to(x.dtype)


def ffn_fc1_plain(x, w1, b1, rate: float = 0.0, seeds=None):
    """``g`` of ``_fwd_kernel[_drop]`` in plain ops: ``x @ W1^T`` accumulated
    in fp32, + b1, polynomial GELU, the dropout mask, cast to ``x.dtype``."""
    return _act(_h(x, w1, b1), x.shape[1], rate, seeds).to(x.dtype)


def _fc2(g, w2, b2):
    """fc2 as ``_fc2``: the product with fp32 accumulation, + b2 in fp32,
    cast to g.dtype. (For bf16 ``torch.matmul`` rounds its output to bf16
    before the bias add; in fp32 the two agree.)"""
    return (torch.matmul(g, w2.to(g.dtype).t()).float() + b2.float()).to(g.dtype)


def ffn_ln_fc2_fwd_plain(x, w1, b1, gamma, beta, w2, b2, eps: float = 1e-5,
                         rate: float = 0.0, seeds=None):
    """``_fwd_kernel_ln_fc2[_drop]`` in plain ops (N7): g as
    ``ffn_ln_fc1_plain`` (rounded to x.dtype, fc2's operand), then
    ``g @ W2^T + b2`` summed in fp32 and rounded once to x.dtype, the
    rounding of ``_fc2`` in the JAX package."""
    g = ffn_ln_fc1_plain(x, w1, b1, gamma, beta, eps, rate, seeds)
    return (g.float() @ w2.to(x.dtype).float().t() + b2.float()).to(x.dtype)


def _check_shapes(name, x, w1, F):
    D = x.shape[-1]
    if D not in KERNEL_D or w1.shape != (F, D) or F % KERNEL_F_TILE:
        raise ValueError(
            f"{name}: the kernel takes D in {KERNEL_D} and F a multiple of "
            f"{KERNEL_F_TILE}, got x {tuple(x.shape)} and w1 {tuple(w1.shape)}; "
            + WIDTHS_ROADMAP
        )
    return D


def _check_seeds(name, x, rate, seeds):
    if rate == 0.0:
        return None, 1, 0, 1.0
    if x.dim() != 3 or seeds is None or seeds.shape != (x.shape[0],):
        raise ValueError(f"{name}: dropout needs x (B, T, D) and seeds (B,)")
    if seeds.dtype != torch.int32 or seeds.device != x.device or not seeds.is_contiguous():
        raise ValueError(f"{name}: seeds must be contiguous int32 on {x.device}")
    return seeds.data_ptr(), x.shape[1], threshold(rate), 1.0 / (1.0 - rate)


def _check_fc1(name, x, w1, b1, vectors=()):
    """Checks the operands of an fc1 kernel; returns (D, F, w1 in x.dtype)."""
    F = w1.shape[0]
    D = _check_shapes(name, x, w1, F)
    w1 = w1.to(x.dtype)
    _build.check_cuda(name, torch.bfloat16, x, w1)
    _build.check_cuda(name, torch.float32, b1, *vectors)
    if b1.shape != (F,) or any(v.shape != (D,) for v in vectors):
        raise ValueError(f"{name}: b1 must be ({F},), gamma and beta ({D},)")
    if any(t.device != x.device for t in (w1, b1, *vectors)):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    return D, F, w1


def _check_dg(name, x, dg, F):
    dg = dg.to(x.dtype).contiguous()
    _build.check_cuda(name, torch.bfloat16, dg)
    if dg.shape != (*x.shape[:-1], F):
        raise ValueError(f"{name}: dg must be {(*x.shape[:-1], F)}, got {tuple(dg.shape)}")
    return dg


def _db1_part(x, D, F):
    """The kernels' db1 partials: one row per 128-row tile (every width)."""
    M = x.numel() // D
    row_tile = _build.library().coral_ffn_row_tile(D)
    return M, torch.empty((-(-M // row_tile), F), dtype=torch.float32, device=x.device)


def ffn_ln_fc1_fwd(x, w1, b1, gamma, beta, eps: float = 1e-5, rate: float = 0.0, seeds=None):
    """``g = dropout(gelu(bf16(layer_norm(x)) @ W1^T + b1))``, the kernel's output.

    Args:
        x: (B, T, D); on CUDA bf16 with D in ``KERNEL_D``.
        w1: (F, D), cast to ``x.dtype``; on CUDA F a multiple of 256.
        b1: (F,) fp32.  gamma, beta: (D,) fp32.
        rate: activation-dropout rate in [0, 1).
        seeds: (B,) int32, the mask's seeds (rate > 0).

    Returns:
        (B, T, F) in ``x.dtype``.
    """
    name = "coral_ffn_ln_fwd"
    if not _build.require_cuda(name, x):
        return ffn_ln_fc1_plain(x, w1, b1, gamma, beta, eps, rate, seeds)
    D, F, w1 = _check_fc1(name, x, w1, b1, (gamma, beta))
    seed_ptr, T, thr, scale = _check_seeds(name, x, rate, seeds)
    g = torch.empty((*x.shape[:-1], F), dtype=x.dtype, device=x.device)
    _build.launch(
        name, _name("ffn_ln_drop" if rate > 0.0 else "ffn_ln", D), x.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), gamma.data_ptr(), beta.data_ptr(), seed_ptr, g.data_ptr(),
        x.numel() // D, D, F, T, thr, scale, float(eps),
    )
    return g


def ffn_fc1_fwd(x, w1, b1, rate: float = 0.0, seeds=None):
    """``g = dropout(gelu(x @ W1^T + b1))``, the kernel's output (N1);
    arguments and result as ``ffn_ln_fc1_fwd`` without the LayerNorm."""
    name = "coral_ffn_fc1_fwd"
    if not _build.require_cuda(name, x):
        return ffn_fc1_plain(x, w1, b1, rate, seeds)
    D, F, w1 = _check_fc1(name, x, w1, b1)
    seed_ptr, T, thr, scale = _check_seeds(name, x, rate, seeds)
    g = torch.empty((*x.shape[:-1], F), dtype=x.dtype, device=x.device)
    _build.launch(
        name, _name("ffn_fc1_drop" if rate > 0.0 else "ffn_fc1", D), x.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), seed_ptr, g.data_ptr(), x.numel() // D, D, F, T, thr,
        scale,
    )
    return g


def ffn_ln_fc2_fwd(x, w1, b1, gamma, beta, w2, b2, eps: float = 1e-5, rate: float = 0.0,
                   seeds=None):
    """The whole block's forward in one kernel (N7): ``dropout(gelu(bf16(
    layer_norm(x)) @ W1^T + b1)) @ W2^T + b2``; g never reaches device
    memory (the normalised rows do, once, as an (M, D) scratch the kernel's
    clusters stream).

    Args:
        x: (B, T, D); on CUDA bf16 with D in ``KERNEL_D``.
        w1: (F, D); w2: (D, F); cast to ``x.dtype``; on CUDA F a multiple of
            256 (the kernel reads them through TMA tensor maps: 16-byte
            aligned, as every kernel operand).
        b1: (F,), gamma, beta, b2: (D,), fp32.
        rate, seeds: as ``ffn_ln_fc1_fwd``.

    Returns:
        (B, T, D) in ``x.dtype``.
    """
    name = "coral_ffn_ln_fc2_fwd"
    if not _build.require_cuda(name, x):
        return ffn_ln_fc2_fwd_plain(x, w1, b1, gamma, beta, w2, b2, eps, rate, seeds)
    D, F, w1 = _check_fc1(name, x, w1, b1, (gamma, beta, b2))
    w2 = w2.to(x.dtype).contiguous()
    _build.check_cuda(name, torch.bfloat16, w2)
    if w2.shape != (D, F) or w2.device != x.device:
        raise ValueError(f"{name}: w2 must be ({D}, {F}) on {x.device}")
    seed_ptr, T, thr, scale = _check_seeds(name, x, rate, seeds)
    y = torch.empty_like(x)
    ln = torch.empty_like(x)  # the normalised rows, scratch
    _build.launch(
        name, _name("ffn_ln_fc2_drop" if rate > 0.0 else "ffn_ln_fc2", D), x.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), seed_ptr, y.data_ptr(), ln.data_ptr(), x.numel() // D, D, F, T, thr,
        scale, float(eps),
    )
    return y


def _ln_bwd_rows(dl, xhat, rstd, gamma):
    """The LayerNorm backward of ``_bwd_ln_epilogue``: dx (fp32) from dl."""
    dn = dl * gamma.float()
    return (dn - dn.mean(dim=-1, keepdim=True)
            - xhat * (dn * xhat).mean(dim=-1, keepdim=True)) * rstd


def _ln_g_bwd_plain(x, w1, b1, gamma, beta, dg32, eps, rate, seeds):
    """The LayerNorm-folded backward pass in plain ops from dg in fp32:
    (g, dh, ln_out, dx, db1, dgamma, dbeta), as ``ffn_ln_g_bwd_plain``."""
    dt = x.dtype
    D = x.shape[-1]
    ln, xhat, rstd = _ln_rows(x, gamma, beta, eps)
    g, dh = _act_bwd(_h(ln, w1, b1), dg32, x.shape[1], rate, seeds)
    dhb = dh.to(dt)
    dl = dhb.float() @ w1.to(dt).float()
    dx = _ln_bwd_rows(dl, xhat, rstd, gamma)
    return (g.to(dt), dhb, ln, dx.to(dt), dh.reshape(-1, dh.shape[-1]).sum(0),
            (dl * xhat).reshape(-1, D).sum(0), dl.reshape(-1, D).sum(0))


def ffn_bwd_plain(x, w1, b1, gamma, beta, dy, w2, eps: float = 1e-5, rate: float = 0.0,
                  seeds=None):
    """``_bwd_kernel_ln_g_dg[_drop]`` + ``_bwd_ln_epilogue`` in plain ops.

    Returns (g, dh, ln_out, dx, db1, dgamma, dbeta): g, dh, ln_out and dx in
    x.dtype; db1 (F,), dgamma and dbeta (D,) fp32. dg = dy W2^T stays in
    fp32, as in the kernel; dh is rounded before ``dl = dh @ W1`` and summed
    unrounded into db1, as in the TPU kernel."""
    dt = x.dtype
    dg = dy.to(dt).float() @ w2.to(dt).float()
    return _ln_g_bwd_plain(x, w1, b1, gamma, beta, dg, eps, rate, seeds)


def ffn_ln_g_bwd_plain(x, w1, b1, gamma, beta, dg, eps: float = 1e-5, rate: float = 0.0,
                       seeds=None):
    """``_bwd_kernel_ln_g[_drop]`` + ``_bwd_ln_epilogue`` in plain ops (N5):
    ``ffn_bwd_plain`` with dg (B, T, F) read in, rounded to x.dtype as the
    kernel reads it. Returns (g, dh, ln_out, dx, db1, dgamma, dbeta)."""
    return _ln_g_bwd_plain(x, w1, b1, gamma, beta, dg.to(x.dtype).float(), eps, rate, seeds)


def ffn_dw_plain(dh, ln_out, dy, g):
    """N6's weight gradients in plain ops: ``dW1 = dh^T ln_out`` (F, D) and
    ``dW2 = dy^T g`` (D, F), bf16 operands summed in fp32 over every row."""
    def at_b(a, b):
        return a.reshape(-1, a.shape[-1]).float().t() @ b.reshape(-1, b.shape[-1]).float()

    return at_b(dh, ln_out), at_b(dy.to(g.dtype), g)


def ffn_ln_dw_bwd_plain(x, w1, b1, gamma, beta, dy, dg, eps: float = 1e-5,
                        rate: float = 0.0, seeds=None):
    """``_bwd_kernel_ln_dw`` in plain ops (N6): dh, g and ln_out as N5's,
    then the weight gradients over every row. Returns (dx, dW1 (F, D) fp32,
    dW2 (D, F) fp32, db1, dgamma, dbeta)."""
    g, dh, ln_out, dx, db1, dgamma, dbeta = ffn_ln_g_bwd_plain(
        x, w1, b1, gamma, beta, dg, eps, rate, seeds)
    dw1, dw2 = ffn_dw_plain(dh, ln_out, dy, g)
    return dx, dw1, dw2, db1, dgamma, dbeta


def ffn_bwd(x, w1, b1, gamma, beta, dy, w2, eps: float = 1e-5, rate: float = 0.0,
            seeds=None):
    """The backward kernels; arguments and results as ``ffn_bwd_plain``.

    Args:
        x, dy: (B, T, D) bf16, D in ``KERNEL_D``.
        w1: (F, D); w2: (D, F); cast to x.dtype. b1 (F,), gamma, beta (D,) fp32.
    """
    name = "coral_ffn_bwd"
    if not _build.require_cuda(name, x):
        return ffn_bwd_plain(x, w1, b1, gamma, beta, dy, w2, eps, rate, seeds)
    D, F, w1 = _check_fc1(name, x, w1, b1, (gamma, beta))
    w2, dy = w2.to(x.dtype).contiguous(), dy.to(x.dtype).contiguous()
    _build.check_cuda(name, torch.bfloat16, x, w2, dy)
    if w2.shape != (D, F) or dy.shape != x.shape:
        raise ValueError(f"{name}: w2 must be ({D}, {F}), dy {tuple(x.shape)}")
    seed_ptr, T, thr, scale = _check_seeds(name, x, rate, seeds)
    M, db1_part = _db1_part(x, D, F)
    g = torch.empty((*x.shape[:-1], F), dtype=x.dtype, device=x.device)
    dh = torch.empty_like(g)
    ln_out = torch.empty_like(x)
    dl = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _build.launch(
        name, _name("ffn_bwd", D), x.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), gamma.data_ptr(), beta.data_ptr(), dy.data_ptr(), w2.data_ptr(),
        seed_ptr, g.data_ptr(), dh.data_ptr(), ln_out.data_ptr(), db1_part.data_ptr(),
        dl.data_ptr(), M, D, F, T, thr, scale, float(eps),
    )
    dx, dgamma, dbeta = ln_bwd(x, gamma, beta, dl, eps, apply_gelu=False)
    return g, dh, ln_out, dx, db1_part.sum(0), dgamma, dbeta


def _ln_g_outputs(x, F):
    """g, dh (M, F) in x.dtype, ln_out (M, D) and dl (M, D) fp32: N5's outputs."""
    g = torch.empty((*x.shape[:-1], F), dtype=x.dtype, device=x.device)
    dl = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    return g, torch.empty_like(g), torch.empty_like(x), dl


def ffn_ln_g_bwd(x, w1, b1, gamma, beta, dg, eps: float = 1e-5, rate: float = 0.0,
                 seeds=None):
    """The backward kernels with dg read in (N5) and the LayerNorm backward;
    arguments and results as ``ffn_ln_g_bwd_plain``.

    Args:
        x: (B, T, D) bf16, D in ``KERNEL_D``; dg: (B, T, F), cast to x.dtype.
        w1: (F, D), cast to x.dtype; b1 (F,), gamma, beta (D,) fp32.
    """
    name = "coral_ffn_ln_g_bwd"
    if not _build.require_cuda(name, x):
        return ffn_ln_g_bwd_plain(x, w1, b1, gamma, beta, dg, eps, rate, seeds)
    D, F, w1 = _check_fc1(name, x, w1, b1, (gamma, beta))
    dg = _check_dg(name, x, dg, F)
    seed_ptr, T, thr, scale = _check_seeds(name, x, rate, seeds)
    M, db1_part = _db1_part(x, D, F)
    g, dh, ln_out, dl = _ln_g_outputs(x, F)
    _build.launch(
        name, _name("ffn_ln_g_bwd", D), x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), dg.data_ptr(), seed_ptr, g.data_ptr(), dh.data_ptr(),
        ln_out.data_ptr(), db1_part.data_ptr(), dl.data_ptr(), M, D, F, T, thr, scale,
        float(eps),
    )
    dx, dgamma, dbeta = ln_bwd(x, gamma, beta, dl, eps, apply_gelu=False)
    return g, dh, ln_out, dx, db1_part.sum(0), dgamma, dbeta


def ffn_ln_dw_bwd(x, w1, b1, gamma, beta, dy, dg, eps: float = 1e-5, rate: float = 0.0,
                  seeds=None):
    """The backward with the weight gradients in the kernels (N6: N5's pass,
    dl = dh W1 and the dW kernel in one call) and the LayerNorm backward;
    arguments and results as ``ffn_ln_dw_bwd_plain``. g, dh and ln_out are
    scratch, freed on return, and so are dW's fp32 partials where the
    reduction is split over ``ffn_dw_ranges`` row ranges.

    Args:
        x, dy: (B, T, D) bf16, D in ``KERNEL_D``; dg: (B, T, F), cast to
            x.dtype.
        w1: (F, D), cast to x.dtype; b1 (F,), gamma, beta (D,) fp32.
    """
    name = "coral_ffn_ln_dw_bwd"
    if not _build.require_cuda(name, x):
        return ffn_ln_dw_bwd_plain(x, w1, b1, gamma, beta, dy, dg, eps, rate, seeds)
    D, F, w1 = _check_fc1(name, x, w1, b1, (gamma, beta))
    dg = _check_dg(name, x, dg, F)
    dy = dy.to(x.dtype).contiguous()
    _build.check_cuda(name, torch.bfloat16, x, dy)
    if dy.shape != x.shape:
        raise ValueError(f"{name}: dy must be {tuple(x.shape)}, got {tuple(dy.shape)}")
    seed_ptr, T, thr, scale = _check_seeds(name, x, rate, seeds)
    M, db1_part = _db1_part(x, D, F)
    g, dh, ln_out, dl = _ln_g_outputs(x, F)
    dw1 = torch.empty((F, D), dtype=torch.float32, device=x.device)
    dw2 = torch.empty((D, F), dtype=torch.float32, device=x.device)
    R = ffn_dw_ranges(M, D, F)
    part = (torch.empty((R, 2, F * D), dtype=torch.float32, device=x.device) if R > 1
            else None)
    _build.launch(
        name, _name("ffn_ln_dw_bwd", D), x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), dy.data_ptr(), dg.data_ptr(), seed_ptr, g.data_ptr(),
        dh.data_ptr(), ln_out.data_ptr(), db1_part.data_ptr(), dl.data_ptr(), dw1.data_ptr(),
        dw2.data_ptr(), None if part is None else part.data_ptr(), M, D, F, T, thr, scale,
        float(eps), R,
    )
    dx, dgamma, dbeta = ln_bwd(x, gamma, beta, dl, eps, apply_gelu=False)
    return dx, dw1, dw2, db1_part.sum(0), dgamma, dbeta


def ffn_fc1_bwd_plain(x, w1, b1, dg, rate: float = 0.0, seeds=None, emit_g: bool = False):
    """``_bwd_kernel[_drop]`` (N2) or, with ``emit_g``, ``_bwd_kernel_g[_drop]``
    (N3) + ``_bwd_epilogue`` in plain ops.

    Returns (dh, dx, db1), or (dh, g, dx, db1) with ``emit_g``: dh, g and dx
    in x.dtype, db1 (F,) fp32. dh is rounded before ``dx = dh @ W1`` and
    summed unrounded into db1, as in the TPU kernel."""
    dt = x.dtype
    g, dh = _act_bwd(_h(x, w1, b1), dg.to(dt).float(), x.shape[1], rate, seeds)
    dhb = dh.to(dt)
    dx = (dhb.float() @ w1.to(dt).float()).to(dt)
    db1 = dh.reshape(-1, dh.shape[-1]).sum(0)
    return (dhb, g.to(dt), dx, db1) if emit_g else (dhb, dx, db1)


def ffn_fc1_bwd(x, w1, b1, dg, rate: float = 0.0, seeds=None, emit_g: bool = False):
    """The backward kernels of fc1 without the LayerNorm (N2; N3 with
    ``emit_g``); arguments and results as ``ffn_fc1_bwd_plain``.

    Args:
        x: (B, T, D) bf16, D in ``KERNEL_D``; dg: (B, T, F), cast to x.dtype.
        w1: (F, D), cast to x.dtype; b1 (F,) fp32.
    """
    name = "coral_ffn_fc1_bwd"
    if not _build.require_cuda(name, x):
        return ffn_fc1_bwd_plain(x, w1, b1, dg, rate, seeds, emit_g)
    D, F, w1 = _check_fc1(name, x, w1, b1)
    dg = _check_dg(name, x, dg, F)
    seed_ptr, T, thr, scale = _check_seeds(name, x, rate, seeds)
    M, db1_part = _db1_part(x, D, F)
    dh = torch.empty_like(dg)
    g = torch.empty_like(dg) if emit_g else None
    dx = torch.empty_like(x)
    _build.launch(
        name, _name("ffn_block_bwd" if emit_g else "ffn_fc1_bwd", D), x.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), dg.data_ptr(), seed_ptr,
        None if g is None else g.data_ptr(), dh.data_ptr(), db1_part.data_ptr(), dx.data_ptr(),
        M, D, F, T, thr, scale,
    )
    db1 = db1_part.sum(0)
    return (dh, g, dx, db1) if emit_g else (dh, dx, db1)


def ffn_ln_fc1_bwd_plain(x, w1, b1, gamma, beta, dg, eps: float = 1e-5, rate: float = 0.0,
                         seeds=None):
    """``_bwd_kernel_ln[_drop]`` + ``_bwd_ln_epilogue`` in plain ops (N4).

    Returns (dh, dx, ln_out, db1, dgamma, dbeta): dh, dx and ln_out in
    x.dtype; db1 (F,), dgamma and dbeta (D,) fp32: N5's without g."""
    _, dh, ln_out, dx, db1, dgamma, dbeta = ffn_ln_g_bwd_plain(
        x, w1, b1, gamma, beta, dg, eps, rate, seeds)
    return dh, dx, ln_out, db1, dgamma, dbeta


def ffn_ln_fc1_bwd(x, w1, b1, gamma, beta, dg, eps: float = 1e-5, rate: float = 0.0,
                   seeds=None):
    """The backward kernels of the LayerNorm-folded fc1 (N4) and the
    LayerNorm backward; arguments and results as ``ffn_ln_fc1_bwd_plain``.

    Args:
        x: (B, T, D) bf16, D in ``KERNEL_D``; dg: (B, T, F), cast to x.dtype.
        w1: (F, D), cast to x.dtype; b1 (F,), gamma, beta (D,) fp32.
    """
    name = "coral_ffn_ln_fc1_bwd"
    if not _build.require_cuda(name, x):
        return ffn_ln_fc1_bwd_plain(x, w1, b1, gamma, beta, dg, eps, rate, seeds)
    D, F, w1 = _check_fc1(name, x, w1, b1, (gamma, beta))
    dg = _check_dg(name, x, dg, F)
    seed_ptr, T, thr, scale = _check_seeds(name, x, rate, seeds)
    M, db1_part = _db1_part(x, D, F)
    dh = torch.empty_like(dg)
    ln_out = torch.empty_like(x)
    dl = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _build.launch(
        name, _name("ffn_ln_fc1_bwd", D), x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), dg.data_ptr(), seed_ptr, dh.data_ptr(),
        ln_out.data_ptr(), db1_part.data_ptr(), dl.data_ptr(), M, D, F, T, thr, scale,
        float(eps),
    )
    dx, dgamma, dbeta = ln_bwd(x, gamma, beta, dl, eps, apply_gelu=False)
    return dh, dx, ln_out, db1_part.sum(0), dgamma, dbeta


def _seeds_for(name, rate, seeds):
    if rate > 0.0 and seeds is None:
        raise ValueError(f"{name}: dropout needs seeds")


def block_variant(dw_in_kernel: bool = False, fc2_in_kernel: bool = False,
                  dg_in_kernel: bool = True) -> str:
    """The LayerNorm-folded block's variant that ``ffn_ln_block``'s flags
    select, with the JAX precedence dw > fc2 > dg (``ffn_pallas.py:2139-
    2147``): "dw" (K5's forward, N6), "fc2" (N7, N5), "dg_in" (K5's forward
    and backward) or "dg_out" (K5's forward, N5)."""
    if dw_in_kernel:
        return "dw"
    if fc2_in_kernel:
        return "fc2"
    return "dg_in" if dg_in_kernel else "dg_out"


class _FFNBlock(torch.autograd.Function):
    """``_ffn_ln_block_dg`` and the other variants of ``ffn_ln_block``
    (``block_variant``): residuals are the primal inputs and the seeds
    (``ffn_pallas.py:1760``). The forward is K5's with fc2 outside, or N7's
    with fc2 inside ("fc2"). The backward is K5's (dg = dy W2^T in the
    kernel, "dg_in") or takes dg from outside, rounded to the working dtype
    as the JAX backward's ``.astype(dy.dtype)``: N5 ("fc2", "dg_out") or N6,
    which also forms dW1 and dW2 ("dw"). Elsewhere ``dW1 = dh^T ln_out`` and
    ``dW2 = dy^T g`` are products outside, rounded to the working dtype as
    ``.astype(w1.dtype)`` of the bf16 copies; ``db2 = sum(dy)`` always is.
    Since no residual comes from the forward, a checkpoint replay passes
    ``saved`` (a tensor it never reads) and nothing runs, as the JAX replay
    drops the block's forward."""

    @staticmethod
    def forward(ctx, x, w1, b1, gamma, beta, w2, b2, seeds, rate, eps, plain, saved, variant):
        ctx.save_for_backward(x, w1, b1, gamma, beta, w2, seeds)
        ctx.rate, ctx.eps, ctx.plain, ctx.variant = rate, eps, plain, variant
        ctx.b2_dtype = b2.dtype
        if saved is not None:
            return saved.detach()
        args = (x, w1, b1.float(), gamma.float(), beta.float())
        if variant == "fc2":
            fwd = ffn_ln_fc2_fwd_plain if plain else ffn_ln_fc2_fwd
            return fwd(*args, w2, b2.float(), eps, rate, seeds)
        fc1 = ffn_ln_fc1_plain if plain else ffn_ln_fc1_fwd
        return _fc2(fc1(*args, eps, rate, seeds), w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, gamma, beta, w2, seeds = ctx.saved_tensors
        dt, plain = x.dtype, ctx.plain
        args = (x, w1, b1.float(), gamma.float(), beta.float())
        tail = (ctx.eps, ctx.rate, seeds)
        if ctx.variant == "dg_in":
            bwd = ffn_bwd_plain if plain else ffn_bwd
            g, dh, ln_out, dx, db1, dgamma, dbeta = bwd(*args, dy.to(dt), w2, *tail)
        else:
            dg = torch.matmul(dy.to(dt), w2.to(dt))
            if ctx.variant == "dw":
                bwd = ffn_ln_dw_bwd_plain if plain else ffn_ln_dw_bwd
                dx, dw1, dw2, db1, dgamma, dbeta = bwd(*args, dy, dg, *tail)
            else:
                bwd = ffn_ln_g_bwd_plain if plain else ffn_ln_g_bwd
                g, dh, ln_out, dx, db1, dgamma, dbeta = bwd(*args, dg, *tail)
        if ctx.variant != "dw":
            dw1, dw2 = _outside_grads(dh, ln_out, dy, g)
        db2 = dy.reshape(-1, dy.shape[-1]).float().sum(0)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype), None, None, None,
                None, None, None)


def _outside_grads(dh, a, dy=None, g=None):
    """The products the JAX backward functions leave outside their kernels:
    ``dW1 = dh^T a`` (a: x or ln_out), and with the block's dy and g also
    ``dW2 = dy^T g``, in the working dtype (bf16 products with fp32 sums,
    rounded once)."""
    dw1 = torch.matmul(dh.reshape(-1, dh.shape[-1]).t(), a.reshape(-1, a.shape[-1]))
    if dy is None:
        return dw1
    dy2 = dy.reshape(-1, dy.shape[-1])
    return dw1, torch.matmul(dy2.to(g.dtype).t(), g.reshape(-1, g.shape[-1]))


class _FFNBlockNoLn(torch.autograd.Function):
    """``_ffn_block``: ``_FFNBlock`` without the LayerNorm. The backward forms
    ``dg = dy @ W2^T`` outside, rounded to the working dtype as the JAX
    backward's ``.astype(dy.dtype)`` after its fp32 product, then the kernels
    write dh, g and dx; dW1, dW2, db2 outside. A replay passes ``saved`` and
    nothing runs."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, seeds, rate, plain, saved):
        ctx.save_for_backward(x, w1, b1, w2, seeds)
        ctx.rate, ctx.plain, ctx.b2_dtype = rate, plain, b2.dtype
        if saved is not None:
            return saved.detach()
        fc1 = ffn_fc1_plain if plain else ffn_fc1_fwd
        return _fc2(fc1(x, w1, b1.float(), rate, seeds), w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, seeds = ctx.saved_tensors
        dt = x.dtype
        dg = torch.matmul(dy.to(dt), w2.to(dt))
        bwd = ffn_fc1_bwd_plain if ctx.plain else ffn_fc1_bwd
        dh, g, dx, db1 = bwd(x, w1, b1.float(), dg, ctx.rate, seeds, emit_g=True)
        dw1, dw2 = _outside_grads(dh, x, dy, g)
        db2 = dy.reshape(-1, dy.shape[-1]).float().sum(0)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dw2.to(w2.dtype),
                db2.to(ctx.b2_dtype), None, None, None, None)


class _FFNLnFc1(torch.autograd.Function):
    """``_ffn_ln_fc1``: residuals are the primal inputs and the seeds; the
    backward is N4 and the LayerNorm backward, with ``dW1 = dh^T ln_out``
    outside. A replay passes the kept g as ``saved``: the forward returns it
    and launches nothing."""

    @staticmethod
    def forward(ctx, x, w1, b1, gamma, beta, seeds, rate, eps, plain, saved):
        ctx.save_for_backward(x, w1, b1, gamma, beta, seeds)
        ctx.rate, ctx.eps, ctx.plain = rate, eps, plain
        if saved is not None:
            return saved.detach()
        fc1 = ffn_ln_fc1_plain if plain else ffn_ln_fc1_fwd
        return fc1(x, w1, b1.float(), gamma.float(), beta.float(), eps, rate, seeds)

    @staticmethod
    def backward(ctx, dg):
        x, w1, b1, gamma, beta, seeds = ctx.saved_tensors
        bwd = ffn_ln_fc1_bwd_plain if ctx.plain else ffn_ln_fc1_bwd
        dh, dx, ln_out, db1, dgamma, dbeta = bwd(
            x, w1, b1.float(), gamma.float(), beta.float(), dg.to(x.dtype), ctx.eps, ctx.rate,
            seeds,
        )
        dw1 = _outside_grads(dh, ln_out)
        return (dx, dw1.to(w1.dtype), db1.to(b1.dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), None, None, None, None, None)


class _FFNFc1(torch.autograd.Function):
    """``_ffn_fc1``: residuals are the primal inputs and the seeds; the
    backward is N2, with ``dW1 = dh^T x`` outside. ``saved`` as
    ``_FFNLnFc1``."""

    @staticmethod
    def forward(ctx, x, w1, b1, seeds, rate, plain, saved):
        ctx.save_for_backward(x, w1, b1, seeds)
        ctx.rate, ctx.plain = rate, plain
        if saved is not None:
            return saved.detach()
        fc1 = ffn_fc1_plain if plain else ffn_fc1_fwd
        return fc1(x, w1, b1.float(), rate, seeds)

    @staticmethod
    def backward(ctx, dg):
        x, w1, b1, seeds = ctx.saved_tensors
        bwd = ffn_fc1_bwd_plain if ctx.plain else ffn_fc1_bwd
        dh, dx, db1 = bwd(x, w1, b1.float(), dg.to(x.dtype), ctx.rate, seeds)
        dw1 = _outside_grads(dh, x)
        return dx, dw1.to(w1.dtype), db1.to(b1.dtype), None, None, None, None


def ffn_ln_block(x, w1, b1, gamma, beta, w2, b2, eps: float = 1e-5, rate: float = 0.0,
                 seeds=None, plain: bool = False, saved=None, dw_in_kernel: bool = False,
                 fc2_in_kernel: bool = False, dg_in_kernel: bool = True):
    """The whole pre-LN FFN, differentiable.

    Args:
        x: (B, T, D) residual stream.
        w1: (F, D); b1: (F,); gamma, beta: (D,); w2: (D, F); b2: (D,).
        rate: activation-dropout rate; seeds: (B,) int32 when rate > 0.
        plain: run the plain versions (forward and backward) on any device.
        saved: a checkpoint replay's stand-in for the output, which it does
            not read (no launch).
        dw_in_kernel, fc2_in_kernel, dg_in_kernel: the JAX ``ffn_ln_block``'s
            variant flags (``block_variant``; dg_in_kernel defaults to the
            setups' true, where the JAX function's own default is false).

    Returns:
        (B, T, D) in ``x.dtype`` (the residual add stays outside).
    """
    _seeds_for("ffn_ln_block", rate, seeds)
    variant = block_variant(dw_in_kernel, fc2_in_kernel, dg_in_kernel)
    return _FFNBlock.apply(x, w1, b1, gamma, beta, w2, b2, seeds, float(rate), float(eps),
                           plain, saved, variant)


def ffn_block(x, w1, b1, w2, b2, rate: float = 0.0, seeds=None, plain: bool = False,
              saved=None):
    """The whole FFN without a LayerNorm, differentiable: ``ffn_ln_block``'s
    arguments and result without gamma, beta and eps (x is the normalised
    input)."""
    _seeds_for("ffn_block", rate, seeds)
    return _FFNBlockNoLn.apply(x, w1, b1, w2, b2, seeds, float(rate), plain, saved)


def ffn_ln_fc1(x, w1, b1, gamma, beta, eps: float = 1e-5, rate: float = 0.0, seeds=None,
               plain: bool = False, saved=None):
    """``dropout(gelu(layer_norm(x) @ W1^T + b1))``, differentiable.

    Args:
        x: (B, T, D) residual stream; w1: (F, D); b1: (F,); gamma, beta: (D,).
        rate: activation-dropout rate; seeds: (B,) int32 when rate > 0.
        plain: run the plain versions (forward and backward) on any device.
        saved: a checkpoint replay's kept output g (returned, no launch).

    Returns:
        (B, T, F) in ``x.dtype``.
    """
    _seeds_for("ffn_ln_fc1", rate, seeds)
    return _FFNLnFc1.apply(x, w1, b1, gamma, beta, seeds, float(rate), float(eps), plain,
                           saved)


def ffn_fc1(x, w1, b1, rate: float = 0.0, seeds=None, plain: bool = False, saved=None):
    """``dropout(gelu(x @ W1^T + b1))``, differentiable: ``ffn_ln_fc1``'s
    arguments and result without the LayerNorm."""
    _seeds_for("ffn_fc1", rate, seeds)
    return _FFNFc1.apply(x, w1, b1, seeds, float(rate), plain, saved)


# -- the LayerNorm-folded packed projection (ln_dense) ----------------------------------


def ln_dense_plain(x, w, b, gamma, beta, eps: float = 1e-5):
    """``_fwd_kernel_lnmm`` in plain ops: the fp32 LayerNorm rounded to
    ``x.dtype`` (``_ln_matmul``), the product accumulated in fp32, + b in
    fp32, rounded once to ``x.dtype``."""
    ln, _, _ = _ln_rows(x, gamma, beta, eps)
    return _h(ln, w, b).to(x.dtype)


def ln_dense_bwd_plain(x, w, gamma, beta, dy, eps: float = 1e-5):
    """``_bwd_kernel_lnmm`` + the sums outside it in plain ops: the LayerNorm
    rebuilt from x, ``dl = dy @ W`` from the working-dtype dy in fp32, its
    LayerNorm backward.

    Returns (dx in x.dtype, ln_out in x.dtype, db (F,), dgamma, dbeta (D,)
    fp32): db the column sums of dy in fp32, dgamma = sum(dl xhat), dbeta =
    sum(dl)."""
    dt = x.dtype
    D, F = x.shape[-1], dy.shape[-1]
    ln, xhat, rstd = _ln_rows(x, gamma, beta, eps)
    dl = dy.to(dt).float() @ w.to(dt).float()
    dx = _ln_bwd_rows(dl, xhat, rstd, gamma)
    return (dx.to(dt), ln, dy.float().reshape(-1, F).sum(0), (dl * xhat).reshape(-1, D).sum(0),
            dl.reshape(-1, D).sum(0))


def _check_qkv(name, x, w, vectors):
    """Checks the operands of the packed projection's kernels; returns
    (D, F, w in x.dtype)."""
    D = x.shape[-1]
    F = w.shape[0]
    if D not in KERNEL_QKV_D or w.shape != (F, D) or F % 128:
        raise ValueError(
            f"{name}: the kernel takes D in {KERNEL_QKV_D} and F a multiple of 128, got x "
            f"{tuple(x.shape)} and w {tuple(w.shape)}; " + WIDTHS_ROADMAP
        )
    w = w.to(x.dtype)
    _build.check_cuda(name, torch.bfloat16, x, w)
    _build.check_cuda(name, torch.float32, *vectors)
    if any(t.device != x.device for t in (w, *vectors)):
        raise ValueError(f"{name}: all tensors must be on {x.device}")
    return D, F, w


def ln_dense_fwd(x, w, b, gamma, beta, eps: float = 1e-5):
    """``y = bf16(layer_norm(x)) @ W^T + b``, the forward kernel's output.

    Args:
        x: (B, T, D); on CUDA bf16 with D in ``KERNEL_QKV_D``.
        w: (F, D), cast to ``x.dtype``; on CUDA F a multiple of 128.
        b: (F,) fp32.  gamma, beta: (D,) fp32.

    Returns:
        (B, T, F) in ``x.dtype``.
    """
    name = "coral_ln_dense_fwd"
    if not _build.require_cuda(name, x):
        return ln_dense_plain(x, w, b, gamma, beta, eps)
    D, F, w = _check_qkv(name, x, w, (b, gamma, beta))
    if b.shape != (F,) or gamma.shape != (D,) or beta.shape != (D,):
        raise ValueError(f"{name}: b must be ({F},), gamma and beta ({D},)")
    y = torch.empty((*x.shape[:-1], F), dtype=x.dtype, device=x.device)
    _build.launch(name, _name("ln_dense", D), x.data_ptr(), w.data_ptr(), b.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), x.numel() // D, D, F,
                  float(eps))
    return y


def ln_dense_bwd(x, w, gamma, beta, dy, eps: float = 1e-5):
    """The backward kernels (ln_out, db's partials, dl) and the LayerNorm
    backward; arguments and results as ``ln_dense_bwd_plain``.

    Args:
        x: (B, T, D) bf16, D in ``KERNEL_QKV_D``; dy: (B, T, F), cast to x.dtype.
        w: (F, D), cast to x.dtype; gamma, beta (D,) fp32.
    """
    name = "coral_ln_dense_bwd"
    if not _build.require_cuda(name, x):
        return ln_dense_bwd_plain(x, w, gamma, beta, dy, eps)
    D, F, w = _check_qkv(name, x, w, (gamma, beta))
    dy = _check_dg(name, x, dy, F)
    M = x.numel() // D
    ln_out = torch.empty_like(x)
    db_part = torch.empty((-(-M // 64), F), dtype=torch.float32, device=x.device)
    dl = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    _build.launch(name, _name("ln_dense_bwd", D), x.data_ptr(), w.data_ptr(), gamma.data_ptr(),
                  beta.data_ptr(), dy.data_ptr(), ln_out.data_ptr(), db_part.data_ptr(),
                  dl.data_ptr(), M, D, F, float(eps))
    dx, dgamma, dbeta = ln_bwd(x, gamma, beta, dl, eps, apply_gelu=False)
    return dx, ln_out, db_part.sum(0), dgamma, dbeta


class _LnDense(torch.autograd.Function):
    """``_ln_dense``: residuals (x, w, gamma, beta), the primal inputs; the
    backward kernels and ``dW = dy^T ln_out`` outside, in the working dtype
    (``.astype(w.dtype)`` of the bf16 copy), db and the LayerNorm's vectors
    summed in fp32. A replay passes the kept output as ``saved``: the forward
    returns it and launches nothing."""

    @staticmethod
    def forward(ctx, x, w, b, gamma, beta, eps, plain, saved):
        ctx.save_for_backward(x, w, gamma, beta)
        ctx.eps, ctx.plain, ctx.b_dtype = eps, plain, b.dtype
        if saved is not None:
            return saved.detach()
        fwd = ln_dense_plain if plain else ln_dense_fwd
        return fwd(x, w, b.float(), gamma.float(), beta.float(), eps)

    @staticmethod
    def backward(ctx, dy):
        x, w, gamma, beta = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        bwd = ln_dense_bwd_plain if ctx.plain else ln_dense_bwd
        dx, ln_out, db, dgamma, dbeta = bwd(x, w, gamma.float(), beta.float(), dy, ctx.eps)
        dw = _outside_grads(dy, ln_out)
        return (dx, dw.to(w.dtype), db.to(ctx.b_dtype), dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), None, None, None)


def ln_dense(x, w, b, gamma, beta, eps: float = 1e-5, plain: bool = False, saved=None):
    """``layer_norm(x) @ W^T + b``, differentiable (the JAX ``ln_dense``).

    Args:
        x: (B, T, D) residual stream; w: (F, D), cast to x.dtype (F = 3 D for
            the packed QKV projection); b: (F,); gamma, beta: (D,).
        plain: run the plain versions (forward and backward) on any device.
        saved: a checkpoint replay's kept output (returned, no launch).

    Returns:
        (B, T, F) in ``x.dtype``. At D or F not a multiple of 128, the JAX
        function's XLA route: the LayerNorm rounded to x.dtype and the product
        in fp32 + b, as plain ops under autograd.
    """
    if x.shape[-1] % 128 or w.shape[0] % 128:
        return ln_dense_plain(x, w, b, gamma, beta, eps)  # under autograd
    return _LnDense.apply(x, w.to(x.dtype), b, gamma, beta, float(eps), plain, saved)

