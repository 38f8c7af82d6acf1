"""Windowed causal local attention, plain PyTorch
(ported from progen_tpu/ops/local_attention.py).

This is the plain version of the windowed-attention kernels
(``ops/cuda_attention.py``), forward and backward: the CPU path, and what
the kernels are held against on the card.

* ``L % window_size == 0``; the sequence is cut into ``L / wsz`` windows;
* keys/values get a ZERO window prepended, and each query window attends
  over ``[previous window ‖ own window]`` = ``2*wsz`` keys, so window 0's
  phantom zero keys put ``wsz`` zero logits into the softmax denominator;
* mask ``tril(ones(wsz, 2*wsz), k=wsz)``, masked logits ``-1e10``;
* scale ``dim_head ** -0.5``; f32 logits and softmax, probabilities cast
  to ``v.dtype`` before the second product, which accumulates in f32.

With ``k_halo``/``v_halo`` ``(B, H, wsz, Dh)`` window 0's previous window is
that halo instead of the zero window: the left neighbour's last window under
context parallelism (``parallel/context.py``), the first window of
``pallas_local_attention_ext``'s ``k_ext``/``v_ext``
(``progen_tpu/ops/pallas_attention.py:258``), whose backward also returns the
halo's gradients.  No halo is the zero window, bit for bit as before.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

ATTN_MASK_VALUE = -1e10


def window_mask(window_size: int, device=None) -> torch.Tensor:
    """``(wsz, 2*wsz)`` bool mask: query i sees keys j with j <= i + wsz."""
    return torch.ones(window_size, 2 * window_size, dtype=torch.bool,
                      device=device).tril(window_size)


def concat_previous_window(t: torch.Tensor, halo: torch.Tensor | None = None) -> torch.Tensor:
    """``(..., W, n, d) -> (..., W, 2n, d)``: prepend ``halo`` ``(..., n, d)``
    as window -1 (a zero window without one), then pair each window with its
    predecessor."""
    if halo is None:
        t = F.pad(t, (0, 0, 0, 0, 1, 0))
    else:
        t = torch.cat((halo.unsqueeze(-3), t), dim=-3)
    return torch.cat((t[..., :-1, :, :], t[..., 1:, :, :]), dim=-2)


def _check_halo(q, k_halo, v_halo, window_size: int) -> None:
    if (k_halo is None) != (v_halo is None):
        raise ValueError("k_halo and v_halo come together")
    if k_halo is not None:
        want = (*q.shape[:2], window_size, q.shape[3])
        if tuple(k_halo.shape) != want or tuple(v_halo.shape) != want:
            raise ValueError(f"the halo must be {want}, got {tuple(k_halo.shape)} "
                             f"and {tuple(v_halo.shape)}")


def local_attention(q, k, v, *, window_size: int, scale: float | None = None,
                    return_lse: bool = False, k_halo=None, v_halo=None):
    """Windowed attention over ``(B, H, L, Dh)`` tensors -> ``(B, H, L, Dh)``.

    ``return_lse=True`` also returns the per-row f32 logsumexp ``(B, H, L)``
    of the scaled, masked logits, which the kernel writes for the backward.
    ``k_halo``/``v_halo`` ``(B, H, wsz, Dh)``: window 0's previous window.
    """
    b, h, n, d = q.shape
    wsz = window_size
    if n % wsz != 0:
        raise ValueError(f"sequence length {n} must be divisible by window {wsz}")
    _check_halo(q, k_halo, v_halo, wsz)
    w = n // wsz
    scale = d ** -0.5 if scale is None else scale

    qw = q.reshape(b, h, w, wsz, d)
    kw = concat_previous_window(k.reshape(b, h, w, wsz, d), k_halo)
    vw = concat_previous_window(v.reshape(b, h, w, wsz, d), v_halo)

    sim = torch.einsum("bhwid,bhwjd->bhwij", qw.float(), kw.float()) * scale
    sim = sim.masked_fill(~window_mask(wsz, q.device), ATTN_MASK_VALUE)
    attn = torch.softmax(sim, dim=-1).to(vw.dtype)
    out = torch.einsum("bhwij,bhwjd->bhwid", attn.float(), vw.float())
    out = out.to(vw.dtype).reshape(b, h, n, d)
    if return_lse:
        return out, torch.logsumexp(sim, dim=-1).reshape(b, h, n)
    return out


def local_attention_bwd(q, k, v, out, lse, do, window_size: int,
                        scale: float | None = None, k_halo=None, v_halo=None):
    """Gradients ``(dq, dk, dv)`` of :func:`local_attention`, from the
    forward's ``out`` and f32 ``lse`` and the output cotangent ``do``; with
    a halo ``(dq, dk, dv, dk_halo, dv_halo)``.

    The flash-style backward of ``progen_tpu/ops/pallas_attention.py``:
    ``D = rowsum(do * out)`` in f32, probabilities recomputed as
    ``exp(s - lse)``, ``ds = p * (do . v^T - D)``; ``p`` is cast to do's
    dtype before ``p^T . do`` and ``ds`` to k's (q's) dtype before
    ``ds . k`` (``ds^T . q``), every product accumulates in f32, and each
    gradient is cast once.  A key window gets its gradient from two query
    windows, its own (causal) and the next (fully visible); the phantom
    window's share is dropped, as ``jnp.pad``'s VJP drops it; a halo's is
    the previous half of query window 0's."""
    b, h, n, d = q.shape
    wsz = window_size
    _check_halo(q, k_halo, v_halo, wsz)
    w = n // wsz
    scale = d ** -0.5 if scale is None else scale

    qw = q.reshape(b, h, w, wsz, d)
    dow = do.reshape(b, h, w, wsz, d)
    kw = concat_previous_window(k.reshape(b, h, w, wsz, d), k_halo)
    vw = concat_previous_window(v.reshape(b, h, w, wsz, d), v_halo)
    dd = (do.float() * out.float()).sum(-1).reshape(b, h, w, wsz, 1)

    sim = torch.einsum("bhwid,bhwjd->bhwij", qw.float(), kw.float()) * scale
    sim = sim.masked_fill(~window_mask(wsz, q.device), ATTN_MASK_VALUE)
    p = torch.exp(sim - lse.reshape(b, h, w, wsz, 1))
    dp = torch.einsum("bhwid,bhwjd->bhwij", dow.float(), vw.float())
    ds = p * (dp - dd)

    dq = torch.einsum("bhwij,bhwjd->bhwid", ds.to(k.dtype).float(),
                      kw.float()) * scale
    dkw = torch.einsum("bhwij,bhwid->bhwjd", ds.to(q.dtype).float(),
                       qw.float())
    dvw = torch.einsum("bhwij,bhwid->bhwjd", p.to(do.dtype).float(),
                       dow.float())

    def fold(t):
        # key window m: own half of query window m + previous half of m+1
        own, prev = t[..., wsz:, :], t[..., :wsz, :]
        return own + F.pad(prev[:, :, 1:], (0, 0, 0, 0, 0, 1))

    dk = (fold(dkw) * scale).to(k.dtype).reshape(b, h, n, d)
    dv = fold(dvw).to(v.dtype).reshape(b, h, n, d)
    dq = dq.to(q.dtype).reshape(b, h, n, d)
    if k_halo is None:
        return dq, dk, dv
    dk_halo = (dkw[:, :, 0, :wsz] * scale).to(k.dtype)
    dv_halo = dvw[:, :, 0, :wsz].to(v.dtype)
    return dq, dk, dv, dk_halo, dv_halo
