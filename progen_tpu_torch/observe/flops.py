"""Model-FLOPs accounting and MFU (ported from progen_tpu/observe/flops.py).

The peak is read from the card's name, as JAX's is from the TPU's device
kind.  The table holds only the card this repo measures on: the H100 SXM's
dense bf16 tensor-core rate from NVIDIA's data sheet, at its full 700 W
power limit.  Any other card, and the CPU, has no entry, and no MFU is
logged for it.
"""

from __future__ import annotations

H100_PEAK_BF16_FLOPS = 989e12

# bf16 peak FLOP/s by torch.cuda.get_device_name
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": H100_PEAK_BF16_FLOPS,
}


def model_flops_per_token(cfg, num_params: int) -> float:
    """Training FLOPs (forward + backward) per token: 6N for every dense
    parameter plus the windowed-attention score/value products, which touch
    2*wsz keys per query (8*wsz*inner per token and layer forward, x3 with
    the backward).

    The SGU's spatial ``(n, n)`` weights contract over tokens, not
    features, so they are pulled out of 6N and charged by the product the
    kernels run: the causal one, ``n*(d_ff/2)`` per token forward (the
    upper-triangle tiles are skipped), x3 with the backward.  This is the
    JAX package's count for ``sgu_impl="pallas"``.
    """
    inner = cfg.heads * cfg.dim_head
    attn = 24.0 * cfg.window_size * inner * cfg.depth
    n_gmlp = min(cfg.global_mlp_depth, cfg.depth)
    n = cfg.seq_len
    d_half = cfg.dim * cfg.ff_mult // 2
    spatial_params = n_gmlp * (n * n + n)  # weights + biases per gMLP layer
    sgu = 6.0 * n * d_half * 0.5 * n_gmlp
    return 6.0 * (num_params - spatial_params) + attn + sgu


def peak_flops_per_chip(device=None) -> float | None:
    """Peak bf16 FLOP/s of ``device`` (the current CUDA device by default),
    or None on the CPU or a card the table does not know (callers skip
    MFU then)."""
    import torch

    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        return None
    return PEAK_BF16_FLOPS.get(torch.cuda.get_device_name(device))


def mfu(tokens_per_sec: float, flops_per_token: float,
        peak: float | None) -> float | None:
    """Model FLOPs utilisation of one card, None without a peak."""
    if peak is None or peak <= 0:
        return None
    return flops_per_token * tokens_per_sec / peak
