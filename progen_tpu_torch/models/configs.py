"""The model configs (ported from progen_tpu/models/configs.py)."""

from __future__ import annotations

import dataclasses

from progen_tpu_torch.models.progen import ProGenConfig

# Reference repo's default toy config.
DEFAULT = ProGenConfig(
    num_tokens=256, dim=128, depth=3, heads=3, dim_head=32,
    window_size=512, seq_len=1024, ff_glu=True, global_mlp_depth=2,
)

# ProGen-tiny.
TINY = ProGenConfig(
    num_tokens=256, dim=512, depth=12, heads=8, dim_head=64,
    window_size=256, seq_len=1024, ff_glu=True, global_mlp_depth=2,
)

# ProGen-small (~150M).
SMALL = ProGenConfig(
    num_tokens=256, dim=1024, depth=12, heads=8, dim_head=128,
    window_size=256, seq_len=1024, ff_glu=True, global_mlp_depth=2,
)

# ProGen-base (~760M).
BASE = ProGenConfig(
    num_tokens=256, dim=1536, depth=24, heads=12, dim_head=128,
    window_size=512, seq_len=2048, ff_glu=True, global_mlp_depth=2,
)

# ProGen-large (1.2B).
LARGE = ProGenConfig(
    num_tokens=256, dim=1536, depth=36, heads=12, dim_head=128,
    window_size=512, seq_len=1024, ff_glu=True, global_mlp_depth=2,
)

# ProGen-XL (~6B).
XL = ProGenConfig(
    num_tokens=256, dim=4096, depth=32, heads=32, dim_head=128,
    window_size=512, seq_len=4096, ff_glu=True, global_mlp_depth=2,
)

CONFIGS = {
    "default": DEFAULT,
    "tiny": TINY,
    "small": SMALL,
    "base": BASE,
    "large": LARGE,
    "xl": XL,
}


def draft_config_for(target: ProGenConfig, *, dim: int | None = None,
                     depth: int | None = None, heads: int | None = None,
                     dim_head: int | None = None) -> ProGenConfig:
    """A small draft config for speculative decoding against ``target``.

    The draft shares ``num_tokens`` (it proposes tokens in the target's
    vocabulary), ``window_size`` (one padded prime batch prefills both
    models, at window-aligned buckets) and ``seq_len`` (positions mean the
    same to both).  What only sets capacity shrinks: by default a
    quarter-width, two-layer model with half the heads and one gMLP layer.
    """
    depth = depth if depth is not None else min(2, target.depth)
    return dataclasses.replace(
        target,
        dim=dim if dim is not None else max(8, target.dim // 4),
        depth=depth,
        heads=heads if heads is not None else max(1, target.heads // 2),
        dim_head=dim_head if dim_head is not None else target.dim_head,
        global_mlp_depth=min(1, depth),
    )
