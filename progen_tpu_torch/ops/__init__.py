from progen_tpu_torch.ops.local_attention import ATTN_MASK_VALUE, local_attention
from progen_tpu_torch.ops.rotary import (
    apply_rotary_pos_emb,
    fixed_pos_embedding,
    rotate_every_two,
)
from progen_tpu_torch.ops.sgu import gated_mix, spatial_gate
from progen_tpu_torch.ops.shift import shift_tokens

__all__ = [
    "ATTN_MASK_VALUE",
    "apply_rotary_pos_emb",
    "fixed_pos_embedding",
    "gated_mix",
    "local_attention",
    "rotate_every_two",
    "shift_tokens",
    "spatial_gate",
]
