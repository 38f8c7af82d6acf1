from progen_tpu_torch.compat.convert import (
    load_npz,
    params_from_flax,
    params_to_flax,
    save_npz,
)

__all__ = ["load_npz", "params_from_flax", "params_to_flax", "save_npz"]
