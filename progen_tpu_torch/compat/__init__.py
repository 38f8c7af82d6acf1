from progen_tpu_torch.compat.convert import (
    grads_to_flax,
    load_npz,
    params_from_flax,
    params_to_flax,
    save_npz,
)

__all__ = ["grads_to_flax", "load_npz", "params_from_flax", "params_to_flax", "save_npz"]
