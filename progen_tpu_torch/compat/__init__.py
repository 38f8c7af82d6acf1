from progen_tpu_torch.compat.convert import (
    bank_from_numpy,
    grads_to_flax,
    load_npz,
    lora_params_from_flax,
    params_from_flax,
    params_to_flax,
    save_npz,
)

__all__ = ["bank_from_numpy", "grads_to_flax", "load_npz", "lora_params_from_flax",
           "params_from_flax", "params_to_flax", "save_npz"]
