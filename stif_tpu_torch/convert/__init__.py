"""Checkpoint interop of the port (counterpart of ``stif_tpu.convert``)."""

from stif_tpu_torch.convert.state_dict import jax_params_to_state_dict, load_pth

__all__ = ["jax_params_to_state_dict", "load_pth"]
