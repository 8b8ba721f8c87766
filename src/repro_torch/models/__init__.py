from repro_torch.models.model import (DecodeState, Model, decode_step,
                                      init_params, prefill)

__all__ = ["DecodeState", "Model", "decode_step", "init_params", "prefill"]
